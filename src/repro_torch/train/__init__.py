"""The link pipelines of the port: training, evaluation, checkpoints and
the epoch engine (``loop``), the legacy trainer names (``tg_trainer``) and
the MRR metric (``metrics``)."""
