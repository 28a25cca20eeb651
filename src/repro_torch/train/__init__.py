"""The CTDG link pipeline of the port: training, evaluation, checkpoints
and the epoch engine (``loop``), and the MRR metric (``metrics``)."""
