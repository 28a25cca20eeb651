"""The pipelines of the port: link prediction, training, evaluation,
checkpoints and the epoch engine (``loop``), the node task's pipelines
(``nodeprop``), the legacy trainer names (``tg_trainer``), the metrics
(``metrics``: MRR, AUC, NDCG@k) and the LM train step (``lm_train``)."""

from repro_torch.train.lm_train import (
    abstract_opt_state,
    init_opt_state,
    make_train_step,
)
from repro_torch.train.loop import (
    CTDGLinkPipeline,
    DTDGLinkPipeline,
    TrainLoop,
)
from repro_torch.train.metrics import auc, mrr, ndcg_at_k
from repro_torch.train.nodeprop import (
    DTDGNodePipeline,
    EventNodePipeline,
    NodePropertyTrainer,
)
from repro_torch.train.tg_trainer import LinkPredictionTrainer, SnapshotLinkTrainer

__all__ = [
    "abstract_opt_state",
    "init_opt_state",
    "make_train_step",
    "auc",
    "mrr",
    "ndcg_at_k",
    "CTDGLinkPipeline",
    "DTDGLinkPipeline",
    "DTDGNodePipeline",
    "EventNodePipeline",
    "NodePropertyTrainer",
    "TrainLoop",
    "LinkPredictionTrainer",
    "SnapshotLinkTrainer",
]
