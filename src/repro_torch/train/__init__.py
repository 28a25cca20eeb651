"""The pipelines of the port: link prediction, training, evaluation,
checkpoints and the epoch engine (``loop``), the node task's pipelines
(``nodeprop``), the legacy trainer names (``tg_trainer``) and the metrics
(``metrics``: MRR, AUC, NDCG@k)."""

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
