"""Temporal-graph models of the port: TGAT, TGN, GraphMixer, DyGFormer,
TPNet, the snapshot (DTDG) models, the persistent forecast and the
EdgeBank baseline, with the shared pieces in ``common``."""

from repro_torch.models.tg import (
    common,
    dygformer,
    edgebank,
    graphmixer,
    persistent,
    snapshot,
    tgat,
    tgn,
    tpnet,
)

__all__ = ["common", "dygformer", "edgebank", "graphmixer", "persistent",
           "snapshot", "tgat", "tgn", "tpnet"]
