"""Temporal-graph models of the port: TGAT, TGN, GraphMixer, DyGFormer,
TPNet, the snapshot (DTDG) models and the persistent forecast, with the
shared pieces in ``common``."""

from repro_torch.models.tg import (
    common,
    dygformer,
    graphmixer,
    persistent,
    snapshot,
    tgat,
    tgn,
    tpnet,
)

__all__ = ["common", "dygformer", "graphmixer", "persistent", "snapshot",
           "tgat", "tgn", "tpnet"]
