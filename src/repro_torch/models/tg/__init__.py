"""Temporal-graph models of the port: TGAT, TGN, GraphMixer, DyGFormer,
TPNet and the snapshot (DTDG) models, with the shared pieces in
``common``."""

from repro_torch.models.tg import (
    common,
    dygformer,
    graphmixer,
    snapshot,
    tgat,
    tgn,
    tpnet,
)

__all__ = ["common", "dygformer", "graphmixer", "snapshot", "tgat", "tgn",
           "tpnet"]
