"""Serving in the port: LM prefill, single-token decode and a batched
generation loop (``decode``), and the fault-tolerant online temporal-graph
service with its EdgeBank fallback tier and seeded fault injection
(``graph_service``, ``faults``)."""

from repro_torch.serve.decode import generate, make_decode_step, make_prefill_step
from repro_torch.serve.faults import FaultInjector, ModelFault, TransferFault
from repro_torch.serve.graph_service import (
    OnlineGraphService,
    PendingResponse,
    Response,
    Status,
)

__all__ = [
    "make_prefill_step", "make_decode_step", "generate",
    "FaultInjector", "ModelFault", "TransferFault",
    "OnlineGraphService", "PendingResponse", "Response", "Status",
]
