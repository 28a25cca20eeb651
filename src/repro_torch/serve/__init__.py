"""LM serving of the port: prefill, single-token decode and a batched
generation loop. (The reference's ``graph_service`` and ``faults`` are
not ported yet.)"""

from repro_torch.serve.decode import generate, make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step", "generate"]
