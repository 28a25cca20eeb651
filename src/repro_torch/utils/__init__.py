"""Deprecated helpers kept for their public callers: the ``Profiler`` shim
over ``repro_torch.obs.Telemetry``."""

from repro_torch.utils.prof import Profiler, profile_section

__all__ = ["Profiler", "profile_section"]
