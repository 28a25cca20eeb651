"""Pluggable out-of-core event storage: the port's copy of the reference's
numpy-only ``repro.storage`` (``docs/storage.md``), with the same on-disk
format, so a store written by either package opens in the other.

``EventStore`` is the backend contract (sorted columnar event arrays +
range queries + resumable windowed iteration); ``InMemoryStore`` is the
bit-identical host-numpy default, ``MmapStore`` the memory-mapped columnar
backend for streams larger than host RAM. ``streaming_csr`` builds the
uniform samplers' adjacency in O(chunk) resident memory, and
``StoreEventLoader`` feeds store windows through the hook pipeline into
``PrefetchLoader``.
"""

from repro_torch.storage.base import EventStore, EventWindow, WindowIterator
from repro_torch.storage.csr import streaming_csr
from repro_torch.storage.memory import InMemoryStore
from repro_torch.storage.mmap import MmapStore
from repro_torch.storage.windows import StoreEventLoader

__all__ = [
    "EventStore",
    "EventWindow",
    "WindowIterator",
    "InMemoryStore",
    "MmapStore",
    "StoreEventLoader",
    "streaming_csr",
]
