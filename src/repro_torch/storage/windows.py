"""Store-driven batch loading: ``EventStore.iter_windows`` into the hook
pipeline and ``PrefetchLoader``.

``StoreEventLoader`` is the storage-native sibling of
``core.loader.DGDataLoader``: it iterates a store's windows (by event
count or by time), materializes each as a hook-compatible ``Batch``
(``src``/``dst``/``time``[/``edge_feats``] + global ``eids`` meta), runs
the ``HookManager`` pipeline, and yields — so it drops into every place a
``DGDataLoader`` fits, including as the inner loader of a
``PrefetchLoader`` (the background thread prepares window ``i+1`` while
the step consumes window ``i``, exactly as with the in-RAM
loader). ``release=True`` returns the backend's mapped pages after each
batch, bounding a whole epoch's resident set by the window size. The
iterator's resume cursor (``state_dict``) checkpoints mid-epoch positions
— see ``docs/storage.md``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Union

from repro_torch.core.batch import Batch
from repro_torch.storage.base import EventStore


class StoreEventLoader:
    """Iterate an ``EventStore`` as hook-processed ``Batch``es.

    Exactly one of ``batch_size`` / ``time_window`` selects the iteration
    mode (``DGDataLoader``'s CTDG/DTDG split). ``start`` resumes from a
    row or a ``WindowIterator.state_dict`` cursor; the live cursor is
    exposed via :meth:`state_dict` for mid-epoch checkpointing.
    ``telemetry`` (a ``repro_torch.obs.Telemetry``) forwards to
    ``iter_windows`` for the window read/release counters.
    """

    def __init__(self, store: EventStore, hook_manager=None,
                 batch_size: Optional[int] = None,
                 time_window: Optional[int] = None, *,
                 start: Union[None, int, dict] = None,
                 emit_empty: bool = False, release: bool = False,
                 telemetry=None):
        self.store = store
        self.manager = hook_manager
        self._kw = dict(batch_size=batch_size, time_window=time_window,
                        emit_empty=emit_empty, release=release,
                        telemetry=telemetry)
        # Validate eagerly (and fix the resume point even if iteration
        # starts later).
        self._windows = store.iter_windows(start=start, **self._kw)

    def state_dict(self) -> dict:
        """The underlying window iterator's resume cursor."""
        return self._windows.state_dict()

    def __len__(self) -> int:
        return len(self._windows)

    def __iter__(self) -> Iterator[Batch]:
        for w in self._windows:
            batch = w.to_batch()
            batch.meta["granularity"] = self.store.granularity
            if self.manager is not None:
                batch = self.manager.execute(batch)
            yield batch
