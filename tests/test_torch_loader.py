"""The port's ``PrefetchLoader`` on the CPU: same batches, clean ``close()``,
errors in order.

On the CPU the loader stages nothing through pinned buffers, but its thread
runs the hooks ahead of the consumer exactly as on the card, so these tests
cover the producer/consumer code the GPU path runs. The staging pool's slot
rotation runs here with unpinned buffers; the pinned copies and the CUDA
stream handling run on the card (``chip_smoke.py``, train phase).
"""

from __future__ import annotations

import threading
import traceback

import numpy as np
import pytest
import torch

from repro_torch.core import (
    DGDataLoader,
    DGraph,
    PrefetchLoader,
    RECIPE_TGB_LINK,
    RecipeRegistry,
    TRAIN_KEY,
)
from repro_torch.core.batch import Batch
from repro_torch.core.loader import _HostStagingPool
from repro_torch.data import generate
from repro_torch.obs import MemorySink, Telemetry
from repro_torch.tg import SamplerSpec

WAIT_S = 30  # bound on every wait below; the work itself takes milliseconds


def _manager(data):
    return RecipeRegistry.build(
        RECIPE_TGB_LINK, num_nodes=data.num_nodes,
        spec=SamplerSpec(kind="recency", k=4, device=True), batch_size=50,
        eval_negatives=5, edge_feats=data.edge_feats,
        edge_feat_dim=data.edge_feat_dim, seed=3, device="cpu")


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _counted(n, full=None, at=None):
    """An inner loader of ``n`` tiny batches; sets ``full`` when the
    producer asks for batch ``at``."""
    def gen():
        for i in range(n):
            if full is not None and i == at:
                full.set()
            yield Batch({"src": np.arange(3) + i})

    class Inner:
        def __iter__(self):
            return gen()

    return Inner()


def test_prefetch_batches_are_bit_equal_to_the_plain_loader():
    """Hooks (device sampler included) run one batch ahead in the producer
    thread; every staged batch equals the plain loader's, and each batch's
    packed buffer is still the snapshot it was sampled from after the later
    batches' sampler updates ran."""
    data = generate("tiny")
    m = _manager(data)
    with m.activate(TRAIN_KEY):
        plain, bufs = [], []
        for b in DGDataLoader(DGraph(data), m, batch_size=50):
            plain.append(b)
            bufs.append(b["nbr_buf"].clone())  # before the next update runs
        m.reset_state()
        staged = list(PrefetchLoader(DGDataLoader(DGraph(data), m, batch_size=50),
                                     device="cpu", prefetch=2))
    assert len(staged) == len(plain) > 3
    for a, b, buf in zip(staged, plain, bufs):
        assert set(a.keys()) == set(b.keys())
        for key in a.keys():
            assert isinstance(a[key], torch.Tensor), key
            want = _host(b[key])
            if want.dtype == np.int64:
                want = want.astype(np.int32)  # staged as int32, as in the reference
            got = _host(a[key])
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        assert torch.equal(a["nbr_buf"], buf)


def test_close_with_a_full_queue_yields_nothing_more():
    """Hold the consumer until the producer has filled the queue and blocks
    on the next put, then close: the consumer sees a clean end every time,
    though batches are queued."""
    prefetch = 2
    for _ in range(5):
        full = threading.Event()
        pre = PrefetchLoader(_counted(100, full, at=prefetch + 1),
                             device="cpu", prefetch=prefetch)
        it = iter(pre)
        assert int(next(it)["src"][0]) == 0
        assert full.wait(WAIT_S)  # batches 1..prefetch are queued
        pre.close()
        assert list(it) == []


def test_close_is_idempotent():
    pre = PrefetchLoader(_counted(1000), device="cpu", prefetch=2)
    it = iter(pre)
    next(it)
    pre.close()
    pre.close()  # a second call is a no-op
    assert list(it) == []
    pre.close()  # and safe again after the iteration ended
    assert not any(t.is_alive() for _, t in pre._active)


def test_producer_exception_arrives_after_earlier_batches_with_traceback():
    def _hook_that_raises():
        raise ValueError("hook exploded")

    def gen():
        yield Batch({"src": np.arange(3)})
        yield Batch({"src": np.arange(3) + 1})
        _hook_that_raises()

    class Inner:
        def __iter__(self):
            return gen()

    it = iter(PrefetchLoader(Inner(), device="cpu"))
    assert [int(next(it)["src"][0]) for _ in range(2)] == [0, 1]
    with pytest.raises(ValueError, match="hook exploded") as ei:
        next(it)  # within one next()
    frames = traceback.extract_tb(ei.value.__traceback__)
    assert any(f.name == "_hook_that_raises" for f in frames)


def test_dead_producer_raises_instead_of_hanging(monkeypatch):
    it = iter(PrefetchLoader(_counted(0), device="cpu"))
    # The producer never runs, so neither the end of the stream nor an
    # error ever reaches the queue.
    monkeypatch.setattr(threading.Thread, "start", lambda self: None)
    with pytest.raises(RuntimeError, match="producer thread died"):
        next(it)


def test_loader_telemetry_and_len():
    tel = Telemetry(MemorySink())
    pre = PrefetchLoader(DGDataLoader(DGraph(generate("tiny")), None,
                                      batch_size=64), device="cpu",
                         prefetch=1, telemetry=tel)
    n = len(pre)
    assert n == len(list(pre))
    assert tel.counter_value("loader/batches") == n
    with pytest.raises(ValueError):
        PrefetchLoader(_counted(1), device="cpu", prefetch=0)


def test_staging_pool_rotates_slots_and_narrows_int64():
    """Slots rotate round-robin; a slot is rewritten only ``depth``
    generations later (the buffers are pinned only where CUDA is)."""
    pool = _HostStagingPool(2)
    assert not pool.pin
    a = pool.stage("x", np.arange(4, dtype=np.int64))
    pool.advance()
    b = pool.stage("x", np.arange(4, 8, dtype=np.int64))
    assert a.dtype == b.dtype == torch.int32
    assert a is not b
    np.testing.assert_array_equal(a.numpy(), [0, 1, 2, 3])  # b left a alone
    pool.advance()
    c = pool.stage("x", np.full(4, 9, dtype=np.int64))
    assert c is a  # back to the first slot
    mask = pool.stage("m", np.array([True, False]))
    assert mask.dtype == torch.bool
    with pytest.raises(ValueError):
        _HostStagingPool(1)
