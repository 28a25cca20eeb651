"""Out-of-core event storage in the port (``repro_torch.storage``).

Held, with integer state bit-exact and floats bit-exact unless stated:

* the reference's ``tests/test_storage.py`` cases on the port's classes:
  ``InMemoryStore`` / ``MmapStore`` parity (columns, range queries,
  windowed iteration, ``release``), bounds, the resume cursor through the
  port's checkpoint layer, the converters' guards, the CSV adapter,
  ``DGData.from_store`` (memmap columns kept, not copied), the streaming
  CSR against the in-RAM build, ``StoreEventLoader`` inside the port's
  ``PrefetchLoader``, ``DGDataLoader(on_batch=)``;
* across packages: a store written by either package opens in the other
  (columns and manifest equal); ``WindowIterator`` windows and resume
  cursors, ``streaming_csr`` (with and without ``scratch_dir``), both
  store-built uniform samplers, ``iter_csv_chunks`` and ``from_csv`` equal
  to the reference's;
* one CTDG link epoch plus ``evaluate("val")`` on ``tiny`` bit-identical off
  the raw stream, an ``InMemoryStore`` and an ``MmapStore``, for GraphMixer
  (both samplers, as the reference's test) and 1-layer TGAT on the host
  recency sampler (the classic path's plain version), with the store's
  pages released once per batch; ``DataSpec.storage`` through JSON;
  ``discretize`` (host and device backends) off memmap columns.

The CPU adds an embedding gather's gradient in a thread-dependent order, so
the epoch tests run on one thread.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.core import DGData as JaxDGData
from repro.core.graph import iter_csv_chunks as jax_iter_csv_chunks
from repro.core.device_uniform import DeviceUniformSampler as JaxDeviceUniform
from repro.core.sampler import UniformSampler as JaxUniform
from repro.storage import MmapStore as JaxMmapStore
from repro.storage import streaming_csr as jax_streaming_csr
from repro_torch.core import DGData, DGraph
from repro_torch.core.device_uniform import DeviceUniformSampler
from repro_torch.core.graph import iter_csv_chunks
from repro_torch.core.sampler import UniformSampler
from repro_torch.storage import (
    EventStore,
    InMemoryStore,
    MmapStore,
    StoreEventLoader,
    streaming_csr,
)

CSR = ("adj_nbr", "adj_t", "adj_e", "indptr")


def _fields(blk):
    return blk.nbr_ids, blk.nbr_times, blk.nbr_eids, blk.mask


def _mk_data(n=500, num_nodes=60, d_edge=4, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, n)
    dst = rng.integers(0, num_nodes, n)
    t = np.sort(rng.integers(0, 10_000, n))
    feats = rng.standard_normal((n, d_edge)).astype(np.float32)
    return DGData.from_arrays(src, dst, t, edge_feats=feats, granularity="s")


@pytest.fixture()
def both_stores(tmp_path):
    data = _mk_data()
    mem = InMemoryStore.from_data(data)
    mm = MmapStore.from_data(str(tmp_path / "store"), data, chunk_rows=97)
    return data, mem, mm


@pytest.fixture()
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- backend parity (the reference's cases) ----------------------------


def test_backend_columns_bit_identical(both_stores):
    data, mem, mm = both_stores
    for col in ("src", "dst", "edge_t"):
        np.testing.assert_array_equal(getattr(mem, col), getattr(mm, col))
        assert getattr(mm, col).dtype == getattr(mem, col).dtype
    np.testing.assert_array_equal(mem.edge_feats, mm.edge_feats)
    assert mem.num_nodes == mm.num_nodes == data.num_nodes
    assert mem.edge_feat_dim == mm.edge_feat_dim == 4
    assert mem.time_span == mm.time_span


def test_backend_range_queries_identical(both_stores):
    data, mem, mm = both_stores
    t_lo, t_hi = mem.time_span
    probes = [(None, None), (t_lo, t_hi), (t_lo + 7, t_hi - 7),
              (t_hi + 1, t_hi + 2), (None, (t_lo + t_hi) // 2)]
    for a, b in probes:
        assert mem.edge_range(a, b) == mm.edge_range(a, b) == data.edge_range(a, b)
        assert mem.node_event_range(a, b) == mm.node_event_range(a, b)


def test_windowed_iteration_identical(both_stores):
    _, mem, mm = both_stores
    for kw in ({"batch_size": 123}, {"time_window": 1777}):
        w1, w2 = list(mem.iter_windows(**kw)), list(mm.iter_windows(**kw))
        assert len(w1) == len(w2) > 1
        for a, b in zip(w1, w2):
            assert (a.lo, a.hi, a.window) == (b.lo, b.hi, b.window)
            np.testing.assert_array_equal(a.src, b.src)
            np.testing.assert_array_equal(a.t, b.t)
            np.testing.assert_array_equal(a.eids, b.eids)


def test_mmap_release_keeps_columns_readable(both_stores):
    _, mem, mm = both_stores
    before = mm.src[:10].copy()
    mm.release()  # MADV_DONTNEED; pages fault back in on the next touch
    np.testing.assert_array_equal(mm.src[:10], before)
    np.testing.assert_array_equal(np.asarray(mm.dst), np.asarray(mem.dst))


def test_edge_window_bounds_raise(both_stores):
    _, mem, mm = both_stores
    for store in (mem, mm):
        for lo, hi in ((10, 5), (-1, 5), (0, store.num_edge_events + 1)):
            with pytest.raises(ValueError):
                store.edge_window(lo, hi)
        empty = store.edge_window(7, 7)
        assert len(empty) == 0 and empty.eids.dtype == np.int64


def test_iter_windows_argument_validation(both_stores):
    _, mem, _ = both_stores
    for kw in ({}, {"batch_size": 10, "time_window": 10}, {"batch_size": 0}):
        with pytest.raises(ValueError):
            mem.iter_windows(**kw)


def test_resume_cursor_roundtrips_through_checkpoint(both_stores, tmp_path):
    from repro_torch.distributed import checkpoint as ckpt

    _, _, mm = both_stores
    full = list(mm.iter_windows(batch_size=77))
    it = mm.iter_windows(batch_size=77)
    for i, _ in enumerate(it):
        if i == 2:
            break
    ckpt.save(str(tmp_path / "ck"), 0, it.state_dict())
    state, _, _ = ckpt.restore(str(tmp_path / "ck"))
    resumed = list(mm.iter_windows(
        batch_size=77, start={k: int(v) for k, v in state.items()}))
    assert [(w.lo, w.hi) for w in resumed] == [(w.lo, w.hi) for w in full[3:]]
    for a, b in zip(resumed, full[3:]):
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.eids, b.eids)


def test_time_window_resume(both_stores):
    _, mem, _ = both_stores
    full = list(mem.iter_windows(time_window=911))
    wi = mem.iter_windows(time_window=911)
    gen = iter(wi)
    next(gen)
    next(gen)
    resumed = list(mem.iter_windows(time_window=911, start=wi.state_dict()))
    assert [(w.lo, w.hi) for w in resumed] == [(w.lo, w.hi) for w in full[2:]]


def test_from_chunks_rejects_unsorted(tmp_path):
    within = [{"src": np.array([1, 2]), "dst": np.array([3, 4]),
               "t": np.array([10, 5])}]
    across = [{"src": np.array([1]), "dst": np.array([2]), "t": np.array([10])},
              {"src": np.array([3]), "dst": np.array([4]), "t": np.array([5])}]
    for name, chunks in (("bad", within), ("bad2", across)):
        with pytest.raises(ValueError, match="time-sorted"):
            MmapStore.from_chunks(str(tmp_path / name), iter(chunks))
        assert not os.path.exists(str(tmp_path / name))  # no torn publish


def test_torn_store_detected(tmp_path, both_stores):
    data, _, _ = both_stores
    path = str(tmp_path / "torn")
    MmapStore.from_data(path, data)
    assert MmapStore.is_intact(path)
    with open(os.path.join(path, "src.npy"), "r+b") as f:
        f.truncate(os.path.getsize(os.path.join(path, "src.npy")) - 8)
    assert not MmapStore.is_intact(path)
    with pytest.raises(ValueError):
        MmapStore(path)


def _write_csv(path, n=257, seed=3):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 40, n), rng.integers(0, 40, n)
    t = np.sort(rng.integers(0, 5000, n))
    lines = ["src,dst,t,f0,f1"] + [
        f"{src[i]},{dst[i]},{t[i]},{i * 0.5},{-i * 0.25}" for i in range(n)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_from_csv_matches_dgdata_from_csv(tmp_path):
    p = _write_csv(tmp_path / "edges.csv")
    d = DGData.from_csv(p, feat_cols=[3, 4], chunk_rows=61)
    store = MmapStore.from_csv(str(tmp_path / "csvstore"), p,
                               feat_cols=[3, 4], chunk_rows=61)
    for a, b in ((d.src, store.src), (d.dst, store.dst),
                 (d.edge_t, store.edge_t), (d.edge_feats, store.edge_feats)):
        np.testing.assert_array_equal(a, b)
    assert store.src.dtype == np.int64


def test_csv_int64_exactness(tmp_path):
    big = 2**60 + 1
    p = tmp_path / "big.csv"
    p.write_text(f"src,dst,t\n{big},1,{big}\n{big + 2},1,{big + 2}\n")
    d = DGData.from_csv(str(p))
    assert int(d.src[0]) == big and int(d.edge_t[1]) == big + 2


def test_dgdata_from_store_zero_copy(both_stores):
    """``from_store`` aliases the columns: a memmap column stays a memmap
    (the port's ``from_arrays`` copies through ``np.ascontiguousarray``)."""
    data, mem, mm = both_stores
    d1, d2 = DGData.from_store(mem), mm.to_data()
    assert d1.src is mem.src
    assert isinstance(d2.src, np.memmap) and isinstance(d2.edge_feats, np.memmap)
    assert d2.src is mm.src
    np.testing.assert_array_equal(d1.edge_feats, d2.edge_feats)
    assert d1.num_nodes == d2.num_nodes == data.num_nodes
    assert d1.granularity == d2.granularity == data.granularity
    tr, va, te = d2.split(0.15, 0.15)
    assert (tr.num_edge_events + va.num_edge_events + te.num_edge_events
            == data.num_edge_events)
    assert te.eid_offset == tr.num_edge_events + va.num_edge_events


def test_to_store_roundtrip(both_stores):
    data, _, _ = both_stores
    store = data.to_store()
    assert isinstance(store, EventStore) and store.src is data.src


def test_streaming_csr_matches_host_build(both_stores):
    data, mem, mm = both_stores
    ref = UniformSampler(data.num_nodes, k=4, seed=0)
    ref.build(data.src, data.dst, data.edge_t,
              np.arange(data.num_edge_events, dtype=np.int64))
    for store in (mem, mm):
        s = UniformSampler(data.num_nodes, k=4, seed=0)
        s.build_from_store(store, chunk_size=89)
        a, b = ref.state_dict(), s.state_dict()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_device_uniform_build_from_store(both_stores):
    data, _, mm = both_stores
    ref = DeviceUniformSampler(data.num_nodes, k=4, seed=0, device="cpu")
    ref.build(data.src, data.dst, data.edge_t)
    s = DeviceUniformSampler(data.num_nodes, k=4, seed=0, device="cpu")
    s.build_from_store(mm, chunk_size=73)
    for key in ("adj_nbr", "adj_t", "adj_e", "adj_key", "indptr", "tvals"):
        assert torch.equal(ref._adj[key], s._adj[key]), key
        assert ref._adj[key].dtype == s._adj[key].dtype, key
    assert ref._adj["base"] == s._adj["base"]
    q, qt = np.array([1, 5, 9]), np.array([8000, 9000, 9999])
    for a, b in zip(_fields(ref.sample(q, qt)), _fields(s.sample(q, qt))):
        assert torch.equal(a, b)


def test_store_event_loader_feeds_prefetch(both_stores):
    from repro_torch.core.loader import PrefetchLoader

    _, mem, mm = both_stores
    plain = [(b["src"], b.meta["eids"]) for b in
             StoreEventLoader(mem, batch_size=150)]
    pref = PrefetchLoader(StoreEventLoader(mm, batch_size=150, release=True),
                          device="cpu")
    fetched = [(b["src"], b.meta["eids"]) for b in pref]
    assert len(plain) == len(fetched) == 4
    for (s1, e1), (s2, e2) in zip(plain, fetched):
        np.testing.assert_array_equal(np.asarray(s1), s2.numpy())
        np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))


def test_dgdataloader_on_batch_called(both_stores):
    from repro_torch.core.loader import DGDataLoader

    data, _, _ = both_stores
    calls = []
    for kw in ({"batch_size": 100}, {"batch_size": None, "batch_unit": "h"}):
        calls.clear()
        n = sum(1 for _ in DGDataLoader(DGraph(data), on_batch=lambda: calls.append(1),
                                        **kw))
        assert len(calls) == n > 0


# -- across packages ----------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_opens_in_the_other_package(both_stores, tmp_path, writer):
    """The on-disk format is byte for byte the reference's: a store written
    by either package opens in the other with equal columns and manifest."""
    data, _, _ = both_stores
    jdata = JaxDGData.from_arrays(data.src, data.dst, data.edge_t,
                                  edge_feats=data.edge_feats, granularity="s")
    path = str(tmp_path / "s")
    if writer == "port":
        MmapStore.from_data(path, data, chunk_rows=97)
    else:
        JaxMmapStore.from_data(path, jdata, chunk_rows=97)
    a, b = MmapStore(path), JaxMmapStore(path)
    assert a.manifest == b.manifest
    for col in ("src", "dst", "edge_t", "edge_feats"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
        assert getattr(a, col).dtype == getattr(b, col).dtype
    # and the files equal those the other package writes
    other = str(tmp_path / "o")
    if writer == "port":
        JaxMmapStore.from_data(other, jdata, chunk_rows=97)
    else:
        MmapStore.from_data(other, data, chunk_rows=97)
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f, \
                open(os.path.join(other, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("kw", [{"batch_size": 77}, {"time_window": 911}],
                         ids=["events", "time"])
def test_windows_and_cursors_equal_the_reference(both_stores, kw):
    _, _, mm = both_stores
    jmm = JaxMmapStore(mm.path)
    it, jit = mm.iter_windows(**kw), jmm.iter_windows(**kw)
    assert len(it) == len(jit)
    for a, b in zip(it, jit):
        assert (a.lo, a.hi, a.window) == (b.lo, b.hi, b.window)
        for f in ("src", "dst", "t", "eids", "edge_feats"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert it.state_dict() == jit.state_dict()
    start = {"row": 154, "tick": 0} if "batch_size" in kw else {"row": 0, "tick": 3}
    assert ([(w.lo, w.hi) for w in mm.iter_windows(start=start, **kw)]
            == [(w.lo, w.hi) for w in jmm.iter_windows(start=start, **kw)])


@pytest.mark.parametrize("scratch", [False, True], ids=["ram", "scratch_dir"])
def test_streaming_csr_equals_the_reference(both_stores, tmp_path, scratch):
    _, _, mm = both_stores
    kw = {"scratch_dir": str(tmp_path / "p")} if scratch else {}
    jkw = {"scratch_dir": str(tmp_path / "r")} if scratch else {}
    got = streaming_csr(mm, chunk_size=101, **kw)
    want = jax_streaming_csr(JaxMmapStore(mm.path), chunk_size=101, **jkw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_store_built_samplers_equal_the_reference(both_stores):
    """Host: CSR and draws bit-equal. Device: the CSR bit-equal (draws come
    from a ``torch.Generator``, never ``jax.random``'s), the prefix lengths
    equal the host's; the port keys in int64 where the reference's key is
    int32 (it accepts this graph)."""
    data, _, mm = both_stores
    jmm = JaxMmapStore(mm.path)
    host, jhost = UniformSampler(data.num_nodes, 4, seed=3), JaxUniform(data.num_nodes, 4, seed=3)
    host.build_from_store(mm, chunk_size=61)
    jhost.build_from_store(jmm, chunk_size=61)
    for k in CSR:
        np.testing.assert_array_equal(host.state_dict()[k], jhost.state_dict()[k])
    rng = np.random.default_rng(0)
    seeds, qt = rng.integers(0, data.num_nodes, 40), rng.integers(0, 10_000, 40)
    for _ in range(2):
        a, b = host.sample(seeds, qt), jhost.sample(seeds, qt)
        for x, y in zip(_fields(a), _fields(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    dev = DeviceUniformSampler(data.num_nodes, 4, device="cpu")
    jdev = JaxDeviceUniform(data.num_nodes, 4)
    dev.build_from_store(mm, chunk_size=61)
    jdev.build_from_store(jmm, chunk_size=61)
    assert dev._adj["adj_key"].dtype == torch.int64
    for k in CSR:
        np.testing.assert_array_equal(dev.state_dict()[k], jdev.state_dict()[k])
    np.testing.assert_array_equal(dev._adj["adj_key"].numpy(),
                                  np.asarray(jdev._adj["adj_key"]))
    starts, n_valid = dev.prefix(seeds, qt)
    hs, hn = host.prefix(seeds, qt)
    np.testing.assert_array_equal(starts.numpy(), hs)
    np.testing.assert_array_equal(n_valid.numpy(), hn)


def test_csv_adapters_equal_the_reference(tmp_path):
    p = _write_csv(tmp_path / "edges.csv", n=301, seed=5)
    kw = dict(feat_cols=[3, 4], chunk_rows=64)
    got, want = list(iter_csv_chunks(p, **kw)), list(jax_iter_csv_chunks(p, **kw))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    d, jd = DGData.from_csv(p, **kw), JaxDGData.from_csv(p, **kw)
    for f in ("src", "dst", "edge_t", "edge_feats"):
        np.testing.assert_array_equal(getattr(d, f), np.asarray(getattr(jd, f)))
    assert d.num_nodes == jd.num_nodes


# -- pipelines off a store ---------------------------------------------


def _tiny_stream():
    from repro_torch.data import generate

    return generate("tiny").slice_events(0, 600)


@pytest.mark.parametrize("model,kind", [("graphmixer", "uniform"),
                                        ("graphmixer", "recency"),
                                        ("tgat", "recency")])
def test_e2e_ctdg_link_backend_parity(model, kind, tmp_path, one_thread):
    """One CTDG link epoch + ``evaluate("val")``: loss and MRR bit-identical
    off the raw stream, an ``InMemoryStore`` and an ``MmapStore``; the
    store's pages are released once per batch."""
    from repro_torch.obs import MemorySink, Telemetry
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec

    stream = _tiny_stream()
    path = str(tmp_path / "store")
    MmapStore.from_data(path, stream)
    kwargs = {"d_model": 16, "d_time": 8}
    if model == "tgat":
        kwargs["num_layers"] = 1
    exp = Experiment(data=DataSpec("tiny"), model=ModelSpec(model, kwargs),
                     sampler=SamplerSpec(kind=kind, k=4),
                     train=TrainSpec(batch_size=150, eval_negatives=5, seed=0))

    def run(data):
        tel = Telemetry(MemorySink())
        pipe = exp.compile(data, device="cpu", telemetry=tel)
        loss, _ = pipe.train_epoch()
        mrr, _ = pipe.evaluate("val")
        # the epoch's batches, then evaluate's warm-up over train and val's
        n_train = -(-pipe.train_data.num_edge_events // 150)
        n = 2 * n_train + -(-pipe.val_data.num_edge_events // 150)
        return loss, mrr, tel.counter_value("storage/windows_released"), n

    raw = run(stream)
    mem = run(stream.to_store())
    mm = run(MmapStore(path))
    assert raw[:2] == mem[:2] == mm[:2]
    assert raw[2] == 0 and mem[2] == mm[2] == mm[3]


def test_experiment_dataspec_storage_roundtrip(tmp_path):
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec

    stream = _tiny_stream()
    path = str(tmp_path / "store")
    MmapStore.from_data(path, stream)
    exp = Experiment(data=DataSpec(storage=path),
                     model=ModelSpec("tgat", {"num_layers": 1, "d_model": 16, "d_time": 8}),
                     sampler=SamplerSpec(kind="uniform", k=4, device=True),
                     train=TrainSpec(batch_size=200, eval_negatives=5))
    again = Experiment.from_json(exp.to_json())
    assert again.data.storage == path and json.loads(again.to_json()) == json.loads(exp.to_json())
    stream_mm = again._dataset()
    assert isinstance(stream_mm.src, np.memmap)
    assert stream_mm.num_edge_events == stream.num_edge_events
    pipe = again.compile(device="cpu")  # opens the store at DataSpec.storage
    assert isinstance(pipe.data.src, np.memmap) and pipe._store is not None
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    want = DeviceUniformSampler(stream.num_nodes, 4, device="cpu")
    want.build(stream.src, stream.dst, stream.edge_t)
    for k in CSR:  # the streaming CSR (tiny's (node, time) pairs are distinct)
        np.testing.assert_array_equal(hook.sampler.state_dict()[k], want.state_dict()[k])
    # The memmap edge-feature column is staged once per pipeline, as a copy.
    from repro_torch.core import tg_hooks

    tg_hooks._EDGE_TABLE_CACHE.clear()
    mrr, _ = pipe.evaluate("val")
    assert 0.0 < mrr <= 1.0
    (feats, table), = tg_hooks._EDGE_TABLE_CACHE.values()
    assert feats is pipe.data.edge_feats and isinstance(feats, np.memmap)
    assert not np.shares_memory(table.numpy(), feats)


def test_dtdg_discretize_off_memmap(tmp_path):
    """Both backends of ``discretize`` run off memmap-backed columns and
    match the in-RAM stream exactly."""
    from repro_torch.core import TimeDelta
    from repro_torch.core.discretize import discretize

    stream = _tiny_stream()
    store = MmapStore.from_data(str(tmp_path / "store"), stream)
    for backend in ("numpy", "device"):
        kw = {"device": "cpu"} if backend == "device" else {}
        a = discretize(stream, TimeDelta("h"), backend=backend, **kw)
        b = discretize(store.to_data(), TimeDelta("h"), backend=backend, **kw)
        for f in ("src", "dst", "edge_t", "edge_feats"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
