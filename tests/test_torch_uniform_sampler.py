"""The uniform temporal samplers in the port: the host ``UniformSampler``
against the reference's, bit for bit, and the device twin on the CPU.

Held:

* the host sampler (numpy draws from ``default_rng((seed, counter))``):
  the CSR, successive draws, the batches of the TGB link recipe at 1 and 2
  hops (train and eval keys, the hop-2 frontier's padded slots -1 / 0 / -1 /
  False) and ``state_dict`` with and without the adjacency, all bit-equal
  to the reference's and loading both ways; ``reset_state`` replays;
* the device twin (``DeviceUniformSampler``, run here on the CPU): its CSR
  bit-equal to the host sampler's and to the reference device twin's
  ``_build``; each query's valid-prefix start and length and each mask
  bit-equal to the host sampler's; every draw inside ``[start, start +
  n_valid)``, so strictly before the query time; an epoch replayed after
  ``reset_state`` and after loading a ``state_dict``; host <-> device
  ``state_dict`` interchange; uniform draws (a chi-square test at a fixed
  seed); its int64 key on a graph where the reference device twin's int32
  key refuses (ROADMAP C);
* the store-built forms build the same CSR as ``build``; the reference's
  own refusals of data shards stay (a host sampler, and TPNet);
* ``tiny`` pipelines of 2-layer TGAT (the reference's default; the classic
  path) over each uniform sampler: on the host sampler val MRR within 1e-4
  of the reference pipeline's; on the device sampler (whose draws torch
  cannot make equal to ``jax.random``'s) val MRR within 1e-4 of the
  reference model's over the port's own batches.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.device_uniform import DeviceUniformSampler as JaxDeviceUniform
from repro.core.sampler import UniformSampler as JaxUniform
from repro.data import generate as jax_generate
from repro.tg.specs import SamplerSpec as JaxSamplerSpec
from repro.train.loop import CTDGLinkPipeline as JaxPipeline
from repro.train.metrics import mrr as jax_mrr
from repro_torch.core import EVAL_KEY, TRAIN_KEY
from repro_torch.core.device_uniform import DeviceUniformSampler
from repro_torch.core.sampler import UniformSampler
from repro_torch.core.tg_hooks import DeviceUniformNeighborHook, UniformNeighborHook
from repro_torch.data import generate
from repro_torch.tg import SamplerSpec
from repro_torch.train.loop import CTDGLinkPipeline
from repro_torch.train.metrics import mrr
from tests._torch_zoo import MRR_TOL, sync

FIELDS = ("nbr_ids", "nbr_times", "nbr_eids", "mask")
CSR = ("adj_nbr", "adj_t", "adj_e", "indptr")
TGAT = dict(d_model=16, d_time=8)
PIPE = dict(batch_size=64, eval_negatives=5, model_kwargs=TGAT)


def _stream(seed=0, n=30, e=400, t_hi=60):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            np.sort(rng.integers(0, t_hi, e)), n)  # duplicate times


def _queries(seed, n, b=80, t_hi=70):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, b), rng.integers(0, t_hi, b)


def _host_block(blk):
    return {f: (getattr(blk, f).numpy() if isinstance(getattr(blk, f), torch.Tensor)
                else np.asarray(getattr(blk, f))) for f in FIELDS}


def test_host_sampler_is_bit_exact_with_the_reference():
    src, dst, t, n = _stream()
    ref, port = JaxUniform(n, 5, seed=3), UniformSampler(n, 5, seed=3)
    ref.build(src, dst, t)
    port.build(src, dst, t)
    for key, want in ref.state_dict().items():
        np.testing.assert_array_equal(port.state_dict()[key], want, err_msg=key)
    for call in range(4):  # successive counter steps
        seeds, qt = _queries(call, n)
        a, b = _host_block(ref.sample(seeds, qt)), _host_block(port.sample(seeds, qt))
        for f in FIELDS:
            assert a[f].dtype == b[f].dtype, f
            np.testing.assert_array_equal(b[f], a[f], err_msg=f"call {call} {f}")
    port.reset_state()
    ref2 = JaxUniform(n, 5, seed=3)
    ref2.build(src, dst, t)
    seeds, qt = _queries(0, n)
    np.testing.assert_array_equal(port.sample(seeds, qt).nbr_ids,
                                  ref2.sample(seeds, qt).nbr_ids)


@pytest.mark.parametrize("with_adjacency", [True, False])
def test_state_dict_loads_both_ways(with_adjacency):
    src, dst, t, n = _stream(1)
    ref = JaxUniform(n, 4, seed=2, checkpoint_adjacency=with_adjacency)
    port = UniformSampler(n, 4, seed=2, checkpoint_adjacency=with_adjacency)
    for s in (ref, port):
        s.build(src, dst, t)
        s.sample(*_queries(5, n))
    state = port.state_dict()
    assert sorted(state) == sorted(ref.state_dict())
    assert ("adj_nbr" in state) == with_adjacency and int(state["counter"]) == 1
    # port -> reference and reference -> port: the same continuation.
    into_ref, into_port = JaxUniform(n, 4, seed=2), UniformSampler(n, 4, seed=2)
    if not with_adjacency:  # a counter-only state awaits a rebuild
        into_ref.build(src, dst, t)
        into_port.build(src, dst, t)
    into_ref.load_state_dict(state)
    into_port.load_state_dict(ref.state_dict())
    seeds, qt = _queries(6, n)
    want = _host_block(ref.sample(seeds, qt))
    for s in (into_ref, into_port, port):
        got = _host_block(s.sample(seeds, qt))
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_device_twin_csr_prefixes_and_draw_range():
    src, dst, t, n = _stream(2)
    host = UniformSampler(n, 6, seed=4)
    dev = DeviceUniformSampler(n, 6, seed=4, device="cpu")
    ref = JaxDeviceUniform(n, 6)
    for s in (host, dev, ref):
        s.build(src, dst, t)
    hs, ds = host.state_dict(), dev.state_dict()
    adj = {k: np.asarray(v) for k, v in ref._adj.items()}
    for key in CSR:
        np.testing.assert_array_equal(ds[key], hs[key], err_msg=key)
        np.testing.assert_array_equal(ds[key], adj[key], err_msg=key)
    np.testing.assert_array_equal(dev._adj["adj_key"].numpy(), adj["adj_key"])
    num_t = int(adj["base"]) - 1
    np.testing.assert_array_equal(dev._adj["tvals"].numpy(), adj["tvals"][:num_t])

    for call in range(3):
        seeds, qt = _queries(10 + call, n)
        starts, n_valid = (x.numpy() for x in dev.prefix(seeds, qt))
        h_starts, h_valid = host.prefix(seeds, qt)
        np.testing.assert_array_equal(starts, h_starts)
        np.testing.assert_array_equal(n_valid, h_valid)
        assert (n_valid == 0).any() and (n_valid > dev.k).any()
        draw = dev.draw(torch.from_numpy(n_valid), dev._counter).numpy()
        blk = _host_block(dev.sample(seeds, qt))
        np.testing.assert_array_equal(blk["mask"], _host_block(host.sample(seeds, qt))["mask"])
        has = n_valid > 0
        assert ((draw >= 0) & (draw < np.maximum(n_valid, 1)[:, None])).all()
        idx = starts[:, None] + draw
        np.testing.assert_array_equal(blk["nbr_ids"][has], hs["adj_nbr"][idx][has])
        np.testing.assert_array_equal(blk["nbr_eids"][has], hs["adj_e"][idx][has])
        assert (blk["nbr_times"][has] < qt[has, None]).all()
        assert (blk["nbr_ids"][~has] == -1).all() and (blk["nbr_times"][~has] == 0).all()
        assert blk["nbr_ids"].dtype == np.int32 and blk["mask"].dtype == bool


def test_device_twin_replays_and_interchanges_state():
    src, dst, t, n = _stream(3)
    dev = DeviceUniformSampler(n, 4, seed=5, device="cpu")
    dev.build(src, dst, t)
    queries = [_queries(20 + i, n) for i in range(3)]
    first = [_host_block(dev.sample(*q)) for q in queries]
    dev.reset_state()
    again = [_host_block(dev.sample(*q)) for q in queries]
    for a, b in zip(first, again):
        for f in FIELDS:
            np.testing.assert_array_equal(a[f], b[f])

    dev.reset_state()
    dev.sample(*queries[0])
    state = dev.state_dict()
    host = UniformSampler(n, 4, seed=5)
    host.load_state_dict(state)  # device -> host: the same CSR and counter
    for key in CSR:
        np.testing.assert_array_equal(host.state_dict()[key], state[key])
    assert int(host.state_dict()["counter"]) == 1
    back = DeviceUniformSampler(n, 4, seed=5, device="cpu")
    back.load_state_dict(host.state_dict())  # host -> device: the same draws
    for q, want in zip(queries[1:], first[1:]):
        got = _host_block(back.sample(*q))
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f])
    ref = JaxDeviceUniform(n, 4, seed=5)
    ref.load_state_dict(back.state_dict())  # and the reference's twin reads it
    np.testing.assert_array_equal(np.asarray(ref._adj["adj_nbr"]), state["adj_nbr"])


def test_device_twin_draws_are_uniform():
    # Node 0 has 7 past neighbors at query time 100; 14,000 draws.
    src, dst, t = np.zeros(7, np.int64), np.arange(1, 8), np.arange(10, 80, 10)
    dev = DeviceUniformSampler(8, 14_000, seed=11, device="cpu")
    dev.build(src, dst, t)
    ids = dev.sample(np.array([0]), np.array([100])).nbr_ids.numpy()[0]
    counts = np.bincount(ids, minlength=8)[1:]
    chi2 = float(((counts - 2000.0) ** 2 / 2000.0).sum())
    assert counts.sum() == 14_000 and chi2 < 22.46, (counts, chi2)  # df 6, p 0.001


def test_device_twin_keeps_a_key_the_reference_int32_key_refuses():
    # num_nodes * (distinct times + 1) passes 2^31.
    n, e = 1_100_000, 2_100
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    t = np.arange(e) * 7
    with pytest.raises(ValueError, match="exceeds int32"):
        JaxDeviceUniform(n, 3).build(src, dst, t)
    host, dev = UniformSampler(n, 3), DeviceUniformSampler(n, 3, device="cpu")
    host.build(src, dst, t)
    dev.build(src, dst, t)
    assert n * (len(np.unique(t)) + 1) >= 2**31
    for key in CSR:
        np.testing.assert_array_equal(dev.state_dict()[key], host.state_dict()[key])
    seeds, qt = rng.integers(0, n, 50), rng.integers(0, 7 * e, 50)
    seeds[:25] = src[:25]
    for a, b in zip(dev.prefix(seeds, qt), host.prefix(seeds, qt)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_store_builds_equal_build():
    """The store-built forms build: the CSR of ``build_from_store`` equals
    ``build``'s, on both uniform samplers."""
    from repro_torch.storage import InMemoryStore

    src, dst, _, n = _stream(seed=4)
    # Distinct times: on a shared (node, time) pair the two builds may order
    # entries differently (repro_torch/storage/csr.py).
    store = InMemoryStore(src, dst, 3 * np.arange(len(src)), num_nodes=n)
    for make in (lambda: UniformSampler(n, 2),
                 lambda: DeviceUniformSampler(n, 2, device="cpu")):
        want, got = make(), make()
        want.build(store.src, store.dst, store.edge_t)
        got.build_from_store(store, chunk_size=37)
        for key in CSR:
            np.testing.assert_array_equal(got.state_dict()[key],
                                          want.state_dict()[key])


def test_store_builds_and_shards_are_refused():
    """What stays refused beside the store builds (which build,
    ``test_store_builds_equal_build``) and the mesh-sharded samplers (which
    run, ``tests/test_torch_sharded_sampler.py``): the reference's own
    refusals of data shards, each a ``ValueError`` as there — over a host
    sampler (a store-backed experiment here), and with TPNet. They come
    before any mesh is asked for."""
    from repro_torch.storage import InMemoryStore
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, TrainSpec

    src, dst, _, n = _stream(seed=4)
    store = InMemoryStore(src, dst, 3 * np.arange(len(src)), num_nodes=n)
    exp = Experiment(data=DataSpec("tiny"), model=ModelSpec("tgat", TGAT),
                     sampler=SamplerSpec(kind="uniform", k=2),
                     train=TrainSpec(batch_size=64, data_shards=2))
    with pytest.raises(ValueError, match="requires SamplerSpec\\(device=True\\)"):
        exp.compile(data=store, device="cpu")
    tpnet = Experiment(data=DataSpec("tiny"), model=ModelSpec("tpnet"),
                       sampler=SamplerSpec(kind="uniform", k=2, device=True),
                       train=TrainSpec(batch_size=64, data_shards=2))
    with pytest.raises(ValueError, match="tpnet"):
        tpnet.compile(device="cpu")


@pytest.fixture(scope="module")
def pipelines():
    """2-layer TGAT over the uniform sampler in both packages (host)."""
    jp = JaxPipeline("tgat", jax_generate("tiny"),
                     sampler_spec=JaxSamplerSpec(kind="uniform", k=4), **PIPE)
    tp = CTDGLinkPipeline("tgat", generate("tiny"),
                          sampler_spec=SamplerSpec(kind="uniform", k=4),
                          device="cpu", **PIPE)
    sync(jp, tp)
    return jp, tp


@pytest.mark.parametrize("key", [TRAIN_KEY, EVAL_KEY])
def test_recipe_batches_are_bit_exact_at_two_hops(pipelines, key):
    jp, tp = pipelines
    hooks = [h for h in tp.manager.hooks() if isinstance(h, UniformNeighborHook)]
    assert len(hooks) == 1 and hooks[0].num_hops == 2 and tp.cfg.num_layers == 2
    jp.reset_epoch_state()
    tp.reset_epoch_state()
    with jp.manager.activate(key), tp.manager.activate(key):
        for _, jb, tb in zip(range(4), jp._loader(jp.train_data), tp._loader(tp.train_data)):
            assert set(tb.keys()) == set(jb.keys())
            for name in jb.keys():
                want = np.asarray(jb[name])
                if want.dtype == np.int64:
                    want = want.astype(np.int32)
                np.testing.assert_array_equal(tb[name].numpy(), want, err_msg=name)
            pad = tb["nbr_ids"].reshape(-1) < 0
            assert pad.any()
            assert (tb["nbr2_ids"][pad] == -1).all() and not tb["nbr2_mask"][pad].any()
    a, b = jp.manager.state_dict(), tp.manager.state_dict()
    assert sorted(a) == sorted(b)
    for group in a:
        for leaf in a[group]:
            np.testing.assert_array_equal(b[group][leaf], np.asarray(a[group][leaf]))


def test_host_uniform_pipeline_mrr_matches_the_reference(pipelines):
    jp, tp = pipelines
    want, _ = jp.evaluate("val")
    got, _ = tp.evaluate("val")
    assert abs(got - want) <= MRR_TOL, (got, want)


def test_device_uniform_pipeline_matches_the_reference_model(pipelines):
    jp, _ = pipelines
    tp = CTDGLinkPipeline("tgat", generate("tiny"),
                          sampler_spec=SamplerSpec(kind="uniform", k=4, device=True),
                          device="cpu", **PIPE)
    hooks = [h for h in tp.manager.hooks() if isinstance(h, DeviceUniformNeighborHook)]
    assert len(hooks) == 1 and hooks[0].num_hops == 2
    sync(jp, tp)
    got, _ = tp.evaluate("val")
    # The same evaluation by hand: warm pass, then each val batch scored by
    # both packages' models on the port's batches.
    tp.reset_epoch_state()
    with tp.manager.activate(TRAIN_KEY):
        for _ in tp._loader(tp.train_data):
            pass
    rr_port, rr_ref, w_sum = [], [], []
    with tp.manager.activate(EVAL_KEY):
        for batch in tp._loader(tp.val_data):
            pos, neg = tp._eval_step(batch)
            jb = {k: jnp.asarray(batch[k].numpy()) for k in batch.keys()}
            jpos, jneg = jp._eval_step(jp.params, jb)
            w = float(batch["batch_mask"].sum())
            m = np.asarray(batch["batch_mask"].numpy())
            rr_port.append(mrr(pos, neg, batch["batch_mask"]) * w)
            rr_ref.append(float(jax_mrr(jpos, jneg, m)) * w)
            w_sum.append(w)
    port_mrr = sum(rr_port) / sum(w_sum)
    ref_mrr = sum(rr_ref) / sum(w_sum)
    assert abs(port_mrr - got) <= 1e-12
    assert abs(port_mrr - ref_mrr) <= MRR_TOL, (port_mrr, ref_mrr)


def test_device_hook_masks_and_prefixes_match_the_host_sampler():
    """Over a device-sampled pipeline's first eval-shaped batches (the
    stream's start, where some seeds have no past): hop-1 masks equal to
    the host sampler's valid prefixes on the same seeds, hop-2 masks equal
    to them on the device's own frontier (padded slots masked), and every
    valid slot strictly before its query time."""
    tp = CTDGLinkPipeline("tgat", generate("tiny"),
                          sampler_spec=SamplerSpec(kind="uniform", k=4, device=True),
                          device="cpu", **PIPE)
    data = tp.data
    host = UniformSampler(data.num_nodes, 4)
    host.build(data.src, data.dst, data.edge_t)
    tp.reset_epoch_state()
    with tp.manager.activate(EVAL_KEY):
        for _, b in zip(range(3), tp._loader(tp.train_data)):
            seeds, st = b["seed_nodes"].numpy(), b["seed_times"].numpy()
            n_valid = host.prefix(seeds, st)[1]
            np.testing.assert_array_equal(b["nbr_mask"].numpy(),
                                          np.repeat((n_valid > 0)[:, None], 4, 1))
            f_ids = b["nbr_ids"].numpy().reshape(-1)
            f_t = b["nbr_times"].numpy().reshape(-1)
            pad = f_ids < 0
            n2 = host.prefix(np.where(pad, 0, f_ids), np.where(pad, 0, f_t))[1]
            np.testing.assert_array_equal(b["nbr2_mask"].numpy(),
                                          np.repeat(((n2 > 0) & ~pad)[:, None], 4, 1))
            m, m2 = b["nbr_mask"].numpy(), b["nbr2_mask"].numpy()
            assert (b["nbr_times"].numpy() < st[:, None])[m].all()
            assert (b["nbr2_times"].numpy() < f_t[:, None])[m2].all()
            assert m.any() and (~m).any() and m2.any() and pad.any()
