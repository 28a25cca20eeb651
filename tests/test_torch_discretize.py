"""The port's discretization and snapshot tensorization hold against the
reference.

The same numpy streams go through both packages. Integer outputs are held
bit for bit (classes, ticks, counts, masks, snapshot grids); reduced float
features are held bit for bit on the host numpy path (a copy of the
reference's) and within 1e-6 on the tensor core, whose sums run in another
order than XLA's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DGData as JaxDGData
from repro.core import snapshot_tensor as jax_snapshot_tensor
from repro.core.discretize import discretize as jax_discretize
from repro.core.discretize import discretize_edges_padded as jax_padded
from repro.core.discretize import jax_discretize_supported
from repro.core.granularity import TimeDelta as JaxTimeDelta
from repro.data import generate as jax_generate
from repro_torch.core import DGData, TimeDelta, snapshot_tensor
from repro_torch.core.discretize import (
    _host_ticks,
    device_discretize_supported,
    discretize,
    discretize_edges_padded,
)
from repro_torch.data import generate

REDUCTIONS = ("first", "last", "sum", "mean", "max", "count")
FEAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _arrays(seed, n=400, nodes=12, t_hi=20_000, d=3, node_events=60):
    """A time-sorted stream with heavy (tick, src, dst) duplication, edge
    features and node events."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, t_hi, n))
    kw = dict(edge_feats=rng.standard_normal((n, d)).astype(np.float32))
    if node_events:
        kw.update(node_ids=rng.integers(0, nodes, node_events),
                  node_t=np.sort(rng.integers(0, t_hi, node_events)),
                  node_feats=rng.standard_normal((node_events, 2)).astype(np.float32))
    return (rng.integers(0, nodes, n), rng.integers(0, nodes, n), t), kw


def _both(seed, **kw):
    (src, dst, t), extra = _arrays(seed, **kw)
    return (JaxDGData.from_arrays(src, dst, t, granularity="s", **extra),
            DGData.from_arrays(src, dst, t, granularity="s", **extra))


def _equal_data(a, b):
    for name in ("src", "dst", "edge_t", "edge_feats", "node_ids", "node_t",
                 "node_feats", "static_node_feats"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.num_nodes == b.num_nodes
    assert a.granularity.unit == b.granularity.unit


@pytest.mark.parametrize("reduce", REDUCTIONS)
@pytest.mark.parametrize("unit", ["m", "h"])
def test_numpy_discretize_is_bit_equal(reduce, unit):
    jd, td = _both(0)
    _equal_data(jax_discretize(jd, JaxTimeDelta.coerce(unit), reduce=reduce),
                discretize(td, TimeDelta.coerce(unit), reduce=reduce))
    # DGData.discretize delegates; featureless count creates the feature.
    jd2, td2 = _both(1, d=0, node_events=0)
    jd2 = JaxDGData.from_arrays(jd2.src, jd2.dst, jd2.edge_t, granularity="s")
    td2 = DGData.from_arrays(td2.src, td2.dst, td2.edge_t, granularity="s")
    _equal_data(jd2.discretize(unit, reduce=reduce),
                td2.discretize(unit, reduce=reduce))


def test_numpy_discretize_refuses_other_backends_and_event_order():
    _, td = _both(2)
    with pytest.raises(ValueError, match="'device'"):
        td.discretize("h", backend="jax")
    with pytest.raises(ValueError, match="unknown reduction"):
        td.discretize("h", reduce="median")
    ev = DGData.from_arrays([0], [1], [0], granularity=TimeDelta.event())
    with pytest.raises(TypeError, match="real-time"):
        ev.discretize("h")


@pytest.mark.parametrize("reduce", REDUCTIONS)
@pytest.mark.parametrize("cap", ["all", "small"])
def test_padded_core_matches_the_reference(reduce, cap):
    (src, dst, t), extra = _arrays(3, n=300)
    feats = extra["edge_feats"]
    e = len(src)
    capacity = e if cap == "all" else 40  # "small" overflows: tail dropped
    kw = dict(k=600, reduce=reduce, capacity=capacity, feat_dim=feats.shape[1])
    want = jax_padded(jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
                      jnp.asarray(t, jnp.int32), jnp.asarray(feats), **kw)
    got = discretize_edges_padded(torch.from_numpy(src), torch.from_numpy(dst),
                                  torch.from_numpy(t), torch.from_numpy(feats),
                                  **kw)
    for name, a, b in zip(("src", "dst", "ct"), want[:3], got[:3]):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int(got[4]) == int(want[4]) and got[4].dtype == torch.int32
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **FEAT_TOL)


def test_padded_core_without_features():
    (src, dst, t), _ = _arrays(4, n=120)
    kw = dict(k=900, capacity=120, feat_dim=0)
    for reduce in ("first", "count"):
        want = jax_padded(jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
                          jnp.asarray(t, jnp.int32), jnp.zeros((120, 0)),
                          reduce=reduce, **kw)
        got = discretize_edges_padded(torch.from_numpy(src), torch.from_numpy(dst),
                                      torch.from_numpy(t), None, reduce=reduce,
                                      **kw)
        for a, b in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert (got[3] is None) == (want[3] is None)
        if want[3] is not None:
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _assert_snapshots_equal(want, got):
    for name in ("src", "dst", "mask", "counts"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name)
        assert b.dtype == {"mask": torch.bool}.get(name, torch.int32), name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert (got.t0, got.ticks, got.num_nodes) == (want.t0, want.ticks,
                                                   want.num_nodes)
    assert got.unit.unit == want.unit.unit


@pytest.mark.parametrize("unit,capacity", [("h", None), ("h", 4), ("m", None),
                                           ("d", None)])
def test_snapshot_tensor_is_bit_equal(tiny_graph, unit, capacity):
    jd = tiny_graph.slice_events(0, 600)
    td = generate("tiny").slice_events(0, 600)
    want = jax_snapshot_tensor(jd, unit, capacity=capacity)
    got = snapshot_tensor(td, unit, capacity=capacity, device="cpu")
    _assert_snapshots_equal(want, got)
    if capacity is not None:
        assert got.capacity == capacity


def test_snapshot_tensor_on_wikipedia_is_bit_equal():
    want = jax_snapshot_tensor(jax_generate("wikipedia", scale=0.01), "h")
    got = generate("wikipedia", scale=0.01).to_snapshots("h", device="cpu")
    _assert_snapshots_equal(want, got)
    assert got.num_snapshots == 720


def test_snapshot_tensor_huge_ticks_fallback():
    """Raw times beyond int32: daily ticks fit int32 and take the tensor core
    with the ticks pre-divided on the host; hourly ones do not, trip the
    guard, and take the host numpy fallback. Both build the reference's
    grids, ticks staged zero-based."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.integers(2**45, 2**45 + 50 * 3600, 50))
    s, d = rng.integers(0, 10, 50), rng.integers(0, 10, 50)
    jd = JaxDGData.from_arrays(s, d, t, granularity="s")
    td = DGData.from_arrays(s, d, t, granularity="s")
    for unit, fits in (("d", True), ("h", False)):
        k = TimeDelta.coerce(unit).ticks_per(td.granularity)
        assert device_discretize_supported(td, k, edges_only=True) is fits
        assert jax_discretize_supported(jd, k, edges_only=True) is fits
        _assert_snapshots_equal(jax_snapshot_tensor(jd, unit),
                                snapshot_tensor(td, unit, device="cpu"))
    staged, k_dev = _host_ticks(td.edge_t, 86400)
    assert k_dev == 1 and staged.max() < 2**31


def test_snapshot_tensor_rows_and_negatives(tiny_graph):
    st = snapshot_tensor(generate("tiny").slice_events(0, 600), "h",
                         device="cpu")
    assert st.capacity & (st.capacity - 1) == 0
    row = st.row(3)
    assert set(row) == {"src", "dst", "snap_mask"}
    assert st.row_of_time(int(tiny_graph.edge_t[0])) == 0
    neg = st.negatives(5, 3)
    assert neg.shape == (st.num_snapshots, st.capacity, 3)
    assert neg.dtype == torch.int32
    assert int(neg.min()) >= 0 and int(neg.max()) < st.num_nodes
