"""The node task's host pieces and Table 5's comparison points in the port.

Held against the reference on the same numpy inputs:

* ``train.metrics.auc`` and ``ndcg_at_k``, bit for bit: ties in scores and
  predictions, all-positive and all-negative labels, rows with no relevant
  target, ``k`` larger than the row;
* ``models.tg.persistent.PersistentForecast``, bit for bit;
* ``core.discretize.discretize_naive`` against the reference's, bit for
  bit, and ``discretize_device`` (on the CPU here; on the card in
  ``chip_smoke.py``'s ``node`` phase) against the reference's
  ``discretize_jax``: integer columns (classes, ticks, node events) bit for
  bit, ``first``/``last``/``max``/``count`` features bit for bit,
  ``sum``/``mean`` within 1e-5 relative (``index_add_`` adds in arrival
  order, XLA's segment sum in its own); the int32 guard's numpy return; the
  backend names (``"device"``; the reference's ``"jax"`` refused by name).
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.core import DGData as JaxDGData
from repro.core.discretize import discretize_jax as jax_discretize_jax
from repro.core.discretize import discretize_naive as jax_discretize_naive
from repro.core.granularity import TimeDelta as JaxTimeDelta
from repro.models.tg.persistent import PersistentForecast as JaxPersistent
from repro.train.metrics import auc as jax_auc
from repro.train.metrics import ndcg_at_k as jax_ndcg_at_k
from repro_torch.core import (
    DGData,
    TimeDelta,
    discretize,
    discretize_device,
    discretize_naive,
)
from repro_torch.models.tg import persistent
from repro_torch.train import auc, ndcg_at_k

REDUCTIONS = ("first", "last", "sum", "mean", "max", "count")
EXACT = ("first", "last", "max", "count")
SUM_RTOL = 1e-5


def test_auc_is_bit_equal():
    rng = np.random.default_rng(0)
    cases = [
        (rng.standard_normal(50), rng.integers(0, 2, 50)),
        (rng.integers(0, 4, 60).astype(np.float32), rng.integers(0, 2, 60)),  # ties
        (np.ones(10), np.r_[np.ones(5), np.zeros(5)]),  # every score tied
        (rng.standard_normal(8), np.ones(8)),  # no negative
        (rng.standard_normal(8), np.zeros(8)),  # no positive
    ]
    for scores, labels in cases:
        assert auc(scores, labels) == jax_auc(scores, labels)


@pytest.mark.parametrize("k", [1, 3, 10, 40])
def test_ndcg_at_k_is_bit_equal(k):
    rng = np.random.default_rng(k)
    pred = rng.random((30, 16)).astype(np.float32)
    pred[::3, :8] = 0.25  # tied predictions
    target = rng.integers(0, 3, (30, 16)).astype(np.float32)
    target[::4] = 0.0  # rows with no relevant target score 0
    got, want = ndcg_at_k(pred, target, k), jax_ndcg_at_k(pred, target, k)
    assert got == want and 0.0 < got < 1.0
    assert ndcg_at_k(target, target, k) == jax_ndcg_at_k(target, target, k)


def test_persistent_forecast_is_bit_equal():
    rng = np.random.default_rng(1)
    ours, ref = persistent.PersistentForecast(20, 4), JaxPersistent(20, 4)
    for _ in range(5):
        nodes = rng.choice(20, 6, replace=False)
        labels = rng.random((6, 4)).astype(np.float32)
        ours.update(nodes, labels)
        ref.update(nodes, labels)
        q = rng.integers(0, 20, 9)
        np.testing.assert_array_equal(ours.predict(q), ref.predict(q))
    np.testing.assert_array_equal(ours._seen, ref._seen)
    ours.reset_state()
    assert not ours._seen.any() and not ours.predict(np.arange(20)).any()


def _stream(seed, n=500, nodes=15, t_hi=40_000, d=3, node_events=80):
    """A time-sorted stream with heavy (tick, src, dst) duplication, edge
    features and node events (with features), in both packages."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, t_hi, n))
    kw = {}
    if d:
        kw["edge_feats"] = rng.standard_normal((n, d)).astype(np.float32)
    if node_events:
        kw.update(node_ids=rng.integers(0, nodes, node_events),
                  node_t=np.sort(rng.integers(0, t_hi, node_events)),
                  node_feats=rng.standard_normal((node_events, 2)).astype(np.float32))
    arrays = (rng.integers(0, nodes, n), rng.integers(0, nodes, n), t)
    return (JaxDGData.from_arrays(*arrays, granularity="s", **kw),
            DGData.from_arrays(*arrays, granularity="s", **kw))


def _hold(want, got, reduce):
    """Integer columns and exact reductions bit for bit; sums relative."""
    for name in ("src", "dst", "edge_t", "node_ids", "node_t", "node_feats"):
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (want.num_nodes, want.granularity.unit) == (got.num_nodes,
                                                       got.granularity.unit)
    a, b = want.edge_feats, got.edge_feats
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.dtype == b.dtype
    if reduce in EXACT:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=SUM_RTOL, atol=SUM_RTOL * np.abs(a).max())


@pytest.mark.parametrize("reduce", REDUCTIONS)
def test_device_discretize_matches_the_reference(reduce):
    jd, td = _stream(2)
    for unit in ("m", "h"):
        want = jax_discretize_jax(jd, JaxTimeDelta.coerce(unit), reduce=reduce)
        got = discretize_device(td, TimeDelta.coerce(unit), reduce=reduce,
                                device="cpu")
        _hold(want, got, reduce)
        # Through the backend name and the DGData method, as a user calls it.
        _hold(want, td.discretize(unit, reduce=reduce, backend="device",
                                  device="cpu"), reduce)
    # Featureless: ``count`` creates the feature, the others carry none.
    jd0, td0 = _stream(3, d=0, node_events=0)
    _hold(jax_discretize_jax(jd0, JaxTimeDelta("h"), reduce=reduce),
          discretize_device(td0, TimeDelta("h"), reduce=reduce, device="cpu"),
          reduce)


@pytest.mark.parametrize("reduce", REDUCTIONS)
def test_naive_baseline_is_bit_equal_to_the_reference(reduce):
    jd, td = _stream(4, n=300)
    want = jax_discretize_naive(jd, JaxTimeDelta("h"), reduce=reduce)
    got = discretize_naive(td, TimeDelta("h"), reduce=reduce)
    for name in ("src", "dst", "edge_t", "edge_feats", "node_ids"):
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    # The three paths name the same classes.
    fast = discretize(td, TimeDelta("h"), reduce=reduce)
    for name in ("src", "dst", "edge_t"):
        np.testing.assert_array_equal(getattr(fast, name), getattr(got, name))


def test_guard_returns_the_numpy_result_and_backends_are_named():
    # Coarse ticks beyond int32: the device form returns the host path's
    # result, as the reference's discretize_jax does.
    src, dst = np.array([0, 1, 1]), np.array([1, 0, 0])
    t = np.array([0, 2**40, 2**40])
    td = DGData.from_arrays(src, dst, t, granularity="s")
    jd = JaxDGData.from_arrays(src, dst, t, granularity="s")
    got = discretize_device(td, TimeDelta("s"), reduce="count", device="cpu")
    want = jax_discretize_jax(jd, JaxTimeDelta("s"), reduce="count")
    _hold(want, got, "count")
    np.testing.assert_array_equal(got.edge_feats[:, 0], [1.0, 2.0])
    with pytest.raises(ValueError, match="device"):
        td.discretize("h", backend="jax")
    with pytest.raises(ValueError, match="unknown reduction"):
        discretize_device(td, TimeDelta("h"), reduce="median", device="cpu")
