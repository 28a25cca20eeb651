"""The port's numpy host layer is bit-equal to the reference's.

Same generated streams, splits (with their global ``eid_offset``), loader
batches and train/eval negatives from both packages.
"""

from __future__ import annotations

import numpy as np
import pytest

import repro.core as jcore
import repro.core.tg_hooks as jhooks
import repro.data as jdata
import repro_torch.core as tcore
import repro_torch.core.tg_hooks as thooks
import repro_torch.data as tdata

STREAMS = [("tiny", 1.0), ("wikipedia", 0.01)]
FIELDS = ("src", "dst", "edge_t", "edge_feats", "node_ids", "node_t",
          "node_feats", "static_node_feats")


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module", params=STREAMS, ids=lambda s: s[0])
def streams(request):
    name, scale = request.param
    return jdata.generate(name, scale=scale), tdata.generate(name, scale=scale)


def test_generate_is_bit_equal(streams):
    j, t = streams
    for f in FIELDS:
        assert _equal(getattr(j, f), getattr(t, f)), f
    assert j.num_nodes == t.num_nodes
    assert (j.granularity.unit, j.granularity.value) == (
        t.granularity.unit, t.granularity.value)


def test_splits_and_eid_offsets_match(streams):
    j, t = streams
    for js, ts in zip(j.split(0.15, 0.15), t.split(0.15, 0.15)):
        assert js.eid_offset == ts.eid_offset
        for f in FIELDS:
            assert _equal(getattr(js, f), getattr(ts, f)), f


def _batches(core, hooks, data, key, seed=3, **kw):
    """Loader batches through pad + train/eval negatives of one package."""
    m = core.HookManager()
    m.register(hooks.PadBatchHook(64))
    m.register(hooks.NegativeEdgeHook(data.num_nodes, num_negatives=1,
                                      seed=seed), key="train")
    m.register(hooks.TGBEvalNegativesHook(data.num_nodes, num_negatives=7,
                                          seed=seed), key="eval")
    out = []
    with m.activate(key):
        for split in data.split(0.15, 0.15):
            for b in core.DGDataLoader(core.DGraph(split), m, batch_size=64):
                out.append(({k: b[k] for k in b.keys()}, b.meta["eids"]))
    return out


@pytest.mark.parametrize("key", ["train", "eval"])
def test_loader_batches_and_negatives_are_bit_equal(streams, key):
    j, t = streams
    jb = _batches(jcore, jhooks, j, key)
    tb = _batches(tcore, thooks, t, key)
    assert len(jb) == len(tb) > 0
    for (ja, jeids), (ta, teids) in zip(jb, tb):
        assert np.array_equal(jeids, teids)
        assert set(ja) == set(ta)
        for k in ja:
            assert _equal(np.asarray(ja[k]), np.asarray(ta[k])), k
