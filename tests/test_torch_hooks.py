"""The port's recipes and hooks that the link pipelines do not build,
against the reference on the CPU (bit-equal: both are numpy or integer
state):

* ``RECIPE_TGB_NODE`` (padding, host recency neighbors of the positive
  events only, edge features, the transfer) and ``RECIPE_ANALYTICS_DOS``,
  registered and exported under the reference's names, over the ``tiny``
  stream's batches;
* ``DOSEstimateHook``: the moments over several batches in a row (the
  probe generator persists from batch to batch) and on an empty batch;
* the recency hooks' switches (``include_negatives``, ``dedup`` on the host
  hook, ``update_buffer``), on the host and the device hook: the outputs
  and the sampler state after every batch equal the reference's, a batch
  without ``neg`` runs when negatives are off, ``dedup=False`` gives the
  rows of ``dedup=True`` and ``update_buffer=False`` leaves the state as it
  was.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.tg_hooks import DeviceRecencyNeighborHook as JaxDeviceHook
from repro.core.tg_hooks import DOSEstimateHook as JaxDOS
from repro.core.tg_hooks import RecencyNeighborHook as JaxHostHook
from repro.data import generate as jax_generate
from repro_torch.core import Batch
from repro_torch.core.tg_hooks import (
    DeviceRecencyNeighborHook,
    DOSEstimateHook,
    RecencyNeighborHook,
)
from repro_torch.data import generate

NEIGHBOR_KEYS = ("seed_nodes", "seed_times", "nbr_ids", "nbr_times",
                 "nbr_eids", "nbr_mask")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tiny():
    data, ref = generate("tiny", scale=0.2), jax_generate("tiny", scale=0.2)
    for name in ("src", "dst", "edge_t", "edge_feats"):
        np.testing.assert_array_equal(getattr(data, name), getattr(ref, name))
    return data, ref


def test_recipes_are_registered_and_exported_under_the_reference_names():
    for name in ("RECIPE_TGB_LINK", "RECIPE_TGB_NODE", "RECIPE_DTDG_SNAPSHOT",
                 "RECIPE_ANALYTICS_DOS"):
        assert getattr(tcore, name) == getattr(jcore, name)
        assert name in tcore.__all__
    assert tcore.RecipeRegistry.available() == jcore.RecipeRegistry.available()


def test_node_recipe_gives_the_reference_batches():
    data, ref = _tiny()
    kw = dict(num_nodes=data.num_nodes, k=5, batch_size=64,
              edge_feats=data.edge_feats, edge_feat_dim=data.edge_feat_dim)
    tm = tcore.RecipeRegistry.build(tcore.RECIPE_TGB_NODE, device="cpu", **kw)
    jm = jcore.RecipeRegistry.build(jcore.RECIPE_TGB_NODE, **kw)
    assert ([type(h).__name__ for h in tm.hooks()]
            == [type(h).__name__ for h in jm.hooks()])
    host = [h for h in tm.hooks() if isinstance(h, RecencyNeighborHook)]
    assert len(host) == 1 and not host[0].include_negatives and host[0].dedup
    tl = tcore.DGDataLoader(tcore.DGraph(data), tm, batch_size=64)
    jl = jcore.DGDataLoader(jcore.DGraph(ref), jm, batch_size=64)
    n = 0
    for tb, jb in zip(tl, jl):
        assert "neg" not in tb
        for key in NEIGHBOR_KEYS + ("edge_feats", "nbr_feats", "batch_mask"):
            np.testing.assert_array_equal(_np(tb[key]), _np(jb[key]), err_msg=key)
        n += 1
    assert n > 3


def test_dos_recipe_gives_the_reference_moments_per_hour():
    data, ref = _tiny()
    tm = tcore.RecipeRegistry.build(tcore.RECIPE_ANALYTICS_DOS,
                                    num_nodes=data.num_nodes, num_moments=8)
    jm = jcore.RecipeRegistry.build(jcore.RECIPE_ANALYTICS_DOS,
                                    num_nodes=ref.num_nodes, num_moments=8)
    tl = tcore.DGDataLoader(tcore.DGraph(data), tm, batch_size=None, batch_unit="h")
    jl = jcore.DGDataLoader(jcore.DGraph(ref), jm, batch_size=None, batch_unit="h")
    got = [b["dos"] for b in tl]
    want = [b["dos"] for b in jl]
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert g.shape == (8,) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_dos_hook_is_bit_equal_over_batches_in_a_row():
    """The reference's ``test_dos_hook_moments`` on several batches: the
    probes come from one generator that persists, so every batch after the
    first checks that both drew the same number of values."""
    rng = np.random.default_rng(0)
    th, jh = DOSEstimateHook(50, num_moments=6, seed=4), JaxDOS(50, num_moments=6, seed=4)
    for size in (100, 37, 1, 250):
        b = {"src": rng.integers(0, 50, size), "dst": rng.integers(0, 50, size),
             "time": np.arange(size)}
        got = th(Batch(dict(b)))["dos"]
        want = jh(jcore.Batch(dict(b)))["dos"]
        np.testing.assert_array_equal(got, want)
        assert got.shape == (6,) and abs(got[0] - 1.0) < 0.2
    th.reset_state()  # the generator persists across epochs too
    jh.reset_state()
    b = {"src": np.array([3, 4]), "dst": np.array([4, 9]), "time": np.arange(2)}
    np.testing.assert_array_equal(th(Batch(dict(b)))["dos"],
                                  jh(jcore.Batch(dict(b)))["dos"])
    empty = {"src": np.zeros(0, np.int64), "dst": np.zeros(0, np.int64),
             "time": np.zeros(0, np.int64)}
    np.testing.assert_array_equal(th(Batch(dict(empty)))["dos"], np.zeros(6, np.float32))


def _batches(n, k_batches, bsz, seed):
    rng = np.random.default_rng(seed)
    out, t0 = [], 0
    for i in range(k_batches):
        src = np.where(rng.random(bsz) < 0.4, rng.integers(0, 3, bsz),
                       rng.integers(0, n, bsz)).astype(np.int64)
        dst = rng.integers(0, n, bsz).astype(np.int64)
        t = t0 + np.sort(rng.integers(0, 4, bsz))
        t0 = int(t[-1]) + 1
        neg = rng.integers(0, n, (bsz, 3)).astype(np.int64)
        mask = np.ones(bsz, bool)
        mask[-4:] = i % 2 == 0
        out.append(({"src": src, "dst": dst, "time": t, "neg": neg,
                     "batch_mask": mask}, np.arange(i * bsz, (i + 1) * bsz)))
    return out


SWITCHES = [dict(include_negatives=True), dict(include_negatives=False),
            dict(update_buffer=False), dict(include_negatives=False, update_buffer=False)]


@pytest.mark.parametrize("num_hops", [1, 2])
@pytest.mark.parametrize("where", ["host", "host_no_dedup", "device"])
@pytest.mark.parametrize("switches", SWITCHES,
                         ids=["negatives", "positives_only", "frozen", "positives_frozen"])
def test_recency_hook_switches_match_the_reference(switches, where, num_hops):
    n, k = 20, 4
    kw = dict(num_hops=num_hops, **switches)
    if where == "device":
        th = DeviceRecencyNeighborHook(n, k, device="cpu", expose_buffer=False, **kw)
        jh = JaxDeviceHook(n, k, expose_buffer=False, **kw)
    else:
        dedup = dict(dedup=where == "host")
        th = RecencyNeighborHook(n, k, **kw, **dedup)
        jh = JaxHostHook(n, k, **kw, **dedup)
    assert th.requires == jh.requires and th.produces == jh.produces
    # warm state from a switch-free hook, so that frozen hooks sample a
    # non-empty buffer
    warm = JaxHostHook(n, k)
    for cols, eids in _batches(n, 2, 24, seed=1):
        warm(jcore.Batch(dict(cols), meta={"eids": eids}))
    th.load_state_dict(warm.state_dict())
    jh.load_state_dict(warm.state_dict())
    include = switches.get("include_negatives", True)
    for cols, eids in _batches(n, 4, 24, seed=2):
        if not include:
            cols = {key: v for key, v in cols.items() if key != "neg"}
        before = th.state_dict()
        tout = th(Batch(dict(cols), meta={"eids": eids}))
        jout = jh(jcore.Batch(dict(cols), meta={"eids": eids}))
        keys = NEIGHBOR_KEYS + (tuple(k_.replace("nbr", "nbr2") for k_ in NEIGHBOR_KEYS[2:])
                                if num_hops == 2 else ())
        for key in keys:
            np.testing.assert_array_equal(_np(tout[key]), _np(jout[key]), err_msg=key)
        rows = 2 * len(cols["src"]) + (cols["neg"].size if include else 0)
        assert len(_np(tout["seed_nodes"])) == rows
        after, want = th.state_dict(), jh.state_dict()
        for key in want:
            np.testing.assert_array_equal(after[key], want[key], err_msg=key)
            if not switches.get("update_buffer", True):
                np.testing.assert_array_equal(after[key], before[key], err_msg=key)
