"""The torch ``DeviceRecencySampler`` is bit-equal to the JAX reference.

Same update streams (wraparound: more than K inserts for one node in a
batch; duplicate timestamps; padded ``valid`` masks; directed and
undirected) give the same canonical ``state_dict`` and the same samples.
The neighbor hook hands the model the buffer *as sampled*
(predict-then-reveal), never the post-update one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.device_sampler import DeviceRecencySampler as JaxSampler
from repro.core.tg_hooks import DeviceRecencyNeighborHook as JaxHook
from repro_torch.core import Batch
from repro_torch.core.device_sampler import DeviceRecencySampler
from repro_torch.core.tg_hooks import DeviceRecencyNeighborHook


def _stream(rng, n, batches, bsz, *, hot=False, dup_times=False, pad=False):
    """Time-ordered batches of (src, dst, t, eids, valid)."""
    t0 = 0
    out = []
    for b in range(batches):
        if hot:  # a few nodes take most events -> > K inserts per batch
            src = rng.choice(3, size=bsz)
            dst = rng.integers(0, n, size=bsz)
        else:
            src = rng.integers(0, n, size=bsz)
            dst = rng.integers(0, n, size=bsz)
        gaps = (np.zeros(bsz, np.int64) if dup_times
                else rng.integers(0, 3, size=bsz))
        t = t0 + np.cumsum(gaps)
        t0 = int(t[-1]) + (0 if dup_times else 1)
        eids = np.arange(b * bsz, (b + 1) * bsz, dtype=np.int64)
        valid = np.ones(bsz, bool)
        if pad:
            valid[rng.integers(bsz // 2, bsz):] = False
        out.append((src.astype(np.int64), dst.astype(np.int64), t, eids, valid))
    return out


CASES = {
    "plain": dict(),
    "wraparound": dict(hot=True),
    "dup_times": dict(dup_times=True),
    "padded": dict(pad=True),
    "wrap_dup_padded": dict(hot=True, dup_times=True, pad=True),
}


@pytest.mark.parametrize("directed", [False, True], ids=["undirected", "directed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_state_and_samples_bit_equal(case, directed):
    rng = np.random.default_rng(7)
    n, k = 40, 5
    js = JaxSampler(n, k, directed=directed)
    ts = DeviceRecencySampler(n, k, directed=directed, device="cpu")
    seeds = np.arange(n, dtype=np.int64)
    for src, dst, t, eids, valid in _stream(rng, n, 6, 33, **CASES[case]):
        js.update(src, dst, t, eids, valid=valid)
        ts.update(src, dst, t, eids, valid=valid)
        jd, td = js.state_dict(), ts.state_dict()
        assert set(jd) == set(td)
        for key in jd:
            assert td[key].dtype == np.int64
            np.testing.assert_array_equal(jd[key], td[key], err_msg=key)
        jb, tb = js.sample(seeds), ts.sample(seeds)
        for f in ("nbr_ids", "nbr_times", "nbr_eids", "mask"):
            np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                          getattr(tb, f).numpy(), err_msg=f)
    # The sink row absorbs padding but never leaks into the canonical state.
    assert ts.packed_buffer.shape == (n + 1, k, 3)


def test_load_state_dict_round_trips():
    rng = np.random.default_rng(1)
    ts = DeviceRecencySampler(30, 4, device="cpu")
    for src, dst, t, eids, valid in _stream(rng, 30, 3, 20, hot=True):
        ts.update(src, dst, t, eids, valid=valid)
    other = DeviceRecencySampler(30, 4, device="cpu")
    other.load_state_dict(ts.state_dict())
    for key, val in ts.state_dict().items():
        np.testing.assert_array_equal(val, other.state_dict()[key])
    # Node rows agree; the sink row (last) holds whatever padding wrote.
    assert torch.equal(ts.packed_buffer[:-1], other.packed_buffer[:-1])
    js = JaxSampler(30, 4)
    js.load_state_dict(ts.state_dict())
    np.testing.assert_array_equal(np.asarray(js.sample(np.arange(30)).nbr_ids),
                                  other.sample(np.arange(30)).nbr_ids.numpy())


def test_buffer_ids_are_the_reference_rows():
    """``buffer_ids`` is the packed buffer's id channel, node rows equal to
    the reference's (the sink row, last, holds whatever padding wrote)."""
    rng = np.random.default_rng(5)
    js, ts = JaxSampler(30, 4), DeviceRecencySampler(30, 4, device="cpu")
    for src, dst, t, eids, valid in _stream(rng, 30, 3, 20, hot=True, pad=True):
        js.update(src, dst, t, eids, valid=valid)
        ts.update(src, dst, t, eids, valid=valid)
    ids = ts.buffer_ids
    assert ids.shape == (31, 4) and ids.dtype == torch.int32
    assert torch.equal(ids, ts.packed_buffer[..., 0])
    np.testing.assert_array_equal(ids[:-1].numpy(), np.asarray(js.buffer_ids)[:-1])


def _hook_batch(src, dst, t, neg, mask):
    b = Batch({"src": src, "dst": dst, "time": t, "neg": neg,
               "batch_mask": mask}, meta={"eids": np.arange(len(src))})
    return b


def test_hook_exposes_the_pre_update_buffer():
    """Predict-then-reveal: ``nbr_buf`` is the buffer the batch was sampled
    from; the batch's own positive edges must not be in it."""
    rng = np.random.default_rng(3)
    n, k = 25, 4
    hook = DeviceRecencyNeighborHook(n, k, device="cpu")
    jhook = JaxHook(n, k, expose_buffer=True)
    for src, dst, t, eids, valid in _stream(rng, n, 4, 16, hot=True):
        neg = rng.integers(0, n, size=(16, 3))
        before = hook.sampler.packed_buffer.clone()
        out = hook(_hook_batch(src, dst, t, neg, valid))
        jout = jhook(_hook_batch(src, dst, t, neg, valid))
        assert torch.equal(out["nbr_buf"], before)
        assert not torch.equal(out["nbr_buf"], hook.sampler.packed_buffer)
        np.testing.assert_array_equal(np.asarray(jout["nbr_buf"]),
                                      out["nbr_buf"].numpy())
        # The sampled neighborhoods are read from the same snapshot.
        for key in ("nbr_ids", "nbr_times", "nbr_eids", "nbr_mask"):
            np.testing.assert_array_equal(np.asarray(jout[key]),
                                          out[key].numpy(), err_msg=key)
        np.testing.assert_array_equal(jout["seed_nodes"], out["seed_nodes"])


def test_update_rejects_values_beyond_int32():
    ts = DeviceRecencySampler(4, 2, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        ts.update(np.array([0]), np.array([1]), np.array([2**40]))
