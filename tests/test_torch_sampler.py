"""The port's host recency sampler holds bit for bit against the reference.

``repro_torch.core.sampler.RecencySampler`` is a numpy copy of
``repro.core.sampler.RecencySampler``: on seeded event streams with repeated
nodes, equal timestamps and self loops, fed in batches of every size (one
event, several per node, more than K per node), its buffers, cursors, counts
and every sampled neighborhood equal the reference's and the per-event
``SequentialRecencySampler`` of both packages, undirected and directed.
Checkpoint state round-trips between the host samplers of both packages and
the port's device sampler. Integer state: bit-exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.core.sampler import RecencySampler as JaxRecencySampler
from repro.core.sampler import SequentialRecencySampler as JaxSequential
from repro_torch.core.device_sampler import DeviceRecencySampler
from repro_torch.core.sampler import RecencySampler, SequentialRecencySampler

N, K = 30, 4


def _stream(seed, n_events=400, n_nodes=N):
    """Time-sorted events over few nodes: duplicates within batches, runs of
    equal timestamps, self loops."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_events)
    dst = rng.integers(0, n_nodes, n_events)
    dst[::17] = src[::17]  # self loops
    t = np.sort(rng.integers(0, n_events // 3, n_events))  # many equal times
    eids = np.arange(n_events, dtype=np.int64) + 1000
    return src, dst, t, eids


def _assert_state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for key in sa:
        np.testing.assert_array_equal(np.asarray(sa[key]), np.asarray(sb[key]),
                                      err_msg=key)
        assert np.asarray(sa[key]).dtype == np.asarray(sb[key]).dtype == np.int64


def _assert_block_equal(a, b):
    for name in ("nbr_ids", "nbr_times", "nbr_eids", "mask"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("directed", [False, True], ids=["undirected", "directed"])
@pytest.mark.parametrize("batch", [1, 3, 25, 200], ids=lambda b: f"b{b}")
def test_matches_reference_and_sequential_oracles(directed, batch):
    src, dst, t, eids = _stream(batch)
    samplers = [RecencySampler(N, K, directed), JaxRecencySampler(N, K, directed),
                SequentialRecencySampler(N, K, directed),
                JaxSequential(N, K, directed)]
    seeds = np.arange(N)
    for lo in range(0, len(src), batch):
        sl = slice(lo, lo + batch)
        for s in samplers:
            s.update(src[sl], dst[sl], t[sl], eids[sl])
        mine = samplers[0]
        for other in samplers[1:]:
            _assert_state_equal(mine, other)
        q = np.full(N, t[sl][-1])
        want = samplers[1].sample(seeds, q)
        _assert_block_equal(mine.sample(seeds, q), want)
        _assert_block_equal(mine.sample(seeds), samplers[1].sample(seeds))


def test_update_without_eids_and_empty_batches():
    a, b = RecencySampler(N, K), JaxRecencySampler(N, K)
    src, dst, t, _ = _stream(4, 60)
    for s in (a, b):
        s.update(src[:0], dst[:0], t[:0])
        s.update(src, dst, t)
    _assert_state_equal(a, b)
    assert (a.state_dict()["eids"] == -1).all()


def test_query_times_mask_later_neighbors():
    a, b = RecencySampler(N, K), JaxRecencySampler(N, K)
    src, dst, t, eids = _stream(5, 120)
    for s in (a, b):
        s.update(src, dst, t, eids)
    seeds = np.random.default_rng(0).integers(0, N, 50)
    q = np.random.default_rng(1).integers(0, int(t.max()) + 2, 50)
    got, want = a.sample(seeds, q), b.sample(seeds, q)
    _assert_block_equal(got, want)
    assert (got.nbr_times[got.mask] <= np.repeat(q, K).reshape(50, K)[got.mask]).all()


def test_k_must_be_positive():
    with pytest.raises(ValueError, match="positive"):
        RecencySampler(N, 0)


def test_state_dict_round_trips_across_samplers():
    src, dst, t, eids = _stream(6)
    port, ref = RecencySampler(N, K), JaxRecencySampler(N, K)
    for s in (port, ref):
        s.update(src[:250], dst[:250], t[:250], eids[:250])

    # reference -> port, port -> reference, port -> device sampler -> port
    a = RecencySampler(N, K)
    a.load_state_dict(ref.state_dict())
    _assert_state_equal(a, ref)
    b = JaxRecencySampler(N, K)
    b.load_state_dict(port.state_dict())
    _assert_state_equal(b, port)
    dev = DeviceRecencySampler(N, K, device="cpu")
    dev.load_state_dict(port.state_dict())
    c = RecencySampler(N, K)
    c.load_state_dict(dev.state_dict())
    _assert_state_equal(c, port)

    # Each restored sampler carries on exactly as the original.
    for s in (port, ref, a, b, c):
        s.update(src[250:], dst[250:], t[250:], eids[250:])
    for s in (ref, a, b, c):
        _assert_state_equal(port, s)
    # The loaded state is a copy: the checkpoint's arrays are not aliased.
    saved = port.state_dict()
    d = RecencySampler(N, K)
    d.load_state_dict(saved)
    d.update(src[:5], dst[:5], t[:5], eids[:5])
    assert not np.array_equal(d.state_dict()["cursor"], saved["cursor"])


def test_reset_state_clears_everything():
    s = RecencySampler(N, K)
    src, dst, t, eids = _stream(7, 50)
    s.update(src, dst, t, eids)
    s.reset_state()
    _assert_state_equal(s, JaxRecencySampler(N, K))


def test_matches_the_device_sampler():
    """Host and device samplers give the same neighborhoods (the reference
    promises this of its twins)."""
    src, dst, t, eids = _stream(8, 300)
    host, dev = RecencySampler(N, K), DeviceRecencySampler(N, K, device="cpu")
    seeds = np.arange(N)
    for lo in range(0, 300, 40):
        sl = slice(lo, lo + 40)
        a, b = host.sample(seeds), dev.sample(seeds)
        for name in ("nbr_ids", "nbr_times", "nbr_eids", "mask"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name).numpy(), err_msg=name)
        host.update(src[sl], dst[sl], t[sl], eids[sl])
        dev.update(src[sl], dst[sl], t[sl], eids[sl])
    _assert_state_equal(host, dev)
