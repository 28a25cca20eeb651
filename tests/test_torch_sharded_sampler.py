"""The port's node-sharded device samplers against the reference.

Each world (2 and 3 gloo ranks on the CPU, ``tests/_torch_dist.py``) runs
once per module; the tests read their part of its results:

* the sharded recency sampler (``DeviceRecencySampler(mesh=)``) is
  bit-equal to the reference's single-device sampler on a random stream
  with wraparound (more than K events of a node in one batch), duplicate
  times and padded events: every sample and the canonical ``state_dict``;
  a one-shard state loads under the mesh and the mesh's state loads on one
  device, and sampling continues identically;
* the sharded uniform sampler (``DeviceUniformSampler(mesh=)``), under the
  ``rows`` and ``degree`` partitions: the canonical CSR is bit-equal to the
  reference's, every sample to the port's one-device sampler (the draws
  are the port's own ``(seed, counter)`` generator's, not ``jax.random``'s,
  ROADMAP C), each valid prefix to the reference's, and a one-shard state
  loads and replays.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.core.device_sampler import DeviceRecencySampler as JaxRecency
from repro.core.device_uniform import DeviceUniformSampler as JaxUniform
from repro_torch.core import DeviceUniformSampler
from tests._torch_dist import run_world

N, K = 23, 4
SHARDS = (2, 3)


def _recency_payload():
    rng = np.random.default_rng(7)
    batches, seeds = [], []
    t0 = 0
    for i in range(5):
        B = 40
        # A few hot nodes: many events of one node per batch (wraparound).
        src = np.where(rng.random(B) < 0.4, rng.integers(0, 3, B),
                       rng.integers(0, N, B))
        dst = rng.integers(0, N, B)
        t = t0 + np.sort(rng.integers(0, 8, B))  # duplicate times
        t0 = int(t[-1])
        eids = np.arange(i * B, (i + 1) * B)
        valid = np.ones(B, bool)
        valid[-5:] = i % 2 == 0  # padded tail on odd batches
        batches.append((src, dst, t, eids, valid))
        seeds.append(rng.integers(0, N, 31))
    return {"N": N, "K": K, "batches": batches, "seeds": seeds}


def _uniform_payload():
    rng = np.random.default_rng(11)
    E = 300
    src = np.where(rng.random(E) < 0.5, rng.integers(0, 4, E),
                   rng.integers(0, N, E))  # a skewed graph
    dst = rng.integers(0, N, E)
    t = np.sort(rng.integers(0, 200, E))
    queries = [(rng.integers(0, N, 37), rng.integers(0, 220, 37))
               for _ in range(4)]
    return {"N": N, "K": K, "stream": (src, dst, t), "queries": queries}


@pytest.fixture(scope="module")
def reference():
    """The reference's recency samples and states, and its uniform CSR and
    prefixes; the port's one-device uniform sampler's samples."""
    rp = _recency_payload()
    ref = JaxRecency(N, K)
    samples, states = [], []
    for (src, dst, t, eids, valid), seeds in zip(rp["batches"], rp["seeds"]):
        ref.update(src, dst, t, eids, valid=valid)
        blk = ref.sample(seeds)
        samples.append({k: np.asarray(v) for k, v in zip(
            ("ids", "times", "eids", "mask"),
            (blk.nbr_ids, blk.nbr_times, blk.nbr_eids, blk.mask))})
        states.append(ref.state_dict())
    rp["state1"] = states[0]
    buffer_ids = np.asarray(ref.buffer_ids)  # the one-device rows at the end
    after = []  # the reference's first batch again from its end state
    (src, dst, t, eids, valid), seeds = rp["batches"][0], rp["seeds"][0]
    ref.update(src, dst, t, eids, valid=valid)
    blk = ref.sample(seeds)
    after.append({"ids": np.asarray(blk.nbr_ids), "times": np.asarray(blk.nbr_times),
                  "eids": np.asarray(blk.nbr_eids), "mask": np.asarray(blk.mask)})

    up = _uniform_payload()
    jref = JaxUniform(N, K, seed=3)
    jref.build(*up["stream"])
    one = DeviceUniformSampler(N, K, seed=3, device="cpu")
    one.build(*up["stream"])
    usamples = []
    for s, q in up["queries"]:
        blk = one.sample(s, q)
        usamples.append({k: v.numpy() for k, v in zip(
            ("ids", "times", "eids", "mask"),
            (blk.nbr_ids, blk.nbr_times, blk.nbr_eids, blk.mask))})
    fresh = DeviceUniformSampler(N, K, seed=3, device="cpu")
    fresh.build(*up["stream"])
    fresh.sample(*up["queries"][0])
    up["state1"] = fresh.state_dict()  # a one-shard state after one draw
    prefix = [tuple(x.numpy() for x in one.prefix(s, q))
              for s, q in up["queries"][:1]]
    return {"recency": rp, "samples": samples, "states": states,
            "after": after, "uniform": up, "uniform_state": jref.state_dict(),
            "usamples": usamples, "prefix": prefix, "buffer_ids": buffer_ids}


@pytest.fixture(scope="module", params=SHARDS)
def world(request, reference):
    """One world of ``shards`` ranks running both sampler programs."""
    payload = {"recency": reference["recency"], "uniform": reference["uniform"]}
    return request.param, run_world(["recency", "uniform"], request.param,
                                    payload)


def _assert_blocks(got, want, what):
    for key in ("ids", "times", "eids", "mask"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{what} {key}")


def test_recency_samples_and_state_are_bit_equal_to_the_reference(world, reference):
    shards, ranks = world
    for rank, res in enumerate(ranks):
        rec = res["recency"]
        assert rec["rows_per_shard"] == -(-N // shards)
        assert rec["block_rows"] == rec["rows_per_shard"] + 1
        for i, (got, want) in enumerate(zip(rec["samples"], reference["samples"])):
            _assert_blocks(got, want, f"rank {rank} batch {i}")
        for key, want in reference["states"][-1].items():
            np.testing.assert_array_equal(rec["state"][key], np.asarray(want),
                                          err_msg=key)


def test_recency_buffer_ids_are_each_ranks_block_of_the_reference_rows(world, reference):
    """On a mesh ``buffer_ids`` is this rank's block of id rows (its sink
    last): the owned rows equal the reference's one-device rows."""
    shards, ranks = world
    per = -(-N // shards)
    for res in ranks:
        rec = res["recency"]
        ids, lo = rec["buffer_ids"], rec["rank"] * per
        owned = max(min(lo + per, N) - lo, 0)
        assert ids.shape == (per + 1, K)
        np.testing.assert_array_equal(ids[:owned], reference["buffer_ids"][lo:lo + owned])


def test_recency_state_moves_between_one_shard_and_the_mesh(world, reference):
    shards, ranks = world
    rec = ranks[0]["recency"]
    # A one-shard state (the reference's, after batch 0) resumes on the mesh.
    for i, got in enumerate(rec["resumed"], start=1):
        _assert_blocks(got, reference["samples"][i], f"resumed batch {i}")
    # The mesh's canonical state resumes on one device, and on the mesh.
    _assert_blocks(rec["one_from_sharded"][0], reference["after"][0], "one device")
    _assert_blocks(rec["sharded_again"][0], reference["after"][0], "mesh")


@pytest.mark.parametrize("partition", ["rows", "degree"])
def test_uniform_csr_and_samples_are_bit_equal(world, reference, partition):
    shards, ranks = world
    want_state = reference["uniform_state"]
    for rank, res in enumerate(ranks):
        uni = res["uniform"][partition]
        for key in ("adj_nbr", "adj_t", "adj_e", "indptr"):
            np.testing.assert_array_equal(uni["state"][key],
                                          np.asarray(want_state[key]), err_msg=key)
        assert int(uni["state"]["counter"]) == len(reference["usamples"])
        for i, (got, want) in enumerate(zip(uni["samples"], reference["usamples"])):
            _assert_blocks(got, want, f"{partition} rank {rank} query {i}")
        for got, want in zip(uni["prefix"], reference["prefix"]):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        for i, got in enumerate(uni["resumed"], start=1):
            _assert_blocks(got, reference["usamples"][i], f"{partition} resumed {i}")


def test_partitions_cut_where_the_reference_cuts(world, reference):
    """The shard bounds of both partitions are the reference's
    ``_shard_bounds`` (the degree cut balances a skewed graph's edges)."""
    shards, ranks = world
    indptr = np.asarray(reference["uniform_state"]["indptr"], np.int64)
    for partition in ("rows", "degree"):
        want = JaxUniform._shard_bounds(
            type("S", (), {"_shards": shards, "num_nodes": N, "partition": partition,
                           "_per": -(-N // shards)})(), indptr)
        got = [ranks[r]["uniform"][partition]["bounds"] for r in range(shards)]
        assert [lo for lo, _ in got] == list(want[:-1])
        assert [hi for _, hi in got] == list(want[1:])
        L = max(int(indptr[hi] - indptr[lo]) for lo, hi in got)
        assert all(ranks[r]["uniform"][partition]["L"] == max(L, 1)
                   for r in range(shards))
