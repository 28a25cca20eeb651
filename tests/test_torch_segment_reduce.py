"""The port's segment sum (plain version and autograd function) holds
against the JAX op.

Inputs come from a numpy seed and go through both packages: the JAX
``segment_sum`` in ``mode="interpret"`` (the Pallas kernel body on the CPU,
as ``tests/kernels`` runs it) and ``segment_sum_ref``, and the port's
``segment_sum`` on CPU tensors (its plain version). The cases are the
reference harness's (``tests/kernels/families.py``, sorted ids with -1
padding) and the ones the GCN layer gives the kernel: unsorted ids, every id
the same, widths 1 and 33, 9,000 segments (above the TPU's 2,048 tile) and a
single edge. Tolerance f32 ``rtol=atol=2e-5`` forward; the gradient (the
reference's custom VJP, a gather) within 1e-4 of its largest entry. The
CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain version there. Here a numpy emulation of its index math
(the wrapper's tiling, each block's compaction of its ids in edge order,
each thread's run-in-register sum, the tile's write) is held to the plain
version's bits on CPU tensors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import segment_sum as jax_segment_sum
from repro.kernels.segment_reduce import segment_sum_ref as jax_segment_sum_ref
from repro_torch.kernels.segment_reduce import (
    segment_sum,
    segment_sum_kernel,
    segment_sum_ref,
)
from repro_torch.kernels.segment_reduce import ops
from repro_torch.kernels.segment_reduce.kernel import COLS, segment_tiles

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_RTOL = 1e-4


def _case(seed, E, D, G, *, ids="sorted", pad=True, block_e=128):
    """(data (E, D) f32, ids (E,) int32, G, block_e) from a numpy seed."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((E, D)).astype(np.float32)
    lo = -1 if pad else 0
    if ids == "equal":
        seg = np.full(E, G // 2, dtype=np.int32)
    else:
        seg = rng.integers(lo, G, E).astype(np.int32)
        if ids == "sorted":
            seg = np.sort(seg)
    return data, seg, G, block_e


CASES = {
    # tests/kernels/families.py: SEGMENT_SUM cases
    "e500": (0, 500, 16, 64),
    "e1000": (1, 1000, 64, 128, dict(block_e=256)),
    "e77_small": (2, 77, 8, 16, dict(block_e=32)),
    "e512_d128": (3, 512, 128, 256),
    # what the GCN layer gives the kernel
    "unsorted": (4, 256, 64, 300, dict(ids="unsorted")),
    "all_equal": (5, 256, 64, 300, dict(ids="equal")),
    "d1": (6, 256, 1, 300, dict(ids="unsorted")),
    "d33": (7, 200, 33, 300, dict(ids="unsorted")),
    "g9000": (8, 256, 64, 9000, dict(ids="unsorted")),
    "e1": (9, 1, 64, 9000, dict(ids="unsorted", pad=False)),
}


def _build(name):
    seed, E, D, G, *kw = CASES[name]
    return _case(seed, E, D, G, **(kw[0] if kw else {}))


@pytest.mark.parametrize("jax_mode", ["interpret", "ref"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_sum_matches_jax(name, jax_mode):
    data, seg, G, block_e = _build(name)
    if jax_mode == "ref":
        # The oracle drops -1 ids as jax.ops.segment_sum drops any id out of
        # range.
        want = jax_segment_sum_ref(jnp.asarray(data), jnp.asarray(seg), G)
    else:
        want = jax_segment_sum(jnp.asarray(data), jnp.asarray(seg), G,
                               block_e=block_e, mode="interpret")
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(seg), G)
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, data.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dropped_ids_and_empty_segments_are_exact():
    data, seg, G, _ = _build("unsorted")
    seg[:40] = -1
    seg[40:50] = G + 3  # out of range: dropped, as jax.ops.segment_sum does
    got = segment_sum_ref(torch.from_numpy(data), torch.from_numpy(seg), G)
    empty = np.setdiff1d(np.arange(G), seg)
    assert (got[torch.from_numpy(empty)] == 0).all()
    keep = (seg >= 0) & (seg < G)
    want = np.zeros((G, data.shape[1]), np.float32)
    np.add.at(want, seg[keep], data[keep])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["e500", "e77_small", "unsorted", "d1", "g9000"])
def test_gradient_matches_the_custom_vjp(name, monkeypatch):
    """The port's autograd function (forward: the plain version standing in
    for the kernel; backward: the gather) and plain autograd of the plain
    version both give the reference's custom-VJP gradient."""
    data, seg, G, block_e = _build(name)
    rng = np.random.default_rng(11)
    cot = rng.standard_normal((G, data.shape[1])).astype(np.float32)

    def jax_loss(x):
        out = jax_segment_sum(x, jnp.asarray(seg), G, block_e=block_e,
                              mode="interpret")
        return jnp.sum(out * cot)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(data)))

    monkeypatch.setattr(ops, "_FWD", segment_sum_ref)
    for fn in (lambda x: ops._SegmentSumFn.apply(x, torch.from_numpy(seg), G),
               lambda x: segment_sum(x, torch.from_numpy(seg), G)):
        x = torch.from_numpy(data).requires_grad_(True)
        (fn(x) * torch.from_numpy(cot)).sum().backward()
        atol = GRAD_RTOL * float(np.abs(want).max())
        np.testing.assert_allclose(x.grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=atol)
        assert (x.grad[torch.from_numpy(seg) < 0] == 0).all()


def test_kernel_mode_and_kernel_refuse_cpu_tensors():
    data = torch.zeros(4, 2)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum(data, ids, 3, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum_kernel(data, ids, 3)
    with pytest.raises(ValueError, match="unknown kernel dispatch mode"):
        segment_sum(data, ids, 3, mode="interpret")


def test_ref_mode_is_the_plain_version():
    data, seg, G, _ = _build("d33")
    a = segment_sum(torch.from_numpy(data), torch.from_numpy(seg), G, mode="ref")
    b = segment_sum_ref(torch.from_numpy(data), torch.from_numpy(seg), G)
    assert torch.equal(a, b)


THREADS, WARPS, ROUND, STAGE = 256, 8, 2048, 128


def _emulate_kernel(data, seg, G):
    """The CUDA kernel's index math in numpy, float32 throughout: for each
    block of ``segment_tiles``' grid, the ids of each round of 2,048 that
    fall in its tile, placed by the warp ballots' counts and their block
    scan; then, stage by 128-edge stage, each warp (the segments ``own`` =
    segment % 8) walking its own edges in order, its lanes the columns, a
    run into one segment summed in a register started from the
    accumulator; then the tile written whole. Returns the (G, D) output and
    the largest list a block walked."""
    E, D = data.shape
    C = COLS
    TG, gx, gy = segment_tiles(D, G)
    assert TG % 4 == 0 and TG * C <= 4096
    lanes = THREADS // C
    out = np.full((G, D), np.nan, np.float32)
    longest = 0
    for bx in range(gx):
        g0, g_end = bx * TG, min(G, (bx + 1) * TG)
        for by in range(gy):
            d0 = by * C
            cols = min(C, D - d0)
            acc = np.zeros((TG, C), np.float32)
            cur = np.full(lanes, -1)
            run = np.zeros((lanes, C), np.float32)
            for base in range(0, E, ROUND):
                e = base + np.arange(ROUND)
                ids = np.where(e < E, seg[np.minimum(e, max(E - 1, 0))] if E else -1, -1)
                keep = ((ids >= g0) & (ids < g_end)).reshape(ROUND // THREADS, WARPS, 32)
                counts = keep.sum(-1).ravel()
                rank = (np.cumsum(counts) - counts).reshape(keep.shape[:2])
                pos = rank[..., None] + np.cumsum(keep, -1) - keep
                listed = np.full(int(counts.sum()), -1)
                listed[pos[keep]] = e.reshape(keep.shape)[keep]
                assert (np.diff(listed) > 0).all()  # edge order
                longest = max(longest, listed.size)
                for s0 in range(0, listed.size, STAGE):
                    staged = np.zeros((STAGE, C), np.float32)
                    chunk = listed[s0:s0 + STAGE]
                    staged[:chunk.size, :cols] = data[chunk, d0:d0 + cols]
                    for j, edge in enumerate(chunk):
                        gl = int(seg[edge]) - g0
                        own = gl & (lanes - 1)
                        if gl != cur[own]:
                            if cur[own] >= 0:
                                acc[cur[own]] = run[own]
                            cur[own] = gl
                            run[own] = acc[gl]
                        run[own] = run[own] + staged[j]
            for own in range(lanes):
                if cur[own] >= 0:
                    acc[cur[own]] = run[own]
            out[g0:g_end, d0:d0 + cols] = acc[:g_end - g0, :cols]
    return out, longest


# (seed, E, D, G, ids): what the emulation is held on.
EMULATION_CASES = {
    "unsorted": (20, 256, 64, 9000, "unsorted"),
    "padding_run": (21, 3000, 64, 9000, "padding"),
    "all_equal": (22, 300, 33, 300, "equal"),
    "out_of_range": (23, 500, 64, 9000, "out_of_range"),
    "e0": (24, 0, 64, 9000, "unsorted"),
    "e1": (25, 1, 64, 9000, "unsorted"),
    "d1": (26, 2048, 1, 9000, "padding"),
    "d33": (27, 400, 33, 9000, "unsorted"),
    "g5": (28, 300, 3, 5, "unsorted"),
}


@pytest.mark.parametrize("name", sorted(EMULATION_CASES))
def test_kernel_index_math_matches_the_plain_version_bitwise(name):
    """Every output element written, each the edge-order float32 sum of its
    segment's rows: the plain version's bits (the CPU's ``index_add_``)."""
    seed, E, D, G, kind = EMULATION_CASES[name]
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((E, D)).astype(np.float32)
    if kind == "equal":
        seg = np.full(E, 7, np.int32)
    elif kind == "out_of_range":
        seg = rng.integers(-5, G + 50, E).astype(np.int32)
    else:
        seg = rng.integers(-1 if kind == "unsorted" else 0, G, E).astype(np.int32)
    if kind == "padding":  # a snapshot's padding: id 0, zero rows, at the end
        n_pad = E // 3
        seg[-n_pad:] = 0
        data[-n_pad:] = 0.0
    got, longest = _emulate_kernel(data, seg, G)
    want = segment_sum_ref(torch.from_numpy(data), torch.from_numpy(seg), G).numpy()
    assert not np.isnan(got).any()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    if kind == "padding":  # the padding tile's list spans several stages
        assert longest > STAGE


def test_kernel_tiles_cover_the_output():
    for D, G in ((1, 9000), (64, 9000), (33, 300), (3, 5), (128, 1), (1, 1)):
        TG, gx, gy = segment_tiles(D, G)
        assert gx * TG >= G > (gx - 1) * TG and gy * COLS >= D > (gy - 1) * COLS
    # the hourly and daily sums (G = 9,000; D = 64 and 1) fill the 132 SMs
    assert np.prod(segment_tiles(64, 9000)[1:]) >= 132
    assert np.prod(segment_tiles(1, 9000)[1:]) >= 132
