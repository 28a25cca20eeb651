"""Parity of the port's SSD chunk scan (K6) with the reference, on the CPU.

* The port's ``ref.py::ssd_ref`` (the exact recurrence) against the
  reference's, ``y`` and the final state, at the reference harness's four
  cases (``tests/kernels/families.py:296-299``): float32, 2e-5.
* The reference's Pallas kernel in interpret mode against the port's
  ``ops.ssd`` on a CPU tensor (the recurrence), at ``_SSD_TOL`` 1e-3: the
  bound the reference documents for a chunked scan against the sequential
  one.
* The port's batched, grouped op (``ssd_chunk_scan``, K6's contract; its
  plain version on the CPU) against the reference model's
  ``layers.ssd_mix(return_state=True)`` at B = 2 with one and two groups,
  and against the recurrence per head, with ``dt = 0`` rows at the end.
* ``ssd_chunk_ref`` at the bfloat16 kernel's chunk (128) and in its three
  passes, against the recurrence and the reference's Pallas kernel in
  interpret mode (chunk 128): S in {1, 127, 128, 129, 300}, one and two
  groups, and steep decay (the inclusive sum of dt a below -88 inside a
  chunk: finite, equal to the recurrence); the earlier form (decays from
  differences of running sums) missing the recurrence under steep decay.
* A numpy mirror of the bfloat16 kernel (``_emulate_kernel``): its grid
  (``kernel.py::chunk_plan``), its passes, its float32 operands split into
  two bfloat16 terms and the state's [8 x hi | 8 x lo] layout, held
  against the plain version.
* The backward (K6b): its plain version ``ssd_chunk_bwd_ref`` against
  ``jax.vjp`` of the reference model's ``ssd_mix`` in float32 (each
  gradient within 1e-4 of its largest entry) and against torch autograd
  of ``ssd_chunk_ref`` in float64, at S = 1, 37, 256 and 300, one and two
  groups, P 48 and 64, N 16, 24 and 128, zero-dt rows, steep decay and a
  final-state cotangent; ``kernel.bwd_plan``'s grids, ring and scratch; a
  numpy mirror of the bfloat16 K6b's roundings (``_emulate_bwd``: K6's
  states kept split, the reverse pass's bf16 images, W and R rounded once,
  x and dy scaled then rounded) held against the plain backward; the six
  TMA maps of its chunk pass against a numpy TMA emulation; the autograd
  seam (a gradient call runs K6, keeping its chunk states, then K6b on
  them; a call without one K6 alone, keeping nothing; under checkpointing
  the recompute's states reach K6b), with the plain versions stood in.

The CUDA kernels run only on the card (``chip_smoke.py``'s ``lm_kernels``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.kernels.ssd_chunk import ssd as jax_ssd
from repro.kernels.ssd_chunk.ref import ssd_ref as jax_ssd_ref
from repro.models.lm import layers as JL
from repro_torch.kernels.ssd_chunk import (
    ssd,
    ssd_chunk_bwd_kernel,
    ssd_chunk_bwd_ref,
    ssd_chunk_kernel,
    ssd_chunk_ref,
    ssd_chunk_scan,
    ssd_chunk_states_ref,
    ssd_ref,
)
from repro_torch.kernels.ssd_chunk.kernel import (
    CHUNK,
    CHUNK_F32,
    DOT_PARTS,
    HEADS_PER_BLOCK,
    TAB,
    bwd_maps,
    bwd_plan,
    chunk_plan,
    tma_operand,
    tma_ready,
)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
SSD_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/kernels/families.py::_SSD_TOL
# Chunked float32 scans of different chunk lengths against each other and
# against the recurrence: only the association of the sums differs (max
# |err| measured 3.8e-6 on these inputs).
CHUNKED_TOL = dict(rtol=1e-4, atol=1e-4)

# (name, S, H, P, N, chunk): families.py:296-299
CASES = [
    ("s64", 64, 2, 16, 32, 16),
    ("s100_unaligned", 100, 4, 32, 64, 32),
    ("single_chunk", 96, 1, 8, 16, 96),
    ("s128_wide", 128, 2, 64, 128, 128),
]
IDS = [c[0] for c in CASES]


def _single(case, seed=0):
    """The family's inputs (x, softplus dt, negative a, B, C) as numpy."""
    _, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, H, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((S, H))))
    a = -np.exp(rng.standard_normal(H) * 0.3)
    B = rng.standard_normal((S, H, N)) * 0.5
    C = rng.standard_normal((S, H, N)) * 0.5
    return [np.asarray(v, np.float32) for v in (x, dt, a, B, C)]


def _batched(Bsz, S, H, G, P, N, seed=0, pad_rows=0, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, H, P)) * 0.5
    dt = dt_scale * np.log1p(np.exp(rng.standard_normal((Bsz, S, H))))
    if pad_rows:
        dt[:, S - pad_rows:] = 0.0  # padded steps: decay 1, no input
    a = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((Bsz, S, G, N)) * 0.5
    Cm = rng.standard_normal((Bsz, S, G, N)) * 0.5
    return [np.asarray(v, np.float32) for v in (x, dt, a, Bm, Cm)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ssd_ref_matches_reference_oracle(case):
    args = _single(case)
    wy, ws = jax_ssd_ref(*map(jnp.asarray, args))
    ty, ts = ssd_ref(*map(torch.as_tensor, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(wy), **F32_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), **F32_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_auto_on_cpu_matches_reference_kernel_in_interpret_mode(case):
    args = _single(case, seed=1)
    want = jax_ssd(*map(jnp.asarray, args), chunk=case[-1], mode="interpret")
    got = ssd(*map(torch.as_tensor, args), mode="auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_batched_op_matches_reference_ssd_mix(groups):
    """K6's plain version against the reference model's mixer (float32,
    chunk 16 there, the port's own chunk here), y and final state."""
    cfg = ARCHS["hymba-1.5b"].reduced()
    args = _batched(2, 40, 4, groups, 16, 16, seed=groups)
    jy, js = JL.ssd_mix(cfg, *map(jnp.asarray, args), chunk=16, return_state=True)
    ty, ts = ssd_chunk_scan(*map(torch.as_tensor, args), mode="auto")
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (2, 4, 16, 16)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **CHUNKED_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **CHUNKED_TOL)


@pytest.mark.parametrize("chunk", [1, 7, 32, 64])
def test_chunk_ref_matches_the_recurrence_per_head(chunk):
    """Groups broadcast to heads, zero-dt padding rows keep the state."""
    x, dt, a, Bm, Cm = map(torch.as_tensor, _batched(2, 50, 6, 3, 8, 16, pad_rows=9))
    y, st = ssd_chunk_ref(x, dt, a, Bm, Cm, chunk=chunk)
    for b in range(2):
        wy, ws = ssd_ref(x[b], dt[b], a, Bm[b].repeat_interleave(2, 1),
                         Cm[b].repeat_interleave(2, 1))
        np.testing.assert_allclose(y[b].numpy(), wy.numpy(), **CHUNKED_TOL)
        np.testing.assert_allclose(st[b].numpy(), ws.numpy(), **CHUNKED_TOL)
    # the last 9 steps add nothing: the state after step S - 10, decayed by 1
    _, st_short = ssd_chunk_ref(x[:, :41], dt[:, :41], a, Bm[:, :41], Cm[:, :41],
                                chunk=chunk)
    np.testing.assert_allclose(st.numpy(), st_short.numpy(), **CHUNKED_TOL)


def test_bf16_input_keeps_its_dtype_and_float32_state():
    x, dt, a, Bm, Cm = map(torch.as_tensor, _batched(1, 33, 2, 1, 8, 16))
    y, st = ssd_chunk_scan(x.bfloat16(), dt, a, Bm.bfloat16(), Cm.bfloat16(),
                           mode="ref")
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    y32, _ = ssd_chunk_scan(x.bfloat16().float(), dt, a, Bm.bfloat16().float(),
                            Cm.bfloat16().float(), mode="ref")
    np.testing.assert_allclose(y.float().numpy(), y32.numpy(), rtol=2e-2, atol=2e-2)


def test_kernel_mode_raises_on_cpu():
    args = list(map(torch.as_tensor, _batched(1, 8, 2, 1, 8, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_scan(*args, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_kernel(*args)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_bwd_kernel(*args, args[0])
    single = list(map(torch.as_tensor, _single(CASES[0])))
    with pytest.raises(ValueError, match="CUDA"):
        ssd(*single, mode="kernel")


def _per_row(args, b, G, H):
    """Batch row b of batched inputs in the single-sequence signature (B
    and C broadcast from groups to heads)."""
    x, dt, a, Bm, Cm = args
    rep = H // G
    return (x[b], dt[b], a, np.repeat(Bm[b], rep, axis=1),
            np.repeat(Cm[b], rep, axis=1))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 300])
def test_chunk_ref_at_kernel_chunk_matches_recurrence_and_reference_kernel(S, groups):
    args = _batched(2, S, 4, groups, 16, 16, seed=S + groups)
    y, st = ssd_chunk_ref(*map(torch.as_tensor, args))  # chunk 128, the kernel's
    assert CHUNK == 128
    for b in range(2):
        row = _per_row(args, b, groups, 4)
        wy, ws = ssd_ref(*map(torch.as_tensor, row))
        np.testing.assert_allclose(y[b].numpy(), wy.numpy(), **CHUNKED_TOL)
        np.testing.assert_allclose(st[b].numpy(), ws.numpy(), **CHUNKED_TOL)
        jy = jax_ssd(*map(jnp.asarray, row), chunk=CHUNK, mode="interpret")
        np.testing.assert_allclose(y[b].numpy(), np.asarray(jy), **SSD_TOL)


def test_chunk_ref_steep_decay_is_finite_and_equals_the_recurrence():
    """dt ten times the usual: the inclusive sum of dt a passes -88 (where
    exp overflows float32 once negated) within the first chunk."""
    args = _batched(2, 300, 4, 2, 16, 16, seed=7, dt_scale=10.0)
    x, dt, a = args[:3]
    assert np.cumsum(dt[:, :CHUNK] * a, axis=1).min() < -88.0
    y, st = ssd_chunk_ref(*map(torch.as_tensor, args))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    for b in range(2):
        row = _per_row(args, b, 2, 4)
        wy, ws = jax_ssd_ref(*map(jnp.asarray, row))
        np.testing.assert_allclose(y[b].numpy(), np.asarray(wy), **CHUNKED_TOL)
        np.testing.assert_allclose(st[b].numpy(), np.asarray(ws), **CHUNKED_TOL)
        jy = jax_ssd(*map(jnp.asarray, row), chunk=CHUNK, mode="interpret")
        np.testing.assert_allclose(y[b].numpy(), np.asarray(jy), **SSD_TOL)


def _running_sum_difference_ref(x, dt, a, Bm, Cm, chunk):
    """The earlier form of ``ssd_chunk_ref``: one chunk at a time, each
    in-chunk decay exp(cum_i - cum_j) from the difference of two running
    sums of dt a."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = H // G
    xf, dtf = x.reshape(Bsz, S, G, Hg, P), dt.reshape(Bsz, S, G, Hg)
    af = a.reshape(G, Hg)
    state = torch.zeros((Bsz, G, Hg, P, N))
    ys = []
    for t0 in range(0, S, chunk):
        xc, dtc = xf[:, t0:t0 + chunk], dtf[:, t0:t0 + chunk]
        Bc, Cc = Bm[:, t0:t0 + chunk], Cm[:, t0:t0 + chunk]
        Q = xc.shape[1]
        cum = torch.cumsum(dtc * af, dim=1)                     # (b, Q, g, h)
        low = torch.tril(torch.ones((Q, Q), dtype=torch.bool))[None, :, :, None, None]
        diff = cum[:, :, None] - cum[:, None, :]                # (b, i, j, g, h)
        L = torch.where(low, torch.exp(torch.where(low, diff, torch.zeros_like(diff))),
                        torch.zeros_like(diff))
        scores = torch.einsum("bign,bjgn->bijg", Cc, Bc)
        xdt = xc * dtc[..., None]
        y_diag = torch.einsum("bijgh,bjghp->bighp", scores[..., None] * L, xdt)
        y_off = torch.einsum("bign,bghpn->bighp", Cc, state) * torch.exp(cum)[..., None]
        ys.append(y_diag + y_off)
        to_end = torch.exp(cum[:, -1:] - cum)
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bjghp,bjgn->bghpn", to_end[..., None] * xdt, Bc))
    return torch.cat(ys, dim=1).reshape(Bsz, S, H, P), state.reshape(Bsz, H, P, N)


@pytest.mark.parametrize("shape,seed", [((1, 300, 4, 1, 16, 16), 1),
                                        ((2, 300, 4, 2, 16, 16), 7)])
def test_running_sum_difference_misses_the_recurrence_under_steep_decay(shape, seed):
    """Why ``ssd_chunk_ref`` sums each in-chunk decay on its own: at chunk
    128, dt ten times the usual and the model's decay rate (a = -exp(1 +
    0.3 N(0, 1)), as the card's checks draw it), cum reaches the thousands
    and the difference of two running sums loses |cum| ulps, so the earlier
    form misses the recurrence by more than CHUNKED_TOL; the current form
    holds it."""
    Bsz, S, H, G, P, N = shape
    args = _batched(*shape, seed=seed, dt_scale=10.0)
    args[2] = args[2] * np.float32(np.e)
    assert np.cumsum(args[1][:, :CHUNK] * args[2], axis=1).min() < -1000.0
    old_y, _ = _running_sum_difference_ref(*map(torch.as_tensor, args), chunk=CHUNK)
    y, st = ssd_chunk_ref(*map(torch.as_tensor, args))
    missed = False
    for b in range(Bsz):
        wy, ws = map(np.asarray, jax_ssd_ref(*map(jnp.asarray, _per_row(args, b, G, H))))
        missed |= not np.allclose(old_y[b].numpy(), wy, **CHUNKED_TOL)
        np.testing.assert_allclose(y[b].numpy(), wy, **CHUNKED_TOL)
        np.testing.assert_allclose(st[b].numpy(), ws, **CHUNKED_TOL)
    assert missed


# (Bsz, S, H, G, P, N): the LM shapes (hymba, mamba2, hymba's 32k prefill)
# and small ones down to a single chunk and block.
PLAN_SHAPES = [(4, 4096, 50, 1, 64, 16), (4, 4096, 48, 1, 64, 128),
               (1, 32768, 50, 1, 64, 16), (2, 1, 50, 1, 64, 16),
               (2, 300, 8, 2, 32, 64), (1, 200, 6, 3, 36, 20)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_chunk_plan_covers_every_chunk_and_head_once(shape):
    Bsz, S, H, G, P, N = shape
    plan = chunk_plan(*shape)
    nc, per, tiles = plan["chunks"], plan["heads_per_block"], plan["head_tiles"]
    assert nc * CHUNK >= S > (nc - 1) * CHUNK
    assert per == HEADS_PER_BLOCK
    Hg = H // G
    seen = np.zeros((Bsz, nc, H), np.int64)
    for z in range(Bsz * G):       # the output pass's grid, as the kernel walks it
        b, g = divmod(z, G)
        for ht in range(tiles):
            h0, nh = g * Hg + ht * per, min(per, Hg - ht * per)
            assert nh >= 1
            seen[b, :, h0:h0 + nh] += 1
    assert (seen == 1).all()
    P16, N16 = plan["scratch"][3:]
    assert plan["scratch"][:3] == (Bsz, nc, H) == plan["decay"]
    assert P16 % 16 == 0 and N16 % 16 == 0 and P <= P16 < P + 16 and N <= N16 < N + 16


def _bf16(a):
    """Round float32 values to bfloat16 (nearest even) and back."""
    return torch.as_tensor(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _split(a):
    """A float32 operand as the kernel feeds it: two bfloat16 terms."""
    hi = _bf16(a)
    return hi, _bf16(a - hi)


def _tile(t, b, t0, rows, cols, g=None, h=None):
    """Rows t0 .. t0 + rows of (b, group g or head h) of a (Bsz, S, ., n)
    array as a (CHUNK, cols) float64 tile, zeros past the rows and columns."""
    out = np.zeros((CHUNK, cols), np.float64)
    v = t[b, t0:t0 + rows, g if h is None else h]
    out[:rows, :v.shape[-1]] = v
    return out


def _cumsum2(dt, a, b, t0, rows, h):
    """A chunk's inclusive sum of dt a in log2 units (float32) and its dt."""
    d = np.zeros(CHUNK, np.float32)
    d[:rows] = dt[b, t0:t0 + rows, h]
    return np.cumsum(d * np.float32(a[h])) * np.float32(1.4426950408889634), d


def _emulate_states(x, dt, a, Bm):
    """K6's passes 1-2 as ``_emulate_kernel`` mirrors them: each chunk's
    own end state from zero with wk o x in two bf16 terms, then the state
    entering each chunk in float32, kept split into its bf16 terms. Returns
    (hi, lo) (Bsz, nc, H, P16, N16), the chunk decays (Bsz, nc, H) and the
    final state (Bsz, H, P16, N16)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    Hg = H // G
    plan = chunk_plan(Bsz, S, H, G, P, N)
    nc = plan["chunks"]
    _, _, _, P16, N16 = plan["scratch"]
    scratch = np.zeros(plan["scratch"], np.float64)
    decay = np.zeros(plan["decay"], np.float64)
    for b in range(Bsz):                                   # pass 1
        for c in range(nc):
            t0 = c * CHUNK
            rows = min(CHUNK, S - t0)
            for h in range(H):
                cum2, d = _cumsum2(dt, a, b, t0, rows, h)
                wk = d * np.exp2(cum2[-1] - cum2)
                hi, lo = _split(_tile(x, b, t0, rows, P16, h=h) * wk[:, None])
                bt = _tile(Bm, b, t0, rows, N16, g=h // Hg)
                scratch[b, c, h] = hi.T.astype(np.float64) @ bt + lo.T.astype(np.float64) @ bt
                decay[b, c, h] = np.exp2(cum2[-1])
    s_hi = np.zeros(plan["scratch"], np.float32)            # pass 2
    s_lo = np.zeros(plan["scratch"], np.float32)
    state = np.zeros((Bsz, H, P16, N16))
    for b in range(Bsz):
        for h in range(H):
            s = np.zeros((P16, N16), np.float32)
            for c in range(nc):
                s_hi[b, c, h], s_lo[b, c, h] = _split(s)
                s = (np.float32(decay[b, c, h]) * s + scratch[b, c, h]).astype(np.float32)
            state[b, h] = s
    return s_hi, s_lo, decay, state


def _emulate_kernel(x, dt, a, Bm, Cm):
    """numpy mirror of ``csrc/ssd_chunk.cu``'s bfloat16 path, pass by pass:
    chunk states from zero with wk o x in two bf16 terms; the state pass
    writing each incoming state as [8 x hi | 8 x lo] groups in the slot of
    its float32 entries; the output over ``chunk_plan``'s head tiles with
    C B^T once per tile, W in two terms and C s_in^T as C with each group
    of 8 columns repeated against that layout. Decays are exp2 of
    log2-scaled sums <= 0, split at each k tile's last row below the
    diagonal tile. Products accumulate in float64 (the tensor cores'
    float32 sums differ only in rounding)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    Hg = H // G
    plan = chunk_plan(Bsz, S, H, G, P, N)
    nc, per, tiles = plan["chunks"], plan["heads_per_block"], plan["head_tiles"]
    _, _, _, P16, N16 = plan["scratch"]
    tile = _tile

    def cumsum2(b, t0, rows, h):
        return _cumsum2(dt, a, b, t0, rows, h)

    hi, lo, _, state = _emulate_states(x, dt, a, Bm)
    s_in = np.zeros((Bsz, nc, H, P16, 2 * N16))
    for q in range(N16 // 8):  # the [8 x hi | 8 x lo] layout
        s_in[..., 16 * q:16 * q + 8] = hi[..., 8 * q:8 * q + 8]
        s_in[..., 16 * q + 8:16 * q + 16] = lo[..., 8 * q:8 * q + 8]
    y = np.zeros((Bsz, S, H, P), np.float32)                # pass 3
    low = np.tril(np.ones((CHUNK, CHUNK), bool))
    tile_of = np.arange(CHUNK) // 16
    for z in range(Bsz * G):
        b, g = divmod(z, G)
        for c in range(nc):
            t0 = c * CHUNK
            rows = min(CHUNK, S - t0)
            ct = tile(Cm, b, t0, rows, N16, g=g)
            scores = ct @ tile(Bm, b, t0, rows, N16, g=g).T
            c_rep = np.repeat(ct.reshape(CHUNK, N16 // 8, 1, 8), 2, axis=2).reshape(CHUNK, 2 * N16)
            for ht in range(tiles):
                for h in range(g * Hg + ht * per, g * Hg + min(Hg, (ht + 1) * per)):
                    cum2, d = cumsum2(b, t0, rows, h)
                    # L o dt: on a diagonal 16 x 16 tile exp2(c_i - c_j) dt_j;
                    # below it exp2(c_i - c_r) (exp2(c_r - c_j) dt_j), r the
                    # k tile's last row
                    cr = cum2[(np.arange(CHUNK) // 16) * 16 + 15]
                    u = np.exp2(np.minimum(cum2[:, None] - cr[None, :], 0.0))
                    v = np.exp2(cr - cum2) * d
                    diff = np.where(low, cum2[:, None] - cum2[None, :], 0.0)
                    on_tile = low & (tile_of[:, None] == tile_of[None, :])
                    below = tile_of[:, None] > tile_of[None, :]
                    dec = np.where(below, u * v[None, :],
                                   np.where(on_tile, np.exp2(diff) * d[None, :], 0.0))
                    hi, lo = _split(scores * dec)
                    xt = tile(x, b, t0, rows, P16, h=h)
                    acc = hi.astype(np.float64) @ xt + lo.astype(np.float64) @ xt
                    if c > 0:
                        acc += np.exp2(cum2)[:, None] * (c_rep @ s_in[b, c, h].T)
                    y[b, t0:t0 + rows, h] = acc[:rows, :P]
    return _bf16(y), state[:, :, :P, :N].astype(np.float32)


EMULATE_CASES = [  # (name, Bsz, S, H, G, P, N, dt_scale)
    ("s1", 2, 1, 4, 1, 16, 16, 1.0),
    ("s129_n128", 1, 129, 3, 1, 16, 128, 1.0),
    ("s300_two_groups", 2, 300, 4, 2, 16, 32, 1.0),
    ("p36_n20_three_groups", 1, 200, 6, 3, 36, 20, 1.0),
    ("steep_decay", 1, 260, 4, 1, 16, 16, 10.0),
]


@pytest.mark.parametrize("case", EMULATE_CASES, ids=[c[0] for c in EMULATE_CASES])
def test_kernel_mirror_matches_the_plain_version(case):
    """The mirror on bfloat16 inputs against ``ssd_chunk_ref`` on the same
    values: y within the bf16 tolerance (the kernel's output is bf16), the
    final state within SSD_TOL of its largest entry (as on the card)."""
    _, Bsz, S, H, G, P, N, dt_scale = case
    x, dt, a, Bm, Cm = _batched(Bsz, S, H, G, P, N, seed=S, dt_scale=dt_scale)
    x, Bm, Cm = _bf16(x), _bf16(Bm), _bf16(Cm)
    y, st = _emulate_kernel(x, dt, a, Bm, Cm)
    wy, wst = ssd_chunk_ref(*map(torch.as_tensor, (x, dt, a, Bm, Cm)))
    assert np.isfinite(y).all() and np.isfinite(st).all()
    np.testing.assert_allclose(y, wy.numpy(), rtol=2e-2, atol=2e-2)
    scale = np.abs(wst.numpy()).max()
    assert np.abs(st - wst.numpy()).max() <= 1e-3 * scale


def _kernel_stubs(monkeypatch):
    """Record-keeping plain versions stood in for K6 and K6b, and the kernel
    path taken for every mode but "ref" (on the CPU)."""
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.models.lm import layers as lm_layers

    calls = []

    def fwd(x, dt, a, Bm, Cm, keep=False):
        calls.append("K6")
        out = ssd_chunk_ref(x, dt, a, Bm, Cm)
        return (*out, None) if keep else out  # float32: K6 keeps no states

    def bwd(*args, kept=None):
        calls.append("K6b")
        return ssd_chunk_bwd_ref(*args)

    monkeypatch.setattr(ssd_ops, "use_kernel", lambda mode, x: mode != "ref")
    monkeypatch.setattr(lm_layers, "use_kernel", lambda mode, x: mode != "ref")
    monkeypatch.setattr(ssd_ops, "_FWD", fwd)
    monkeypatch.setattr(ssd_ops, "_BWD", bwd)
    return calls


def test_a_gradient_call_goes_through_k6_and_k6b(monkeypatch):
    """On the kernel path a call that needs a gradient runs K6 then, in the
    backward, K6b once (the plain versions stood in), and its gradients are
    those of autograd through the plain version; the final state's
    cotangent reaches K6b when the state is used. A call without a
    gradient is one K6 launch."""
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    calls = _kernel_stubs(monkeypatch)
    args = [torch.as_tensor(v) for v in _batched(2, 40, 4, 2, 8, 16, seed=2, pad_rows=5)]
    rng = np.random.default_rng(3)
    dy = torch.as_tensor(rng.standard_normal((2, 40, 4, 8)).astype(np.float32))
    ds = torch.as_tensor(rng.standard_normal((2, 4, 8, 16)).astype(np.float32))
    for use_state in (False, True):
        calls.clear()
        leaves = [t.clone().requires_grad_() for t in args]
        y, st = ssd_ops.ssd_chunk_scan(*leaves)
        assert calls == ["K6"] and type(y.grad_fn).__name__ == "_SSDChunkFnBackward"
        outs, cots = ([y, st], [dy, ds]) if use_state else ([y], [dy])
        got = torch.autograd.grad(outs, leaves, cots)
        assert calls == ["K6", "K6b"]
        ref_leaves = [t.clone().requires_grad_() for t in args]
        ry, rst = ssd_ops.ssd_chunk_scan(*ref_leaves, mode="ref")
        want = torch.autograd.grad([ry, rst] if use_state else [ry], ref_leaves, cots)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4 * float(w.abs().max()))
    calls.clear()
    with torch.no_grad():
        ssd_ops.ssd_chunk_scan(*leaves)
    ssd_ops.ssd_chunk_scan(*args)
    x, dt, a, bm, cm = args
    ssd_ops.ssd(x[0], dt[0], a, bm[0].repeat_interleave(2, 1), cm[0].repeat_interleave(2, 1))
    assert calls == ["K6"] * 3
    xs = x[0].clone().requires_grad_()
    ssd_ops.ssd(xs, dt[0], a, bm[0].repeat_interleave(2, 1),
                cm[0].repeat_interleave(2, 1)).sum().backward()
    assert calls == ["K6"] * 4 + ["K6b"] and xs.grad is not None


def test_a_gradient_call_on_the_kernel_path_raises(monkeypatch):
    """The one call that still raises on the kernel path: the mixer with an
    initial state (K6 and K6b start from zeros, as the prefill and the
    training step do), with or without a gradient; the model's mixer
    itself trains through K6 and K6b, equal to the plain mixer's gradient."""
    from repro_torch.configs import ARCHS as TARCHS
    from repro_torch.models.lm import layers as lm_layers
    from repro_torch.models.lm.params import materialize

    calls = _kernel_stubs(monkeypatch)
    cfg = TARCHS["mamba2-780m"].reduced()
    x, dt, a, bm, cm = (torch.as_tensor(v) for v in _batched(1, 16, 4, 1, 8, 16, seed=4))
    init = torch.zeros((1, 4, 8, 16))
    with pytest.raises(NotImplementedError, match="zero state"):
        lm_layers.ssd_mix(cfg, x.requires_grad_(), dt, a, bm, cm, init_state=init)
    with pytest.raises(NotImplementedError, match="zero state"):
        with torch.no_grad():
            lm_layers.ssd_mix(cfg, x, dt, a, bm, cm, init_state=init)
    assert calls == []
    p = materialize(lm_layers.ssd_specs(cfg), torch.Generator().manual_seed(0))
    h = torch.randn((1, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    grads = []
    for mode in ("auto", "ref"):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        hx = h.clone().requires_grad_()
        out = lm_layers.ssd_block(leaves, cfg, hx, mode=mode)
        grads.append(torch.autograd.grad(out.square().sum(), [hx, *leaves.values()]))
    assert calls == ["K6", "K6b"]
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()) + 1e-7)


# The backward's cases: (name, Bsz, S, H, G, P, N, pad_rows, dt_scale,
# final-state cotangent).
BWD_CASES = [
    ("s1", 2, 1, 4, 1, 64, 16, 0, 1.0, False),
    ("s37_g2_p48_n24_state", 2, 37, 4, 2, 48, 24, 0, 1.0, True),
    ("s256_n128", 1, 256, 2, 1, 64, 128, 0, 1.0, False),
    ("s300_g2_p48_dt0_state", 2, 300, 4, 2, 48, 16, 23, 1.0, True),
    ("s300_steep_n24", 1, 300, 4, 1, 64, 24, 0, 10.0, False),
    ("s300_g2_n128_state", 1, 300, 4, 2, 64, 128, 9, 1.0, True),
]
BWD_IDS = [c[0] for c in BWD_CASES]
GRADS = ("dx", "ddt", "da", "dB", "dC")


def _bwd_inputs(case, seed=5):
    _, Bsz, S, H, G, P, N, pad, scale, with_state = case
    args = _batched(Bsz, S, H, G, P, N, seed=seed, pad_rows=pad, dt_scale=scale)
    rng = np.random.default_rng(seed + 1)
    dy = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    ds = (rng.standard_normal((Bsz, H, P, N)).astype(np.float32) if with_state
          else np.zeros((Bsz, H, P, N), np.float32))
    return args, dy, ds, with_state


def _hold(got, want, tol):
    for name, g, w in zip(GRADS, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= tol * scale, (name, np.abs(g - w).max(), scale)


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_bwd_ref_matches_jax_vjp_of_ssd_mix(case):
    """The plain backward against ``jax.vjp`` of the reference's mixer
    (jitted; chunks of 16 there, so that its differences of running sums
    stay exact enough under steep decay), float32, each gradient within
    1e-4 of its largest entry."""
    import jax

    cfg = ARCHS["mamba2-780m"].reduced()
    args, dy, ds, with_state = _bwd_inputs(case)

    @jax.jit
    def vjp(primals, cotangents):
        return jax.vjp(lambda *t: JL.ssd_mix(cfg, *t, chunk=16, return_state=True),
                       *primals)[1](cotangents)

    want = vjp(tuple(map(jnp.asarray, args)), (jnp.asarray(dy), jnp.asarray(ds)))
    got = ssd_chunk_bwd_ref(*map(torch.as_tensor, args), torch.as_tensor(dy),
                            torch.as_tensor(ds) if with_state else None)
    assert [t.dtype for t in got] == [torch.float32] * 5
    _hold([t.numpy() for t in got], [np.asarray(w) for w in want], 1e-4)


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_bwd_ref_matches_float64_autograd_of_the_plain_scan(case):
    args, dy, ds, with_state = _bwd_inputs(case, seed=7)
    leaves = [torch.as_tensor(v).double().requires_grad_() for v in args]
    y, st = ssd_chunk_ref(*leaves)
    outs, cots = [y], [torch.as_tensor(dy).double()]
    if with_state:
        outs.append(st)
        cots.append(torch.as_tensor(ds).double())
    want = torch.autograd.grad(outs, leaves, cots)
    got = ssd_chunk_bwd_ref(*(t.detach() for t in leaves), cots[0],
                            cots[1] if with_state else None)
    assert [t.dtype for t in got] == [torch.float64] * 5
    _hold([t.numpy() for t in got], [w.numpy() for w in want], 1e-11)


def test_bwd_ref_keeps_the_kernel_dtypes_and_is_chunk_free():
    """bfloat16 inputs give bfloat16 dx, dB, dC and float32 ddt, da; the
    chunk length moves only rounding (chunks of 32 against 128)."""
    args, dy, ds, _ = _bwd_inputs(BWD_CASES[3])
    t = [torch.as_tensor(v) for v in args]
    bf = [t[0].bfloat16(), t[1], t[2], t[3].bfloat16(), t[4].bfloat16()]
    got = ssd_chunk_bwd_ref(*bf, torch.as_tensor(dy).bfloat16())
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    a = ssd_chunk_bwd_ref(*t, torch.as_tensor(dy), torch.as_tensor(ds), chunk=CHUNK_F32)
    b = ssd_chunk_bwd_ref(*t, torch.as_tensor(dy), torch.as_tensor(ds))
    _hold([x.numpy() for x in a], [x.numpy() for x in b], 1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd_plan_covers_every_chunk_and_head_once(shape, dtype):
    """K6b's grids: every (batch, chunk, head) in exactly one block of the
    chunk pass (bfloat16: a tile of ``heads_per_block`` heads; float32:
    every (batch, head) in one block, walking every chunk); the launches in
    order (one chunk kernel at N16 = 16, two at 128), the ring's stages and
    each instance's shared memory within the card's 227 KB; the scratch
    shapes, dtypes and bytes (bfloat16: K6's kept states and decays, in
    the shapes K6's plan gives them, are read and not allocated)."""
    Bsz, S, H, G, P, N = shape
    dt = getattr(torch, dtype)
    plan = bwd_plan(*shape, dt)
    chunk, nc, tiles = plan["chunk"], plan["chunks"], plan["head_tiles"]
    assert chunk == (CHUNK if dt == torch.bfloat16 else CHUNK_F32)
    assert nc * chunk >= S > (nc - 1) * chunk
    per, Hg = plan["heads_per_block"], H // G
    assert tiles == -(-Hg // per) and tiles * Bsz * G <= 65535 * 65535
    bf = dt == torch.bfloat16
    P16, N16 = -(-P // 16) * 16, -(-N // 16) * 16
    if bf:
        names = (["chunk"] if N16 <= 16 else ["chunk_dx", "chunk_dbc"])
        assert list(plan["grids"]) == ["cotan", "reverse_pass"] + names + ["sum"]
        grid = plan["grids"][names[0]]
        assert all(plan["grids"][n] == (nc, tiles, Bsz * G) for n in names)
        assert plan["stages"] == 2 and set(plan["smem"]) == set(names)
        assert all(v <= 232448 for v in plan["smem"].values())
        rev = plan["grids"]["reverse_pass"]
        assert rev == (plan["reverse_blocks"], H, Bsz) and rev[0] <= DOT_PARTS
        assert rev[0] * 2 * 128 >= P16 * N16 > (rev[0] - 1) * 2 * 128
        assert plan["grids"]["cotan"] == (nc, H, Bsz)
    else:
        grid = plan["grids"]["f32"]
        assert list(plan["grids"]) == ["f32", "sum"] and per == HEADS_PER_BLOCK
    seen = np.zeros((Bsz, nc, H), np.int64)
    zs = grid[2] if bf else grid[1]
    for z in range(zs):
        b, g = divmod(z, G)
        for ht in range(grid[1] if bf else grid[0]):
            h0, nh = g * Hg + ht * per, min(per, Hg - ht * per)
            assert nh >= 1
            seen[b, :, h0:h0 + nh] += 1
    assert (seen == 1).all()
    st = (Bsz, nc, H, P16, N16)
    if bf:
        assert plan["cotan"] == st == chunk_plan(*shape)["scratch"]
        assert plan["images"] == (2,) + st and plan["dtypes"]["images"] == torch.bfloat16
        assert plan["table"] == (Bsz, nc, H, TAB) and TAB == 2 * CHUNK + DOT_PARTS
        assert plan["part_a"] == (Bsz, nc, H) == chunk_plan(*shape)["decay"]
        assert plan["states"] is plan["decay"] is None
    else:
        assert plan["states"] == (Bsz, nc, H, P, N) and plan["part_a"] == (Bsz, 1, H)
        assert all(plan[k] is None for k in ("cotan", "decay", "table", "images"))
    assert plan["part_b"] == plan["part_c"] == (tiles, Bsz, S, G, N)
    assert plan["grids"]["sum"] == (-(-(Bsz * S * G * N + H) // 256),)
    names = ("states", "decay", "cotan", "table", "images", "part_b", "part_c", "part_a")
    assert plan["scratch_bytes"] == sum(plan["dtypes"][k].itemsize * int(np.prod(plan[k]))
                                        for k in names if plan[k] is not None)


KEPT_FAULTS = ("none", "one_chunk_short", "bf16_states", "strided_states", "swapped")


@pytest.mark.parametrize("fault", KEPT_FAULTS)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd_takes_only_k6s_kept_states_of_these_inputs(shape, fault):
    """A bfloat16 K6b call reads K6's kept (scratch, decay) in the shapes
    ``chunk_plan`` gives them (float32, contiguous, on x's device), and
    refuses anything else: a chunk short, another dtype, a strided view,
    the pair swapped (meta tensors: nothing is allocated)."""
    from repro_torch.kernels.ssd_chunk.kernel import _check_kept

    cp = chunk_plan(*shape)
    st, dec = cp["scratch"], cp["decay"]
    if fault == "one_chunk_short":
        st = (st[0], st[1] - 1) + st[2:] if st[1] > 1 else st[:-1] + (st[-1] - 16,)
    states = torch.empty(st, dtype=torch.bfloat16 if fault == "bf16_states" else torch.float32,
                         device="meta")
    if fault == "strided_states":
        states = torch.empty(st[:-2] + (st[-1], st[-2]), device="meta").transpose(-1, -2)
    decay = torch.empty(dec, device="meta")
    kept = (decay, states) if fault == "swapped" else (states, decay)
    plan = bwd_plan(*shape)
    if fault == "none":
        _check_kept(kept, plan, torch.device("meta"))
    else:
        with pytest.raises(ValueError, match="kept must be K6's"):
            _check_kept(kept, plan, torch.device("meta"))


def test_bwd_kernel_refuses_a_bf16_call_without_k6s_states():
    """K6b's bfloat16 path has no recompute of K6's states: a call without
    ``kept`` raises, as does a float32 call with it."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_kernel

    args = [torch.as_tensor(v) for v in _batched(1, 40, 4, 1, 16, 16, seed=3)]
    bf = [args[0].bfloat16(), args[1], args[2], args[3].bfloat16(), args[4].bfloat16()]
    with pytest.raises(ValueError, match="kept"):
        ssd_chunk_bwd_kernel(*bf, torch.zeros_like(bf[0]))
    with pytest.raises(ValueError, match="kept"):
        ssd_chunk_bwd_kernel(*args, torch.zeros_like(args[0]), kept=(args[0], args[1]))


def _emulate_bwd(x, dt, a, Bm, Cm, dy, dstate):
    """numpy mirror of ``csrc/ssd_chunk_bwd.cu``'s bfloat16 path and of its
    roundings: K6's states (``_emulate_states``, kept split); D_c from dy
    with exp(cum_i) in two bf16 terms (K6's pass 1); the reverse pass in
    float32, writing g_c+1 rounded to bf16 and s_in's hi terms as the
    images and <g, s_in> with s_in as hi + lo; the chunk pass over
    ``bwd_plan``'s head tiles: W = C B^T o L o dt and R = dy x^T o L o dt
    rounded once, dx = e dt B g^T + W^T dy, dB += R^T C + bf16(e dt x) g,
    dC += R B + bf16(exp(cum) dy) s_in, O from C s_in^T, K's sums in
    float; dB and dC summed per tile and then over the tiles, outputs
    rounded to bf16. Products accumulate in float64."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    Hg = H // G
    plan = bwd_plan(Bsz, S, H, G, P, N)
    nc, hpb, tiles = plan["chunks"], plan["heads_per_block"], plan["head_tiles"]
    _, _, _, P16, N16 = plan["cotan"]
    s_hi, s_lo, decay, _ = _emulate_states(x, dt, a, Bm)
    D = np.zeros(plan["cotan"], np.float32)                  # 3. the state cotangents
    for b in range(Bsz):
        for c in range(nc):
            t0 = c * CHUNK
            rows = min(CHUNK, S - t0)
            for h in range(H):
                cum2, _ = _cumsum2(dt, a, b, t0, rows, h)
                hi, lo = _split(_tile(dy, b, t0, rows, P16, h=h) * np.exp2(cum2)[:, None])
                ct = _tile(Cm, b, t0, rows, N16, g=h // Hg)
                D[b, c, h] = hi.T.astype(np.float64) @ ct + lo.T.astype(np.float64) @ ct
    g_img = np.zeros(plan["cotan"], np.float32)               # 4. the reverse pass
    dots = np.zeros((Bsz, nc, H))
    for b in range(Bsz):
        for h in range(H):
            gv = np.zeros((P16, N16), np.float32)
            if dstate is not None:
                gv[:P, :N] = dstate[b, h]
            for c in reversed(range(nc)):
                g_img[b, c, h] = _bf16(gv)
                dots[b, c, h] = (gv.astype(np.float64) * (s_hi[b, c, h].astype(np.float64)
                                                          + s_lo[b, c, h])).sum()
                gv = (np.float32(decay[b, c, h]) * gv + D[b, c, h]).astype(np.float32)
    dx = np.zeros((Bsz, S, H, P), np.float32)                # 5. the chunks
    ddt = np.zeros((Bsz, S, H), np.float32)
    da = np.zeros(H)
    dB = np.zeros((tiles, Bsz, S, G, N))
    dC = np.zeros((tiles, Bsz, S, G, N))
    low = np.tril(np.ones((CHUNK, CHUNK), bool))
    strict = np.tril(np.ones((CHUNK, CHUNK)), -1)
    for z in range(Bsz * G):
        b, g = divmod(z, G)
        for c in range(nc):
            t0 = c * CHUNK
            rows = min(CHUNK, S - t0)
            ct, bt = _tile(Cm, b, t0, rows, N16, g=g), _tile(Bm, b, t0, rows, N16, g=g)
            for ht in range(tiles):
                pb, pc = np.zeros((CHUNK, N16)), np.zeros((CHUNK, N16))
                for h in range(g * Hg + ht * hpb, g * Hg + min(Hg, (ht + 1) * hpb)):
                    cum2, d = _cumsum2(dt, a, b, t0, rows, h)
                    xt, yt = _tile(x, b, t0, rows, P16, h=h), _tile(dy, b, t0, rows, P16, h=h)
                    L = np.where(low, np.exp2(np.minimum(cum2[:, None] - cum2[None, :], 0.0)),
                                 0.0)
                    CB, DX = ct @ bt.T, yt @ xt.T
                    K = CB * DX * L
                    W, R = _bf16(CB * L * d[None, :]), _bf16(DX * L * d[None, :])
                    gs = g_img[b, c, h].astype(np.float64)
                    ss = s_hi[b, c, h].astype(np.float64)
                    e, ec = np.exp2(cum2[-1] - cum2), np.exp2(cum2)
                    ed = e * d
                    V2 = bt @ gs.T
                    xg = (xt * V2).sum(1)
                    dxh = ed[:, None] * V2 + W.T.astype(np.float64) @ yt
                    pb += R.T.astype(np.float64) @ ct + _bf16(ed[:, None] * xt) @ gs
                    pc += R.astype(np.float64) @ bt + _bf16(ec[:, None] * yt) @ ss
                    O = ec * ((ct @ ss.T) * yt).sum(1)
                    rs, cs = (K * strict * d[None, :]).sum(1), (K * strict).sum(0)
                    T = ed * xg
                    dcum = rs - d * cs + O - T
                    dcum[-1] += T.sum() + np.exp2(cum2[-1]) * dots[b, c, h]
                    dadt = np.cumsum(dcum[::-1])[::-1]
                    dx[b, t0:t0 + rows, h] = dxh[:rows, :P]
                    ddt[b, t0:t0 + rows, h] = (cs + np.diag(K) + e * xg + a[h] * dadt)[:rows]
                    da[h] += (d * dadt).sum()
                dB[ht, b, t0:t0 + rows, g] = pb[:rows, :N].astype(np.float32)
                dC[ht, b, t0:t0 + rows, g] = pc[:rows, :N].astype(np.float32)
    return (_bf16(dx), ddt, da.astype(np.float32), _bf16(dB.sum(0)), _bf16(dC.sum(0)))


# (name, Bsz, S, H, G, P, N, dt_scale, final-state cotangent)
EMULATE_BWD_CASES = [
    ("s1_n128", 2, 1, 4, 1, 64, 128, 1.0, False),
    ("s129_n16_state", 1, 129, 4, 1, 64, 16, 1.0, True),
    ("s300_g2_p48_n128_state", 1, 300, 4, 2, 48, 128, 1.0, True),
    ("s300_steep_n16", 1, 300, 4, 1, 64, 16, 10.0, False),
    ("s129_g2_p40_n20_state", 1, 129, 6, 2, 40, 20, 1.0, True),
]


@pytest.mark.parametrize("case", EMULATE_BWD_CASES, ids=[c[0] for c in EMULATE_BWD_CASES])
def test_bwd_kernel_mirror_matches_the_plain_backward(case):
    """The K6b mirror on bfloat16 inputs (x, B, C and dy rounded) against
    ``ssd_chunk_bwd_ref`` on the same values: each gradient within 2e-2 of
    its largest entry, the bound ``chip_smoke.py`` holds the kernel to (its
    roundings: one bf16 rounding of each float32 operand, bf16 outputs)."""
    _, Bsz, S, H, G, P, N, scale, with_state = case
    x, dt, a, Bm, Cm = _batched(Bsz, S, H, G, P, N, seed=S + N, dt_scale=scale)
    x, Bm, Cm = _bf16(x), _bf16(Bm), _bf16(Cm)
    rng = np.random.default_rng(S)
    dy = _bf16(rng.standard_normal((Bsz, S, H, P)).astype(np.float32))
    ds = rng.standard_normal((Bsz, H, P, N)).astype(np.float32) if with_state else None
    if scale > 1:
        assert np.cumsum(dt * a, axis=1)[:, :CHUNK].min() < -88.0  # steep
    got = _emulate_bwd(x, dt, a, Bm, Cm, dy, ds)
    want = ssd_chunk_bwd_ref(*map(torch.as_tensor, (x, dt, a, Bm, Cm, dy)),
                             None if ds is None else torch.as_tensor(ds))
    _hold(got, [w.numpy() for w in want], 2e-2)


def test_a_gradient_call_keeps_k6_states_for_k6b_and_no_other_call_does(monkeypatch):
    """``_SSDChunkFn`` asks K6 to keep its chunk states only when a
    gradient follows, hands exactly those tensors to K6b, and lets them go
    with the graph; under non-reentrant checkpointing (``remat``) the first
    forward's states are dropped at once and the recompute's reach K6b. The
    kept states, the plain version's passes 1-2 (``ssd_chunk_states_ref``),
    equal what K6's passes 1-2 form in the kernel's mirror (hi + lo), and
    the final state follows from the last of them."""
    import gc
    import weakref

    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    calls, kept_refs, got_kept = [], [], []

    def fwd(x, dt, a, Bm, Cm, keep=False):
        calls.append(("K6", keep))
        y, st = ssd_chunk_ref(x, dt, a, Bm, Cm)
        if not keep:
            return y, st
        kept = ssd_chunk_states_ref(*(t.detach() for t in (x, dt, a, Bm, Cm)))
        kept_refs.append([weakref.ref(t) for t in kept])
        return y, st, kept

    def bwd(x, dt, a, Bm, Cm, dy, dstate, kept=None):
        calls.append(("K6b", kept is not None))
        got_kept.append([weakref.ref(t) for t in kept])
        return ssd_chunk_bwd_ref(x, dt, a, Bm, Cm, dy, dstate)

    monkeypatch.setattr(ssd_ops, "use_kernel", lambda mode, x: mode != "ref")
    monkeypatch.setattr(ssd_ops, "_FWD", fwd)
    monkeypatch.setattr(ssd_ops, "_BWD", bwd)
    args = [torch.as_tensor(v) for v in _batched(1, 150, 4, 2, 16, 16, seed=9)]
    with torch.no_grad():
        ssd_ops.ssd_chunk_scan(*(t.clone().requires_grad_() for t in args))
    ssd_ops.ssd_chunk_scan(*args)
    assert calls == [("K6", False)] * 2 and not kept_refs

    calls.clear()
    leaves = [t.clone().requires_grad_() for t in args]
    y, _ = ssd_ops.ssd_chunk_scan(*leaves)
    assert calls == [("K6", True)] and all(r() is not None for r in kept_refs[0])
    y.sum().backward()
    assert calls == [("K6", True), ("K6b", True)]
    assert [r() for r in got_kept[0]] == [r() for r in kept_refs[0]]
    del y
    gc.collect()
    assert all(r() is None for r in kept_refs[0])

    calls.clear()
    kept_refs.clear()
    got_kept.clear()
    leaves = [t.clone().requires_grad_() for t in args]
    y = checkpoint(lambda *t: ssd_ops.ssd_chunk_scan(*t)[0], *leaves, use_reentrant=False)
    gc.collect()
    assert calls == [("K6", True)] and all(r() is None for r in kept_refs[0])
    y.sum().backward()
    assert calls == [("K6", True), ("K6", True), ("K6b", True)]
    assert [r() for r in got_kept[0]] == [r() for r in kept_refs[1]]

    x, dt, a, Bm, Cm = args
    xb, Bb = _bf16(x.numpy()), _bf16(Bm.numpy())
    s_in, decay = ssd_chunk_states_ref(torch.as_tensor(xb), dt, a, torch.as_tensor(Bb), Cm)
    hi, lo, mdecay, mstate = _emulate_states(xb, dt.numpy(), a.numpy(), Bb)
    mirror = (hi.astype(np.float64) + lo)[..., :16, :16]
    scale = np.abs(s_in.numpy()).max()
    assert np.abs(mirror - s_in.numpy()).max() <= 1e-3 * scale
    np.testing.assert_allclose(mdecay, decay.numpy(), rtol=1e-5)
    _, state = ssd_chunk_ref(torch.as_tensor(xb), dt, a, torch.as_tensor(Bb), Cm)
    assert np.abs(mstate[..., :16, :16] - state.numpy()).max() <= 1e-3 * np.abs(state.numpy()).max()


def _storage_u16(t):
    """``t``'s whole storage as uint16 words (bf16 bits), cached per storage."""
    key = t.untyped_storage().data_ptr()
    if key not in _STORAGE:
        _STORAGE[key] = np.frombuffer(bytes(t.untyped_storage()), np.uint16).copy()
    return _STORAGE[key]


_STORAGE = {}


def _tma_box(t, args, coords):
    """numpy emulation of a TMA box load of the map ``args`` (dims, byte
    strides of dims 1-3, box) over ``t``'s storage (bf16, read from its
    first element) at ``coords``: a (box3, box2, box1, box0) array, zeros
    out of bounds."""
    dims, strides, box = args[:4], args[4:7], args[7:]
    store = _storage_u16(t)
    base = t.storage_offset()
    out = np.zeros(tuple(reversed(box)), np.float32)
    for i3 in range(box[3]):
        for i2 in range(box[2]):
            for i1 in range(box[1]):
                c = [coords[1] + i1, coords[2] + i2, coords[3] + i3]
                if any(v >= n for v, n in zip(c, dims[1:])):
                    continue
                row = base + sum(v * s // 2 for v, s in zip(c, strides))
                n0 = min(box[0], dims[0] - coords[0])
                if n0 <= 0:
                    continue
                vals = store[row + coords[0]:row + coords[0] + n0].astype(np.uint32)
                out[i3, i2, i1, :n0] = (vals << 16).view(np.float32)
    return out


@pytest.mark.parametrize("P,N,G,H", [(64, 16, 1, 3), (64, 128, 1, 2), (40, 20, 2, 4)],
                         ids=["hymba_widths", "mamba2_widths", "p40_n20_g2"])
def test_bwd_tensor_maps_read_each_operand_tile(P, N, G, H):
    """K6b's six tensor maps (``bwd_maps``) against a numpy TMA emulation:
    x and dy (views of the model's fused (B, S, H P + 2 G N) projection, as
    the mixer passes them) give each head's CHUNK rows of a chunk, B and C
    each group's, the images each (batch, chunk, head)'s P16 x N16 state,
    zero-padded to 64 columns and past S; operands TMA cannot read in place
    (a row start off 16 bytes) are copied with padded rows, the rest read in
    place."""
    Bsz, S = 2, 150
    _STORAGE.clear()
    rng = np.random.default_rng(P + N)
    xbc = torch.as_tensor(rng.standard_normal((Bsz, S, H * P + 2 * G * N)).astype(np.float32))
    xbc = xbc.bfloat16()
    x, bm, cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    x, bm, cm = x.reshape(Bsz, S, H, P), bm.reshape(Bsz, S, G, N), cm.reshape(Bsz, S, G, N)
    dy = torch.as_tensor(rng.standard_normal((Bsz, S, H, P)).astype(np.float32)).bfloat16()
    plan = bwd_plan(Bsz, S, H, G, P, N)
    nc = plan["chunks"]
    ops = [tma_operand(t) for t in (x, dy, bm, cm)]
    for t, o in zip((x, dy, bm, cm), ops):
        assert torch.equal(o, t) and tma_ready(o)
        assert (o.data_ptr() == t.data_ptr()) == tma_ready(t)
    assert tma_ready(x) and tma_ready(dy)
    images = torch.as_tensor(rng.standard_normal(plan["images"]).astype(np.float32)).bfloat16()
    maps = bwd_maps(*ops, plan)
    assert len(maps) == 6 and all(len(m) == 11 for m in maps)

    def want(t, b, t0, k, c0):
        w = np.zeros((CHUNK, 64), np.float32)
        v = t[b, t0:t0 + CHUNK, k, c0:c0 + 64].float().numpy()
        w[:v.shape[0], :v.shape[1]] = v
        return w

    for c in range(nc):
        for b in range(Bsz):
            for h in (0, H - 1):
                for t, m in zip(ops[:2], maps[:2]):
                    got = _tma_box(t, m, (0, c * CHUNK, h, b))[0, 0]
                    np.testing.assert_array_equal(got, want(t, b, c * CHUNK, h, 0))
                for k in range(2):
                    img = images[k]
                    got = _tma_box(img[0, 0, 0, 0, 0:1], maps[4 + k],
                                   (0, 0, h, b * nc + c))[0, 0]
                    w = np.zeros((64, 64), np.float32)
                    v = img[b, c, h].float().numpy()
                    w[:v.shape[0], :min(64, v.shape[1])] = v[:, :64]
                    np.testing.assert_array_equal(got, w)
                    if v.shape[1] > 64:  # the second 64 columns
                        got = _tma_box(img[0, 0, 0, 0, 0:1], maps[4 + k],
                                       (64, 0, h, b * nc + c))[0, 0]
                        np.testing.assert_array_equal(got[:, :v.shape[1] - 64], v[:, 64:])
            for g in range(G):
                for t, m in zip(ops[2:], maps[2:4]):
                    for c0 in range(0, N, 64):
                        got = _tma_box(t, m, (c0, c * CHUNK, g, b))[0, 0]
                        np.testing.assert_array_equal(got, want(t, b, c * CHUNK, g, c0))
