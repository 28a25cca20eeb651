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
  final-state cotangent; ``kernel.bwd_plan``'s grids and scratch; the
  autograd seam (a gradient call runs K6 then K6b, a call without one K6
  alone), with the plain versions stood in.

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
    ssd_ref,
)
from repro_torch.kernels.ssd_chunk.kernel import (
    CHUNK,
    CHUNK_F32,
    HEADS_PER_BLOCK,
    bwd_plan,
    chunk_plan,
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
    log2e = np.float32(1.4426950408889634)

    def tile(t, b, t0, rows, cols, g=None, h=None):
        out = np.zeros((CHUNK, cols), np.float64)
        v = t[b, t0:t0 + rows, g if h is None else h]
        out[:rows, :v.shape[-1]] = v
        return out

    def cumsum2(b, t0, rows, h):
        d = np.zeros(CHUNK, np.float32)
        d[:rows] = dt[b, t0:t0 + rows, h]
        return np.cumsum(d * np.float32(a[h])) * log2e, d

    scratch = np.zeros(plan["scratch"], np.float64)
    decay = np.zeros(plan["decay"], np.float64)
    for b in range(Bsz):                                   # pass 1
        for c in range(nc):
            t0 = c * CHUNK
            rows = min(CHUNK, S - t0)
            for h in range(H):
                cum2, d = cumsum2(b, t0, rows, h)
                wk = d * np.exp2(cum2[-1] - cum2)
                hi, lo = _split(tile(x, b, t0, rows, P16, h=h) * wk[:, None])
                bt = tile(Bm, b, t0, rows, N16, g=h // Hg)
                scratch[b, c, h] = hi.T.astype(np.float64) @ bt + lo.T.astype(np.float64) @ bt
                decay[b, c, h] = np.exp2(cum2[-1])
    s_in = np.zeros((Bsz, nc, H, P16, 2 * N16))              # pass 2
    state = np.zeros((Bsz, H, P16, N16))
    for b in range(Bsz):
        for h in range(H):
            s = np.zeros((P16, N16), np.float32)
            for c in range(nc):
                hi, lo = _split(s)
                for q in range(N16 // 8):
                    s_in[b, c, h, :, 16 * q:16 * q + 8] = hi[:, 8 * q:8 * q + 8]
                    s_in[b, c, h, :, 16 * q + 8:16 * q + 16] = lo[:, 8 * q:8 * q + 8]
                s = (np.float32(decay[b, c, h]) * s + scratch[b, c, h]).astype(np.float32)
            state[b, h] = s
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

    def fwd(x, dt, a, Bm, Cm):
        calls.append("K6")
        return ssd_chunk_ref(x, dt, a, Bm, Cm)

    def bwd(*args):
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
    dx and dB / dC passes (the float32 kernel: every (batch, head) in one
    block, walking every chunk); the scratch shapes and their bytes."""
    Bsz, S, H, G, P, N = shape
    dt = getattr(torch, dtype)
    plan = bwd_plan(*shape, dt)
    chunk, nc, tiles = plan["chunk"], plan["chunks"], plan["head_tiles"]
    assert chunk == (CHUNK if dt == torch.bfloat16 else CHUNK_F32)
    assert nc * chunk >= S > (nc - 1) * chunk
    per, Hg = plan["heads_per_block"], H // G
    assert tiles == -(-Hg // per) and tiles * Bsz * G <= 65535 * 65535
    name = "dx" if dt == torch.bfloat16 else "f32"
    grid = plan["grids"][name]
    seen = np.zeros((Bsz, nc, H), np.int64)
    zs = grid[2] if dt == torch.bfloat16 else grid[1]
    for z in range(zs):
        b, g = divmod(z, G)
        for ht in range(grid[1] if dt == torch.bfloat16 else grid[0]):
            h0, nh = g * Hg + ht * per, min(per, Hg - ht * per)
            assert nh >= 1
            seen[b, :, h0:h0 + nh] += 1
    assert (seen == 1).all()
    if dt == torch.bfloat16:
        assert grid == plan["grids"]["dbc"] == (nc, tiles, Bsz * G)
        assert plan["states"] == plan["cotan"] == chunk_plan(*shape)["scratch"]
        assert plan["decay"] == (Bsz, nc, H) and plan["part_a"] == (Bsz, nc, H)
    else:
        assert plan["states"] == (Bsz, nc, H, P, N) and plan["part_a"] == (Bsz, 1, H)
        assert plan["cotan"] is None and plan["decay"] is None
    assert plan["part_b"] == plan["part_c"] == (tiles, Bsz, S, G, N)
    assert plan["grids"]["sum"] == (-(-Bsz * S * G * N // 256),)
    shapes = [plan[k] for k in ("states", "cotan", "decay", "final", "part_b",
                                "part_c", "part_a") if plan[k] is not None]
    assert plan["scratch_bytes"] == sum(4 * int(np.prod(v)) for v in shapes)
