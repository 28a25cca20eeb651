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

The CUDA kernel runs only on the card (``chip_smoke.py``'s ``lm_kernels``).
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
    ssd_chunk_kernel,
    ssd_chunk_ref,
    ssd_chunk_scan,
    ssd_ref,
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


def _batched(Bsz, S, H, G, P, N, seed=0, pad_rows=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, H, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, H))))
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
    single = list(map(torch.as_tensor, _single(CASES[0])))
    with pytest.raises(ValueError, match="CUDA"):
        ssd(*single, mode="kernel")
