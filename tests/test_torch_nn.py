"""The port's parameter initializers and embedding against the reference
on the CPU.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so the draws are held by shape, dtype and scale: the sample variance
of ``lecun`` (1 / fan_in) and of ``embedding_init``'s table (0.02^2) lies
within 5% of its target (at 131,072 draws the sample variance's relative
standard error is sqrt(2 / n) = 0.4%), as the reference's own draws do.
``ones`` and ``embedding`` (a gather of the same table) are bit-equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import init as jinit
from repro.nn import linear as jlinear
from repro_torch.nn import init, linear

BAND = 0.05


@pytest.mark.parametrize("shape", [(256, 512), (4, 128, 256), (131_072,)])
def test_lecun_has_the_reference_scale(shape):
    fan_in = shape[-2] if len(shape) > 1 else shape[-1]
    w = init.lecun(torch.Generator().manual_seed(0), shape)
    ref = np.asarray(jinit.lecun(jax.random.PRNGKey(0), shape))
    assert tuple(w.shape) == ref.shape == shape and w.dtype == torch.float32
    for var in (float(w.var()), float(ref.var())):
        assert abs(var * fan_in - 1.0) < BAND, var * fan_in
    again = init.lecun(torch.Generator().manual_seed(0), shape)
    assert torch.equal(w, again)


def test_ones_is_the_reference_ones():
    got = init.ones(torch.Generator().manual_seed(0), (3, 5))
    want = np.asarray(jinit.ones(jax.random.PRNGKey(0), (3, 5)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_embedding_init_has_the_reference_scale_and_the_gather_is_bit_equal():
    p = linear.embedding_init(torch.Generator().manual_seed(1), 512, 256)
    ref = jlinear.embedding_init(jax.random.PRNGKey(1), 512, 256)
    assert set(p) == set(ref) == {"table"}
    assert tuple(p["table"].shape) == ref["table"].shape == (512, 256)
    for table in (p["table"].numpy(), np.asarray(ref["table"])):
        assert abs(table.var() / 0.02 ** 2 - 1.0) < BAND
    table = np.random.default_rng(2).standard_normal((50, 7)).astype(np.float32)
    ids = np.random.default_rng(3).integers(0, 50, (4, 9))  # repeats too
    got = linear.embedding({"table": torch.as_tensor(table)}, torch.as_tensor(ids))
    want = jlinear.embedding({"table": jnp.asarray(table)}, jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
