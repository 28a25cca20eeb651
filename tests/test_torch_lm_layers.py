"""Parity of the port's LM layers (``repro_torch.models.lm.layers``) with
the reference's, function by function, on the CPU.

Parameters come from the reference's ``materialize`` (through
``convert.lm_params_from_jax``) and activations from numpy, on the reduced
hymba-1.5b, qwen3-0.6b and mamba2-780m configs (``ArchConfig.reduced()``,
float32). The port's ``mode="auto"`` on a CPU tensor runs the reference's
algorithms (``flash_attention``, ``swa_flash_attention``, chunked
``ssd_mix``), so most functions hold to the harness's float32 tolerance,
2e-5; the model-level blocks, which chain several products, to the
reference's own model tolerance, 2e-4 (``tests/test_lm_models.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models.lm import layers as JL
from repro.models.lm import model as JM
from repro.models.lm.params import materialize as jax_materialize
from repro.models.lm.params import n_params as jax_n_params
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import layers as L
from repro_torch.models.lm import model as M
from repro_torch.models.lm.params import Spec, n_params

TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)
ARCH3 = ["hymba-1.5b", "qwen3-0.6b", "mamba2-780m"]
ATTN_ARCHS = ["hymba-1.5b", "qwen3-0.6b"]
SSD_ARCHS = ["hymba-1.5b", "mamba2-780m"]


def _cfgs(arch, **kw):
    """(reference config, port config), reduced, with the same overrides."""
    jc = dataclasses.replace(JARCHS[arch].reduced(), **kw)
    tc = dataclasses.replace(ARCHS[arch].reduced(), **kw)
    return jc, tc


def _params(jspecs, cfg, seed=0):
    jp = jax_materialize(jspecs, jax.random.PRNGKey(seed), jnp.float32)
    return jp, lm_params_from_jax(jax.device_get(jp), cfg)


def _normal(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _spec_items(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_spec_items(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = (tuple(v.shape), tuple(v.axes), v.init, v.scale)
    return out


# ----------------------------------------------------------------------
# Configs and specs
# ----------------------------------------------------------------------
def test_every_config_is_carried_as_data():
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in JARCHS:
        assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(JARCHS[name])
        assert get_arch(name).param_count() == JARCHS[name].param_count()
        assert (dataclasses.asdict(get_arch(name).reduced())
                == dataclasses.asdict(JARCHS[name].reduced()))
    with pytest.raises(KeyError, match="available"):
        get_arch("gpt-17")


@pytest.mark.parametrize("arch", ARCH3)
def test_param_specs_match_reference(arch):
    for cfg_of in (lambda a: a, lambda a: a.reduced()):
        jspecs = JM.param_specs(cfg_of(JARCHS[arch]))
        tspecs = M.param_specs(cfg_of(ARCHS[arch]))
        assert _spec_items(tspecs) == _spec_items(jspecs)
        assert n_params(tspecs) == jax_n_params(jspecs)


def test_unported_families_raise():
    for name in ("dbrx-132b", "whisper-large-v3", "llama-3.2-vision-11b"):
        with pytest.raises(NotImplementedError, match="not ported"):
            M.param_specs(get_arch(name))
    with pytest.raises(ValueError, match="length mismatch"):
        Spec((2, 3), ("a",))


# ----------------------------------------------------------------------
# Norms and RoPE
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH3)
def test_rms_norm(arch):
    jc, tc = _cfgs(arch)
    x = _normal((2, 7, tc.d_model), 1, 3.0)
    scale = _normal((tc.d_model,), 2)
    _close(L.rms_norm(torch.as_tensor(scale), torch.as_tensor(x), tc.norm_eps),
           JL.rms_norm(jnp.asarray(scale), jnp.asarray(x), jc.norm_eps))
    _close(L.norm(tc, torch.as_tensor(scale), torch.as_tensor(x)),
           JL.norm(jc, jnp.asarray(scale), jnp.asarray(x)))
    assert L.norm_specs(tc) == Spec((tc.d_model,), (None,), init="ones")


@pytest.mark.parametrize("arch", ATTN_ARCHS)
@pytest.mark.parametrize("positions", ["range", "scalar", "batched"])
def test_apply_rope(arch, positions):
    _, tc = _cfgs(arch)
    x = _normal((2, 5, tc.num_heads, tc.resolved_head_dim), 3)
    pos = {"range": np.arange(5), "scalar": np.int32(11),
           "batched": np.arange(10).reshape(2, 5) * 3}[positions]
    _close(L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), tc.rope_theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), tc.rope_theta))


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------
ATTN_CASES = [  # (causal, window, q_offset, kv_len, Sq, Skv)
    (True, 0, 0, None, 20, 20),
    (True, 6, 0, None, 20, 20),
    (False, 0, 0, None, 12, 20),
    (True, 0, 8, None, 12, 20),
    (True, 0, 8, 17, 12, 20),
    (True, 5, 30, 33, 4, 40),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_plain(case):
    causal, window, q_offset, kv_len, Sq, Skv = case
    q, k, v = (_normal((2, Sq, 4, 16), 4), _normal((2, Skv, 2, 16), 5),
               _normal((2, Skv, 2, 16), 6))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_block=8)
    want = JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_len=None if kv_len is None else jnp.int32(kv_len), **kw)
    got = L.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                            kv_len=None if kv_len is None else torch.tensor(kv_len), **kw)
    _close(got, want)


def test_swa_flash_attention_plain():
    """The block-skipping route (window 8, kv_block 8, S = 40: five q
    blocks, a clamped first span)."""
    q, k, v = (_normal((2, 40, 4, 16), 7), _normal((2, 40, 2, 16), 8),
               _normal((2, 40, 2, 16), 9))
    want = JL.swa_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=8, kv_block=8)
    got = L.swa_flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), window=8, kv_block=8)
    _close(got, want)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention(fast, window):
    q, kc, vc = (_normal((2, 1, 4, 16), 10), _normal((2, 24, 2, 16), 11),
                 _normal((2, 24, 2, 16), 12))
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.int32(17), window=window, fast=fast)
    got = L.decode_attention(torch.as_tensor(q), torch.as_tensor(kc),
                             torch.as_tensor(vc), torch.tensor(17, dtype=torch.int32),
                             window=window, fast=fast)
    _close(got, want)


def test_decode_attention_goes_through_the_cache_helper(monkeypatch):
    """Both decode attentions over a cache (``decode_attention``'s fast
    form and ``cached_swa_attention``) compute their products in
    ``_attend_cache``, the one helper that holds the card's mixed-dtype
    GEMMs; the float32 form does not."""
    calls = []
    real = L._attend_cache

    def spy(qg, k_cache, v_cache, allow):
        calls.append(tuple(k_cache.shape))
        return real(qg, k_cache, v_cache, allow)

    monkeypatch.setattr(L, "_attend_cache", spy)
    q, kc, vc = (torch.as_tensor(_normal((2, 1, 4, 16), 10)),
                 torch.as_tensor(_normal((2, 24, 2, 16), 11)),
                 torch.as_tensor(_normal((2, 24, 2, 16), 12)))
    L.decode_attention(q, kc, vc, torch.tensor(17), window=5, fast=True)
    assert calls == [(2, 24, 2, 16)]
    L.decode_attention(q, kc, vc, torch.tensor(17), fast=False)
    assert len(calls) == 1
    jc, tc = _cfgs("hymba-1.5b", sliding_window=8)
    _, tp = _params(JL.attention_specs(jc), tc, seed=3)
    Hk, D = tc.num_kv_heads, tc.resolved_head_dim
    cache = {"k": torch.zeros(1, 8, Hk, D), "v": torch.zeros(1, 8, Hk, D),
             "slot_pos": torch.full((8,), -1, dtype=torch.int32),
             "idx": torch.tensor(0, dtype=torch.int32)}
    L.cached_swa_attention(tp, tc, torch.as_tensor(_normal((1, 1, tc.d_model), 40)),
                           cache, 8)
    assert calls[1:] == [(1, 8, Hk, D)]


def test_cache_helper_is_the_float32_copy_form():
    """On the CPU the helper's per-row GEMMs over views of a bfloat16 cache
    give the float32-copy form's numbers (the reference's einsums on
    float32 copies), to float32 rounding."""
    B, T, Hk, G, D = 3, 40, 5, 5, 16
    qg = torch.as_tensor(_normal((B, Hk, G, D), 30)).to(torch.bfloat16)
    kc = torch.as_tensor(_normal((B, T, Hk, D), 31)).to(torch.bfloat16)
    vc = torch.as_tensor(_normal((B, T, Hk, D), 32)).to(torch.bfloat16)
    allow = torch.arange(T) < 33
    s = torch.einsum("bhgd,bthd->bhgt", qg.float(), kc.float())
    p = torch.softmax(torch.where(allow, s, L.NEG_INF), dim=-1)
    want = torch.einsum("bhgt,bthd->bhgd", p.to(vc.dtype).float(), vc.float())
    got = L._attend_cache(qg, kc, vc, allow)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,window", [("qwen3-0.6b", 0), ("hymba-1.5b", 16),
                                         ("hymba-1.5b", 8)])
def test_self_attention(arch, window):
    """Both of the reference's routes at S = 40, kv_block 8: the full
    ``flash_attention`` (window 0, or 16 > kv_block) and the block-skipping
    ``swa_flash_attention`` (window 8 <= kv_block, S > 2 kv_block)."""
    jc, tc = _cfgs(arch, sliding_window=window)
    jp, tp = _params(JL.attention_specs(jc), tc, seed=1)
    x = _normal((2, 40, tc.d_model), 13)
    pos = np.arange(40)
    jo, (jk, jv) = JL.self_attention(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                                     window=window, kv_block=8)
    to, (tk, tv) = L.self_attention(tp, tc, torch.as_tensor(x), torch.as_tensor(pos),
                                    window=window, kv_block=8, mode="auto")
    _close(to, jo, BLOCK_TOL)
    _close(tk, jk)
    _close(tv, jv)
    ro, _ = L.self_attention(tp, tc, torch.as_tensor(x), torch.as_tensor(pos),
                             window=window, kv_block=8, mode="ref")
    assert torch.equal(ro, to)  # a CPU tensor takes the plain route in "auto"


def _jcache_to_torch(c):
    return {k: torch.as_tensor(np.array(v)) for k, v in c.items()}


def test_cached_self_attention():
    """Twelve decode steps into a 16-slot cache after a 4-token fill."""
    jc, tc = _cfgs("qwen3-0.6b")
    jp, tp = _params(JL.attention_specs(jc), tc, seed=2)
    Hk, D = tc.num_kv_heads, tc.resolved_head_dim
    kc = np.zeros((2, 16, Hk, D), np.float32)
    kc[:, :4] = _normal((2, 4, Hk, D), 14)
    vc = np.zeros_like(kc)
    vc[:, :4] = _normal((2, 4, Hk, D), 15)
    jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc), "idx": jnp.int32(4)}
    tcache = _jcache_to_torch(jcache)
    for i in range(12):
        x = _normal((2, 1, tc.d_model), 20 + i)
        jo, jcache = JL.cached_self_attention(jp, jc, jnp.asarray(x), jcache)
        to, tcache = L.cached_self_attention(tp, tc, torch.as_tensor(x), tcache)
        _close(to, jo, BLOCK_TOL)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    assert int(tcache["idx"]) == int(jcache["idx"]) == 16


def test_cached_swa_attention_past_the_window():
    """A ring of W = 8 slots, 20 steps from position 3: the ring wraps
    twice and old slots fall out of the window."""
    jc, tc = _cfgs("hymba-1.5b", sliding_window=8)
    jp, tp = _params(JL.attention_specs(jc), tc, seed=3)
    Hk, D = tc.num_kv_heads, tc.resolved_head_dim
    kc, vc = _normal((1, 8, Hk, D), 16), _normal((1, 8, Hk, D), 17)
    sp = np.array([0, 1, 2, -1, -1, -1, -1, -1], np.int32)
    kc[:, 3:] = vc[:, 3:] = 0.0
    jcache = {"k": jnp.asarray(kc), "v": jnp.asarray(vc),
              "slot_pos": jnp.asarray(sp), "idx": jnp.int32(3)}
    tcache = _jcache_to_torch(jcache)
    for i in range(20):
        x = _normal((1, 1, tc.d_model), 40 + i)
        jo, jcache = JL.cached_swa_attention(jp, jc, jnp.asarray(x), jcache, 8)
        to, tcache = L.cached_swa_attention(tp, tc, torch.as_tensor(x), tcache, 8)
        _close(to, jo, BLOCK_TOL)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    assert np.array_equal(tcache["slot_pos"].numpy(), np.asarray(jcache["slot_pos"]))
    assert int(tcache["idx"]) == int(jcache["idx"]) == 23


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen3-0.6b", "whisper-large-v3"])
def test_mlp_block(arch):
    """SwiGLU (hymba, qwen3) and the tanh-approximated GELU (whisper's
    act, the only config with it)."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(JL.mlp_specs(jc), tc, seed=4)
    if tc.act != "silu":  # non-zero biases
        jp = dict(jp, bi=jnp.asarray(_normal(jp["bi"].shape, 5)))
        tp = dict(tp, bi=torch.as_tensor(np.array(jp["bi"])))
    x = _normal((2, 9, tc.d_model), 18)
    _close(L.mlp_block(tp, tc, torch.as_tensor(x)), JL.mlp_block(jp, jc, jnp.asarray(x)),
           BLOCK_TOL)


# ----------------------------------------------------------------------
# Mamba2 SSD mixer
# ----------------------------------------------------------------------
def test_causal_conv_and_segsum():
    w, b, x = _normal((4, 12), 19), _normal((12,), 20), _normal((2, 9, 12), 21)
    _close(L._causal_conv(torch.as_tensor(w), torch.as_tensor(b), torch.as_tensor(x)),
           JL._causal_conv(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x)))
    a = -np.abs(_normal((3, 2, 7), 22))
    got = L._segsum(torch.as_tensor(a)).numpy()
    want = np.asarray(JL._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)], **TOL)


def _ssd_mix_inputs(tc, S, seed):
    H, P, N, G = tc.ssm_heads, tc.ssm_head_dim, tc.ssm_state, tc.ssm_groups
    return (_normal((2, S, H, P), seed, 0.5),
            np.log1p(np.exp(_normal((2, S, H), seed + 1))).astype(np.float32),
            -np.exp(_normal((H,), seed + 2, 0.3)).astype(np.float32),
            _normal((2, S, G, N), seed + 3, 0.5), _normal((2, S, G, N), seed + 4, 0.5))


@pytest.mark.parametrize("arch", SSD_ARCHS)
@pytest.mark.parametrize("init_state", [False, True])
def test_ssd_mix(arch, init_state):
    """The reference's chunked algorithm (chunk 16 over S = 40: padding),
    y and the final state, from zeros and from a given state."""
    jc, tc = _cfgs(arch)
    args = _ssd_mix_inputs(tc, 40, 23)
    s0 = (_normal((2, tc.ssm_heads, tc.ssm_head_dim, tc.ssm_state), 30, 0.3)
          if init_state else None)
    jy, js = JL.ssd_mix(jc, *map(jnp.asarray, args), chunk=16,
                        init_state=None if s0 is None else jnp.asarray(s0),
                        return_state=True)
    ty, ts = L.ssd_mix(tc, *map(torch.as_tensor, args), chunk=16,
                       init_state=None if s0 is None else torch.as_tensor(s0),
                       return_state=True, mode="auto")
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("arch", SSD_ARCHS)
def test_ssd_block(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(JL.ssd_specs(jc), tc, seed=5)
    x = _normal((2, 21, tc.d_model), 24)
    _close(L.ssd_block(tp, tc, torch.as_tensor(x), chunk=8),
           JL.ssd_block(jp, jc, jnp.asarray(x), chunk=8), BLOCK_TOL)


@pytest.mark.parametrize("arch", SSD_ARCHS)
def test_ssd_decode_with_state(arch):
    """Five single-token steps from a random conv and SSM state: the output
    and both state leaves after each step."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(JL.ssd_specs(jc), tc, seed=6)
    z = JL.ssd_init_state(jc, 2, jnp.float32)
    tz = L.ssd_init_state(tc, 2, torch.float32)
    assert {k: tuple(v.shape) for k, v in tz.items()} == {k: v.shape for k, v in z.items()}
    assert all(float(v.abs().max()) == 0 for v in tz.values())
    jst = {"conv": jnp.asarray(_normal(z["conv"].shape, 25)),
           "ssm": jnp.asarray(_normal(z["ssm"].shape, 26, 0.3))}
    tst = _jcache_to_torch(jst)
    for i in range(5):
        x = _normal((2, 1, tc.d_model), 27 + i)
        jo, jst = JL.ssd_decode(jp, jc, jnp.asarray(x), jst)
        to, tst = L.ssd_decode(tp, tc, torch.as_tensor(x), tst)
        _close(to, jo, BLOCK_TOL)
        _close(tst["conv"], jst["conv"])
        _close(tst["ssm"], jst["ssm"])
