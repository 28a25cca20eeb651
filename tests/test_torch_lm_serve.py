"""Parity of the port's LM serving path with the reference, on the CPU:
``prefill`` (last logits and every cache leaf), eight teacher-forced
``decode_step``s (logits after each, every cache leaf after the last),
``generate`` and ``launch.serve.main``, for the reduced hymba-1.5b (hybrid:
windowed attention and SSD side by side), qwen3-0.6b (dense, qk-norm, tied
embeddings) and mamba2-780m (ssm) configs.

Both packages start from the reference's ``M.init`` (converted by
``convert.lm_params_from_jax``) and the same numpy-drawn prompt (B = 2, S =
24, ``kv_block`` 8). The reduced hymba's window is 16 < S, so the prefill's
ring-aligned fill (``W < S``) runs. The decode steps feed the reference's
own greedy tokens to both packages (teacher forcing), and ``generate``'s
tokens are held equal to the reference's wherever the reference's top-2
logit margin exceeds ``MARGIN``: random-init logits have near-ties, and a
rounding-level difference may flip one (after which the two continuations
differ, so a row is compared up to its first allowed flip).

Tolerances: the reference's own for prefill against forward (2e-4) and
decode against forward (3e-4), ``tests/test_lm_models.py:67-88``. The
largest differences measured here, against the reference under ``jit``:
1.3e-5 in the prefill's logits, 3.7e-5 in a cache leaf, 2.6e-5 in the
decode steps' logits (hymba; qwen3 and mamba2 below 8e-6). The smallest
top-2 margin on these prompts was 4.8e-4 (qwen3), so ``MARGIN`` does
exempt near-ties there.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models.lm import model as JM
from repro.serve import generate as jax_generate
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.lm import model as M
from repro_torch.serve import generate, make_decode_step, make_prefill_step

PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)
MARGIN = 1e-3  # top-2 logit margin above which greedy tokens must agree
S, STEPS, B = 24, 8, 2
ARCH3 = ["hymba-1.5b", "qwen3-0.6b", "mamba2-780m"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.array(v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


@pytest.fixture(scope="module", params=ARCH3)
def run(request):
    """Both packages through prefill, eight teacher-forced decode steps and
    greedy generation, from the same parameters and prompt."""
    arch = request.param
    jc, tc = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    jp = JM.init(jc, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.device_get(jp), tc)
    prompt = np.random.default_rng(7).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    max_len = S + STEPS + 1

    gen = np.array(jax_generate(jp, jc, {"tokens": jnp.asarray(prompt)},
                                  num_tokens=STEPS, temperature=0.0, kv_block=8))
    jpre = jax.jit(partial(JM.prefill, cfg=jc, max_len=max_len, kv_block=8))
    jdec = jax.jit(partial(JM.decode_step, cfg=jc))
    jl, jcache = jpre(jp, batch={"tokens": jnp.asarray(prompt)})
    tl, tcache = M.prefill(tp, tc, {"tokens": torch.as_tensor(prompt)},
                           max_len=max_len, kv_block=8)
    out = dict(arch=arch, jc=jc, tc=tc, jp=jp, tp=tp, prompt=prompt, gen=gen,
               prefill=(np.asarray(jl), tl.numpy(), _flat(jax.device_get(jcache)),
                        _flat(tcache)),
               steps=[])
    for i in range(STEPS):
        tok = gen[:, i]
        jl, jcache = jdec(jp, cache=jcache, tokens=jnp.asarray(tok))
        tl, tcache = M.decode_step(tp, tc, tcache, torch.as_tensor(tok))
        out["steps"].append((np.asarray(jl), tl.numpy()))
    out["decoded"] = (_flat(jax.device_get(jcache)), _flat(tcache))
    return out


def test_prefill_last_logits(run):
    want, got, _, _ = run["prefill"]
    assert got.shape == (B, run["tc"].vocab_size) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **PREFILL_TOL)


def test_prefill_every_cache_leaf(run):
    _, _, want, got = run["prefill"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        if want[name].dtype.kind == "i":  # idx, slot_pos: exact
            assert got[name].dtype == np.int32 and np.array_equal(got[name], want[name]), name
        else:
            np.testing.assert_allclose(got[name], want[name], **PREFILL_TOL, err_msg=name)
    if run["arch"] == "hymba-1.5b":  # the ring-aligned fill ran: W = 16 < S
        sp = got["/attn/slot_pos"][0]
        assert sp.shape == (16,) and sorted(sp) == list(range(S - 16, S))


def test_teacher_forced_decode_logits(run):
    for i, (want, got) in enumerate(run["steps"]):
        np.testing.assert_allclose(got, want, **DECODE_TOL, err_msg=f"step {i}")


def test_cache_after_decode_steps(run):
    want, got = run["decoded"]
    for name in want:
        if want[name].dtype.kind == "i":
            assert np.array_equal(got[name], want[name]), name
        else:
            np.testing.assert_allclose(got[name], want[name], **DECODE_TOL, err_msg=name)
    idx = got.get("/attn/idx")
    assert idx is None or (idx == S + STEPS).all()


def test_generate_greedy_matches_reference_beyond_near_ties(run):
    ours = generate(run["tp"], run["tc"], {"tokens": torch.as_tensor(run["prompt"])},
                    num_tokens=STEPS, temperature=0.0, kv_block=8)
    assert ours.dtype == torch.int32 and tuple(ours.shape) == (B, STEPS)
    ours = ours.numpy()
    # the reference's logits before each of its tokens: the prefill's, then
    # the first STEPS - 1 teacher-forced steps' (fed its own tokens)
    ref_logits = [run["prefill"][0]] + [s[0] for s in run["steps"][:-1]]
    compared = 0
    for b in range(B):
        for i, logits in enumerate(ref_logits):
            top2 = np.sort(logits[b])[-2:]
            if top2[1] - top2[0] <= MARGIN:
                break  # a near-tie: the rows may part here
            assert ours[b, i] == run["gen"][b, i], (b, i)
            compared += 1
    assert compared >= B * STEPS // 2


def test_step_factories_and_modes_agree(run):
    tc, tp, prompt = run["tc"], run["tp"], torch.as_tensor(run["prompt"])
    la, ca = make_prefill_step(tc, max_len=S + 2, kv_block=8)(tp, {"tokens": prompt})
    lr, cr = make_prefill_step(tc, max_len=S + 2, kv_block=8, mode="ref")(
        tp, {"tokens": prompt})
    assert torch.equal(la, lr)  # a CPU tensor takes the plain path in "auto"
    tok = torch.argmax(la, -1)
    l1, ca = make_decode_step(tc)(tp, ca, tok)
    l2, _ = M.decode_step(tp, tc, cr, tok)
    assert torch.equal(l1, l2)


def test_sampled_generation_is_seeded(run):
    tc, tp, prompt = run["tc"], run["tp"], torch.as_tensor(run["prompt"])
    kw = dict(num_tokens=4, temperature=0.8, kv_block=8)
    a = generate(tp, tc, {"tokens": prompt}, seed=3, **kw)
    b = generate(tp, tc, {"tokens": prompt}, seed=3, **kw)
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < tc.vocab_size


@pytest.mark.parametrize("arch", ARCH3)
def test_launch_serve_main_on_the_cpu(arch, capsys):
    assert serve_main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "12", "--new-tokens", "3", "--temperature", "0"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{arch}-smoke: (2, 3) tokens in")
    assert out[1].startswith("prefill: ") and out[2].startswith("decode: ")


def test_init_draws_the_reference_distributions():
    """The port's own initialization (a torch.Generator, not jax.random):
    the reference's shapes, dtype and distributions per leaf kind."""
    cfg = dataclasses.replace(ARCHS["hymba-1.5b"].reduced(), param_dtype="bfloat16")
    p = M.init(cfg, torch.Generator().manual_seed(0))
    q = M.init(cfg, torch.Generator().manual_seed(0))
    leaves = lambda t: [x for v in t.values() for x in (leaves(v) if isinstance(v, dict) else [v])]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(leaves(p), leaves(q)))
    assert p["embed"].dtype == torch.bfloat16
    assert abs(float(p["embed"].float().std()) - 0.02) < 2e-3
    # fan_in divides by sqrt(shape[-2]), as the reference does: for wq
    # (L, d, H, Dh) that is the head count H = 4, not d_model
    wq = p["blocks"]["attn"]["wq"].float()
    assert abs(float(wq.std()) - 4 ** -0.5) < 0.02
    wi = p["blocks"]["mlp"]["wi"].float()  # (L, d, d_ff): d_model = 64
    assert abs(float(wi.std()) - 64 ** -0.5) < 0.01
    assert float(p["blocks"]["ssd"]["a_log"].float().min()) == 1.0
    assert float(p["blocks"]["ssd"]["dt_bias"].float().abs().max()) == 0.0
