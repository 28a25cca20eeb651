"""Parity of the port's LM training with the reference, on the CPU.

* ``data.synthetic_token_batches`` bit-equal to the reference's;
  ``optim.global_norm``, ``clip_by_global_norm``, ``warmup_cosine`` and
  ``constant`` against the reference's.
* ``models.lm.model.loss_fn`` and the gradient of every parameter against
  ``jax.value_and_grad`` of the reference's ``loss_fn``, for the reduced
  qwen3-0.6b (dense), mamba2-780m (ssm) and hymba-1.5b (hybrid) configs
  (2 layers, ``d_model`` 64, float32, B = 2, S = 32, ``kv_block`` 8), with
  ``ce_chunks`` 0 and 2; the port's ``remat`` (a checkpoint per layer)
  gives the same gradients as no ``remat``.
* One ``train.lm_train.make_train_step`` step against the reference's, with
  ``accum_steps`` 1 and 2 and a ``clip_norm`` below the gradient's norm:
  loss, ``grad_norm``, the new parameters, ``mu``, ``nu`` and ``step``.
* Reduced mamba2-780m and hymba-1.5b steps through the kernel seams (K6
  and K6b, hymba also K5 and K5b, their plain versions stood in) against
  the plain step: the launches a step, loss, ``grad_norm`` and moments.
* The ``lm`` workload of ``python -m repro_torch.launch.train`` on the CPU
  with the reference test's flags (``tests/test_fault_tolerance.py``),
  killed at step 7 (a process of its own) and resumed: its ``done`` line
  equals the uninterrupted run's.

Both packages start from the reference's ``M.init`` (``convert.
lm_params_from_jax``) and numpy-drawn tokens. The reference is compiled at
XLA's backend optimization level 0 (no FMA contraction; ROADMAP C,
"Rounding under jit"). Tolerances are the repo's: loss 1e-5 relative,
every gradient within 1e-4 of its leaf's largest entry + 1e-7.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data import synthetic_token_batches as jax_token_batches
from repro.models.lm import model as JM
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import constant as jax_constant
from repro.optim import global_norm as jax_global_norm
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train.lm_train import init_opt_state as jax_init_opt_state
from repro.train.lm_train import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS
from repro_torch.convert import (
    lm_params_from_jax,
    opt_state_from_jax,
    opt_state_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from repro_torch.data import synthetic_token_batches
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import model as M
from repro_torch.optim import (
    AdamWConfig,
    clip_by_global_norm,
    constant,
    global_norm,
    warmup_cosine,
)
from repro_torch.train.lm_train import (
    abstract_opt_state,
    init_opt_state,
    make_train_step,
)
from repro_torch.tree import tree_leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
B, S, KV_BLOCK = 2, 32, 8
ARCH3 = ["qwen3-0.6b", "mamba2-780m", "hymba-1.5b"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _unfused(fn, *args):
    """``fn`` jitted and compiled for ``args`` at XLA's backend optimization
    level 0, then called on them."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _assert_close(want, got, what, rtol=GRAD_RTOL, floor=GRAD_FLOOR):
    """Every leaf within ``rtol`` of its largest reference entry + ``floor``."""
    want, got = _flat(want), _flat(got)
    assert want.keys() == got.keys(), what
    for key, w in want.items():
        err = float(np.abs(got[key] - w).max())
        tol = rtol * float(np.abs(w).max()) + floor
        assert err <= tol, f"{what} {key}: {err:.3e} > {tol:.3e}"


def _batch(seed, batch=B, seq=S, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, vocab, (batch, seq)).astype(np.int32)}


def _port_loss_and_grads(params, cfg, batch, **kw):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss = M.loss_fn(tree_map(lambda _: next(it), params), cfg,
                     {k: torch.as_tensor(v) for k, v in batch.items()}, **kw)
    grads = iter(torch.autograd.grad(loss, leaves))
    return float(loss.detach()), tree_map(lambda _: next(grads).numpy(), params)


# ----------------------------------------------------------------------
# Data, clipping and schedules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("vocab,batch,seq,seed", [(256, 2, 16, 0),
                                                  (151_936, 4, 33, 7),
                                                  (40, 3, 1, 2)])
def test_synthetic_token_batches_are_bit_equal(vocab, batch, seq, seed):
    want = list(jax_token_batches(vocab, batch, seq, 3, seed=seed))
    got = list(synthetic_token_batches(vocab, batch, seq, 3, seed=seed))
    assert len(got) == len(want) == 3
    for (wt, wl), (gt, gl) in zip(want, got):
        assert gt.dtype == wt.dtype == np.int32 and gt.shape == (batch, seq)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)


def test_global_norm_and_clip_match_the_reference():
    rng = np.random.default_rng(4)
    tree = {"a": {"w": rng.standard_normal((7, 5)).astype(np.float32)},
            "b": (3 * rng.standard_normal(11)).astype(np.float32)}
    want_norm = float(jax_global_norm(tree))
    tt = params_from_jax(tree)
    assert abs(float(global_norm(tt)) - want_norm) <= 1e-6 * want_norm
    for max_norm in (0.5 * want_norm, 2.0 * want_norm):  # clipping bites, then not
        jc, jn = jax_clip(tree, max_norm)
        tc, tn = clip_by_global_norm(tt, max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        _assert_close(jax.device_get(jc), params_to_numpy(tc), "clip", 1e-6, 0.0)
    # bfloat16 leaves are scaled in float32 and cast back to bfloat16
    bf = {"w": tt["a"]["w"].to(torch.bfloat16)}
    out, _ = clip_by_global_norm(bf, 0.1)
    assert out["w"].dtype == torch.bfloat16
    want = (bf["w"].float() * (0.1 / global_norm(bf))).to(torch.bfloat16)
    assert torch.equal(out["w"], want)


def test_schedules_match_the_reference():
    steps = np.arange(0, 30)
    want = np.asarray(jax_warmup_cosine(jnp.asarray(steps), 10, 25, 0.2))
    got = warmup_cosine(torch.as_tensor(steps), 10, 25, 0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[9] < got[10] == pytest.approx(1.0) and got[29] == pytest.approx(0.2)
    for s in (0, 5, 10, 11):  # around the warm-up edge, as scalars
        assert float(warmup_cosine(s, 10, 25)) == pytest.approx(
            float(jax_warmup_cosine(s, 10, 25)), rel=1e-6, abs=1e-7)
    assert float(constant(3)) == float(jax_constant(3)) == 1.0


# ----------------------------------------------------------------------
# The loss and its gradient
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference(arch, ce_chunks):
    """The reference's parameters and ``value_and_grad`` of its ``loss_fn``
    on ``_batch(3)``, compiled once per (arch, ce_chunks) for the file."""
    jc = JARCHS[arch].reduced()
    jp = JM.init(jc, jax.random.PRNGKey(0))
    loss, grads = _unfused(
        jax.value_and_grad(lambda p, b: JM.loss_fn(p, jc, b, kv_block=KV_BLOCK,
                                                   ce_chunks=ce_chunks)),
        jp, {k: jnp.asarray(v) for k, v in _batch(3).items()})
    return jax.device_get(jp), float(loss), jax.device_get(grads)


@pytest.mark.parametrize("ce_chunks", [0, 2])
@pytest.mark.parametrize("arch", ARCH3)
def test_loss_and_gradients_match_the_reference(arch, ce_chunks):
    """The port's loss and gradients with ``ce_chunks`` 0 and 2 against the
    reference's with ``ce_chunks`` 0 (the same function: the chunks change
    only the order of the sums); for qwen3 the reference's chunked loss is
    compiled too and held the same way."""
    jp, want_loss, want_grads = _reference(
        arch, ce_chunks if arch == "qwen3-0.6b" else 0)
    tc = ARCHS[arch].reduced()
    loss, grads = _port_loss_and_grads(lm_params_from_jax(jp, tc), tc, _batch(3),
                                       kv_block=KV_BLOCK, ce_chunks=ce_chunks)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_close(want_grads, grads, f"{arch} grad")


@pytest.mark.parametrize("ce_chunks", [0, 2])
def test_remat_gives_the_same_gradients(ce_chunks):
    """A checkpoint per layer recomputes the layer in the backward: the
    loss and every gradient are the same bits as without it."""
    tc = ARCHS["qwen3-0.6b"].reduced()
    params = M.init(tc, torch.Generator().manual_seed(2))
    batch = _batch(5)
    (want_loss, want), (loss, got) = (
        _port_loss_and_grads(params, dataclasses.replace(tc, remat=remat), batch,
                             kv_block=KV_BLOCK, ce_chunks=ce_chunks)
        for remat in (False, True))
    assert loss == want_loss
    for key, w in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[key], w, err_msg=key)


def test_unported_forwards_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        M.loss_fn({}, ARCHS["whisper-large-v3"],
                  {"tokens": torch.zeros((1, 4), dtype=torch.int32),
                   "labels": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        abstract_opt_state(ARCHS["qwen3-0.6b"], mesh=object())
    st = abstract_opt_state(ARCHS["qwen3-0.6b"].reduced())
    spec = M.param_specs(ARCHS["qwen3-0.6b"].reduced())
    assert st["step"].dtype == torch.int32 and st["step"].device.type == "meta"
    assert st["mu"]["embed"].shape == spec["embed"].shape
    assert st["nu"]["blocks"]["attn"]["wq"].dtype == torch.float32


# ----------------------------------------------------------------------
# The train step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_the_reference(accum_steps):
    jc, tc = JARCHS["qwen3-0.6b"].reduced(), ARCHS["qwen3-0.6b"].reduced()
    jp = JM.init(jc, jax.random.PRNGKey(1))
    js = jax_init_opt_state(jp)
    batch = _batch(11, batch=4)
    clip, lr = 0.5, 1e-3
    jstep = jax_make_train_step(jc, JaxAdamWConfig(lr=lr), clip_norm=clip,
                                kv_block=KV_BLOCK, accum_steps=accum_steps)
    wp, ws, wm = jax.device_get(_unfused(
        jstep, jp, js, {k: jnp.asarray(v) for k, v in batch.items()}))
    assert float(wm["grad_norm"]) > 2 * clip  # clipping bites

    tp = lm_params_from_jax(jax.device_get(jp), tc)
    ts = opt_state_from_jax(jax.device_get(js))
    step = make_train_step(tc, AdamWConfig(lr=lr), clip_norm=clip,
                           kv_block=KV_BLOCK, accum_steps=accum_steps)
    gp, gs, gm = step(tp, ts, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert gp is tp  # updated in place
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= LOSS_RTOL * float(wm["loss"])
    assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) <= (
        GRAD_RTOL * float(wm["grad_norm"]))
    got = opt_state_to_numpy(gs)
    assert int(got["step"]) == int(ws["step"]) == 1
    # mu = 0.1 g and nu = 0.001 g^2 of the clipped gradient g
    _assert_close(ws["mu"], got["mu"], "mu")
    _assert_close(ws["nu"], got["nu"], "nu", 2 * GRAD_RTOL, GRAD_FLOOR ** 2)
    # The first AdamW step moves each entry by ~lr sign(g), so an entry whose
    # gradient is inside its tolerance band around 0 may move either way;
    # every other entry lands on the reference's value.
    band = {k: np.abs(v) <= GRAD_RTOL * np.abs(v).max() + GRAD_FLOOR
            for k, v in _flat(ws["mu"]).items()}
    for key, w in _flat(wp).items():
        g = _flat(params_to_numpy(gp))[key]
        err = np.where(band[key], 0.0, np.abs(g - w))
        assert float(err.max()) <= 1e-6 * float(np.abs(w).max()), key
        assert float(np.abs(g - w).max()) <= 2.01 * lr, key


def _kernel_path(monkeypatch):
    """The train step's kernel path on the CPU: K5, K5b, K6 and K6b stood in
    for by their plain versions (recording each call), ``use_kernel``
    taking the kernel path for every mode but "ref"; returns the calls."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.models.lm import layers as lm_layers

    calls = []

    def k5(q, k, v, *, causal, window, layout, return_lse=False):
        calls.append("K5")
        T = (lambda t: t.transpose(1, 2)) if layout == "bshd" else (lambda t: t)
        o, lse = fa.flash_attention_lse_ref(T(q), T(k), T(v), causal=causal, window=window)
        return (T(o), lse) if return_lse else T(o)

    def k5b(*args, **kw):
        calls.append("K5b")
        return fa.flash_attention_bwd_ref(*args, **kw)

    def k6(*args, keep=False):
        calls.append("K6")
        out = sc.ssd_chunk_ref(*args)
        return (*out, None) if keep else out  # float32: K6 keeps no states

    def k6b(*args, kept=None):
        calls.append("K6b")
        return sc.ssd_chunk_bwd_ref(*args)

    monkeypatch.setattr(fa_ops, "_FWD", k5)
    monkeypatch.setattr(fa_ops, "_BWD", k5b)
    monkeypatch.setattr(ssd_ops, "_FWD", k6)
    monkeypatch.setattr(ssd_ops, "_BWD", k6b)
    for mod in (fa_ops, ssd_ops, lm_layers):
        monkeypatch.setattr(mod, "use_kernel", lambda mode, x: mode != "ref")
    return calls


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_ssm_and_hybrid_train_steps_go_through_k6_and_k6b(arch, monkeypatch):
    """A reduced mamba2 or hymba step (remat) on the kernel path, K6 and K6b
    (and hymba's K5 and K5b) stood in by their plain versions, against the
    same step with ``mode="ref"`` from the same state: each forward kernel
    twice a layer and each backward kernel once, in that order per layer;
    the loss, ``grad_norm``, ``mu`` and ``nu`` within the repo's
    tolerances, every parameter within two steps of the plain one."""
    calls = _kernel_path(monkeypatch)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), remat=True)
    batch = {k: torch.as_tensor(v) for k, v in _batch(13, seq=40).items()}
    lr = 1e-3
    out = {}
    for mode in ("auto", "ref"):
        params = M.init(cfg, torch.Generator().manual_seed(5))
        step = make_train_step(cfg, AdamWConfig(lr=lr), kv_block=KV_BLOCK, mode=mode)
        p, s, m = step(params, init_opt_state(params), batch)
        out[mode] = (params_to_numpy(p), opt_state_to_numpy(s), m)
    n = cfg.num_layers
    fwd = ["K5", "K6"] if arch == "hymba-1.5b" else ["K6"]
    bwd = ["K5b", "K6b"] if arch == "hymba-1.5b" else ["K6b"]
    assert sorted(calls) == sorted(fwd * 2 * n + bwd * n)
    assert calls[:len(fwd) * n] == fwd * n  # the forward, layer by layer
    (gp, gs, gm), (wp, ws, wm) = out["auto"], out["ref"]
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= LOSS_RTOL * float(wm["loss"])
    assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) <= (
        GRAD_RTOL * float(wm["grad_norm"]))
    _assert_close(ws["mu"], gs["mu"], "mu")
    _assert_close(ws["nu"], gs["nu"], "nu", 2 * GRAD_RTOL, GRAD_FLOOR ** 2)
    for key, w in _flat(wp).items():
        assert float(np.abs(_flat(gp)[key] - w).max()) <= 2.01 * lr, key


# ----------------------------------------------------------------------
# The CLI: kill and resume
# ----------------------------------------------------------------------
def _flags(ckpt_dir):
    return ["--device", "cpu", "--workload", "lm", "--arch", "qwen3-0.6b",
            "--reduced", "--steps", "12", "--batch-size", "2", "--seq-len", "16",
            "--ckpt-every", "4", "--log-every", "4", "--ckpt-dir", str(ckpt_dir)]


def _done(stdout):
    return [ln for ln in stdout.splitlines() if ln.startswith("done")][-1]


def test_cli_kill_and_resume_ends_on_the_same_bits(tmp_path, capsys):
    """The run killed at step 7 is a process of its own (it exits with
    ``os._exit``), with this process's thread count; the uninterrupted and
    the resumed runs call the CLI's ``main`` here."""
    assert launch_train.main(_flags(tmp_path / "clean")) == 0
    clean = _done(capsys.readouterr().out)

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *_flags(tmp_path / "crash"), "--simulate-failure", "7"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 42, out.stderr[-2000:]
    assert "failure-injection" in out.stdout and "step 4:" in out.stdout
    assert launch_train.main(_flags(tmp_path / "crash") + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored step 4" in out
    assert "step 4:" not in out  # consumed batches are skipped
    assert _done(out) == clean
