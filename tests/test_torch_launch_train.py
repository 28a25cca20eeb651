"""The port's training entry points: the CLI's kill and resume, the
background checkpointer, the legacy trainer and the event types.

* ``python -m repro_torch.launch.train`` on the CPU (``--device cpu``) as
  ``tests/test_fault_tolerance.py`` drives the reference: the ``tg``
  workload (its default model, 2-layer TGAT with k = 20, and ``--model
  tpnet`` as the reference's ``test_tg_workload_resume`` runs it) killed
  after an epoch and resumed; the ``dtdg`` workload (GCLSTM) killed
  mid-epoch and resumed to a bit-identical final test MRR; the ``lm``
  workload runs the reduced qwen3 and ends on its ``done`` line (its kill
  and resume: ``tests/test_torch_lm_train.py``).
* ``AsyncCheckpointer``: a tree updated in place after ``save()`` restores
  to its values at ``save()``; retention; ``close()`` twice; a failed write
  raises on the caller's thread.
* ``LinkPredictionTrainer``'s legacy kwargs give the reference's
  ``SamplerSpec`` (the legacy uniform kwargs build the port's uniform hook,
  its sampler state equal to the reference's); ``EdgeEvent``/``NodeEvent``
  have the reference's fields.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import repro.core.events as jevents
from repro.data import generate as jax_generate
from repro.train.tg_trainer import LinkPredictionTrainer as JaxTrainer
from repro_torch.core import EdgeEvent, NodeEvent
from repro_torch.data import generate
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch import train as launch_train
from repro_torch.train import tg_trainer
from repro_torch.train.tg_trainer import LinkPredictionTrainer, legacy_sampler_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu"]
    return subprocess.run(cmd + args, capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)


def _final(out):
    return [ln for ln in out.stdout.splitlines() if "final test MRR" in ln][-1]


def test_tg_workload_kill_and_resume(tmp_path):
    base = ["--workload", "tg", "--dataset", "tiny", "--data-scale", "0.2",
            "--epochs", "2", "--batch-size", "64", "--ckpt-dir", str(tmp_path)]
    out = _cli(base + ["--simulate-failure", "0"])
    assert out.returncode == 42, out.stderr[-2000:]
    assert "failure-injection" in out.stdout and "epoch 0:" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 0
    out = _cli(base + ["--resume"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[resume] restored epoch 0" in out.stdout
    assert "epoch 0:" not in out.stdout and "epoch 1:" in out.stdout
    assert 0.0 < float(_final(out).split()[3]) <= 1.0


def test_tg_workload_resume_tpnet(tmp_path):
    """The reference's ``tests/test_fault_tolerance.py::test_tg_workload_resume``
    against the port's CLI: TPNet on ``tiny`` at data scale 0.2, killed
    after epoch 0 and resumed."""
    cmd = ["--workload", "tg", "--model", "tpnet", "--dataset", "tiny",
           "--data-scale", "0.2", "--epochs", "2", "--batch-size", "64",
           "--ckpt-dir", str(tmp_path)]
    out = _cli(cmd + ["--simulate-failure", "0"])
    assert out.returncode == 42, out.stderr[-2000:]
    out = _cli(cmd + ["--resume"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[resume]" in out.stdout
    assert "final test MRR" in out.stdout
    assert 0.0 < float(_final(out).split()[3]) <= 1.0


def test_dtdg_mid_epoch_resume_is_bit_identical(tmp_path):
    base = ["--workload", "dtdg", "--model", "gclstm", "--dataset", "tiny",
            "--data-scale", "0.3", "--epochs", "2", "--chunk-size", "4",
            "--discretization", "h"]
    out = _cli(base + ["--ckpt-dir", str(tmp_path / "clean")])
    assert out.returncode == 0, out.stderr[-2000:]
    clean = _final(out)
    # Killed after 3 chunks: mid-epoch, since an epoch has more than 3.
    out = _cli(base + ["--ckpt-dir", str(tmp_path / "crash"),
                       "--simulate-failure", "3"])
    assert out.returncode == 42 and "failure-injection" in out.stdout
    out = _cli(base + ["--ckpt-dir", str(tmp_path / "crash"), "--resume"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[resume] restored step" in out.stdout and "cursor 12" in out.stdout
    assert _final(out) == clean


def test_tg_defaults_build_two_layer_tgat(tmp_path, monkeypatch):
    """The CLI's defaults (``--model tgat``, ``--k 20``) build the
    reference's default TGAT: two layers, two hops of 20."""
    seen = []

    class Spy(LinkPredictionTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)

    monkeypatch.setattr(tg_trainer, "LinkPredictionTrainer", Spy)
    rc = launch_train.main(["--device", "cpu", "--epochs", "0",
                            "--data-scale", "0.2", "--batch-size", "64",
                            "--ckpt-dir", str(tmp_path)])
    assert rc == 0 and len(seen) == 1
    tr = seen[0]
    assert tr.cfg.num_layers == 2 and tr.cfg.k == 20
    hops = [h.num_hops for h in tr.manager.hooks() if hasattr(h, "num_hops")]
    assert hops == [2] and not tr.sampler_spec.device


def test_lm_workload_runs_and_prints_the_done_line(tmp_path, capsys):
    """``--workload lm`` trains the reduced qwen3-0.6b on the CPU and ends on
    the reference's ``done: final loss`` line (kill and resume:
    ``tests/test_torch_lm_train.py``)."""
    rc = launch_train.main(["--workload", "lm", "--device", "cpu", "--reduced",
                            "--steps", "2", "--batch-size", "2", "--seq-len",
                            "16", "--log-every", "1", "--ckpt-every", "1",
                            "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and [ln.split(":")[0] for ln in lines] == ["step 0", "step 1", "done"]
    assert lines[-1].startswith("done: final loss ")
    assert ckpt.latest_step(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------
def _tree():
    return {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "b": torch.zeros(3)},
            "opt": {"step": torch.tensor(4, dtype=torch.int32),
                    "mu": np.ones(3, np.float32)}}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.array(tree.numpy() if isinstance(tree, torch.Tensor) else tree)


def test_save_snapshots_before_in_place_updates(tmp_path, monkeypatch):
    """The worker writes only after the tree was updated in place (it waits
    on an event), yet the checkpoint holds the values at ``save()``."""
    gate = threading.Event()
    real = ckpt.save

    def held_save(*a, **kw):
        gate.wait(10)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "save", held_save)
    tree = _tree()
    want = _numpy(tree)
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    w.save(7, tree, extra_meta={"epoch": 7})
    with torch.no_grad():  # the optimizer's kind of update
        tree["params"]["w"].mul_(-3.0).add_(1.0)
        tree["params"]["b"].add_(2.0)
        tree["opt"]["step"].add_(1)
    tree["opt"]["mu"] *= 5.0
    gate.set()
    w.close()
    got, step, extra = ckpt.restore(str(tmp_path), target=want)
    assert step == 7 and extra == {"epoch": 7}
    for k in ("params", "opt"):
        for leaf in want[k]:
            assert np.array_equal(got[k][leaf], want[k][leaf]), (k, leaf)


def test_keep_retention_and_close_twice(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in range(5):
        w.save(step, _tree())
    w.wait()
    assert sorted(ckpt.all_steps(str(tmp_path))) == [3, 4]
    w.close()
    w.close()  # a second close does nothing
    with pytest.raises(RuntimeError, match="closed"):
        w.save(5, _tree())


def test_a_failed_write_raises_on_the_caller(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save", broken)
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    w.save(0, _tree())
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        w.wait()


# ---------------------------------------------------------------------------
# Legacy trainer and events
# ---------------------------------------------------------------------------
LEGACY = {
    "host": dict(k=7, prefetch=3, uniform_checkpoint_adjacency=False),
    "device": dict(k=5, device_sampling=True, prefetch=1),
}


@pytest.mark.parametrize("case", sorted(LEGACY))
def test_legacy_kwargs_give_the_reference_sampler_spec(case):
    kw = LEGACY[case]
    model = dict(batch_size=64, eval_negatives=3, model_kwargs={"num_layers": 1})
    jt = JaxTrainer("tgat", jax_generate("tiny", scale=0.2), **model, **kw)
    tt = LinkPredictionTrainer("tgat", generate("tiny", scale=0.2), **model,
                               **kw, device="cpu")
    assert tt.sampler_spec.to_dict() == jt.sampler_spec.to_dict()
    assert tt.sampler_spec.k == kw["k"] == tt.cfg.k


def test_legacy_trainer_takes_the_reference_kwargs_and_passes_store_and_shards(monkeypatch):
    """The reference's trainer is a bare alias of its pipeline: each of its
    keyword arguments is one of the port's trainer's, and ``store=`` and
    ``data_shards=`` reach ``CTDGLinkPipeline`` as given."""
    import inspect

    ours = inspect.signature(LinkPredictionTrainer.__init__).parameters
    theirs = inspect.signature(JaxTrainer.__init__).parameters
    assert set(theirs) <= set(ours), set(theirs) - set(ours)
    seen = {}

    def spy(self, *a, **kw):
        seen.update(kw)

    monkeypatch.setattr(tg_trainer.CTDGLinkPipeline, "__init__", spy)
    store = object()
    LinkPredictionTrainer("tgat", None, store=store, data_shards=2, device="cpu")
    assert seen["store"] is store and seen["data_shards"] == 2
    seen.clear()
    LinkPredictionTrainer("tgat", None, device="cpu")
    assert seen["store"] is None and seen["data_shards"] == 1


def test_legacy_uniform_sampler_maps_and_is_not_ported_yet():
    """The name is kept from the slices before the uniform sampler was
    ported. The legacy ``sampler="uniform"`` kwargs map to the reference's
    ``SamplerSpec`` and now build the port's host ``UniformNeighborHook``,
    whose sampler state (CSR over the full stream, counter-only with
    ``uniform_checkpoint_adjacency=False``, and after a draw) equals the
    reference trainer's."""
    from repro_torch.core.tg_hooks import UniformNeighborHook

    kw = dict(sampler="uniform", k=4, uniform_checkpoint_adjacency=False)
    jt = JaxTrainer("tgat", jax_generate("tiny", scale=0.2), batch_size=64,
                    model_kwargs={"num_layers": 1}, **kw)
    assert legacy_sampler_spec(**kw).to_dict() == jt.sampler_spec.to_dict()
    tt = LinkPredictionTrainer("tgat", generate("tiny", scale=0.2),
                               batch_size=64, device="cpu",
                               model_kwargs={"num_layers": 1}, **kw)
    assert tt.sampler_spec.to_dict() == jt.sampler_spec.to_dict()
    hooks = [h for h in tt.manager.hooks() if isinstance(h, UniformNeighborHook)]
    jhooks = [h for h in jt.manager.hooks() if hasattr(h, "sampler")]
    assert len(hooks) == len(jhooks) == 1 and hooks[0].k == 4
    port, ref = hooks[0].sampler, jhooks[0].sampler
    for name in ("_adj_nbr", "_adj_t", "_adj_e", "_indptr"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    seeds, qt = np.arange(8), np.full(8, 10**6)
    port.sample(seeds, qt)
    ref.sample(seeds, qt)
    want = ref.state_dict()
    got = port.state_dict()
    assert sorted(got) == sorted(want) == ["counter"]
    assert int(got["counter"]) == int(want["counter"]) == 1


@pytest.mark.parametrize("name", ["EdgeEvent", "NodeEvent"])
def test_events_have_the_reference_fields(name):
    mine, ref = {"EdgeEvent": EdgeEvent, "NodeEvent": NodeEvent}[name], getattr(jevents, name)

    def fields(cls):
        return [(f.name, str(f.type), f.default) for f in dataclasses.fields(cls)]

    assert fields(mine) == fields(ref)
    values = dict(t=5, src=1, dst=2) if name == "EdgeEvent" else dict(t=5, node=3)
    assert dataclasses.asdict(mine(**values)) == dataclasses.asdict(ref(**values))
    with pytest.raises(dataclasses.FrozenInstanceError):
        mine(**values).t = 6
