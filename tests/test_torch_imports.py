"""The PyTorch port imports neither JAX nor anything of the reference.

The machine with the GPU has no JAX, and importing any ``repro.core``
module loads it, so ``repro_torch`` keeps its own copies of what it needs.
"""

from __future__ import annotations

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro[\s.])",
    re.MULTILINE)


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_modules_load_no_jax_and_no_reference():
    names = _port_modules()
    assert {"repro_torch.kernels.temporal_attention.kernel",
            "repro_torch.optim.adamw", "repro_torch.obs.telemetry",
            "repro_torch.distributed.checkpoint",
            "repro_torch.kernels.segment_reduce.kernel",
            "repro_torch.kernels.segment_reduce.ops",
            "repro_torch.kernels.segment_reduce.ref",
            "repro_torch.core.discretize", "repro_torch.nn.graph_conv",
            "repro_torch.models.tg.snapshot", "repro_torch.core.sampler",
            "repro_torch.core.tg_hooks", "repro_torch.nn.recurrent",
            "repro_torch.models.tg.tgn",
            "repro_torch.kernels.temporal_attention.ops",
            "repro_torch.kernels.temporal_attention.ref",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.archs", "repro_torch.configs.hymba_1_5b",
            "repro_torch.configs.qwen3_0_6b", "repro_torch.configs.mamba2_780m",
            "repro_torch.models.lm.params", "repro_torch.models.lm.layers",
            "repro_torch.models.lm.model",
            "repro_torch.kernels.flash_attention.kernel",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref",
            "repro_torch.kernels.ssd_chunk.kernel",
            "repro_torch.kernels.ssd_chunk.ops",
            "repro_torch.kernels.ssd_chunk.ref",
            "repro_torch.serve.decode", "repro_torch.launch.serve",
            "repro_torch.launch.train", "repro_torch.train.tg_trainer",
            "repro_torch.core.events", "repro_torch.nn.norm",
            "repro_torch.models.tg.graphmixer", "repro_torch.models.tg.dygformer",
            "repro_torch.models.tg.tpnet", "repro_torch.core.device_uniform",
            "repro_torch.storage", "repro_torch.storage.base",
            "repro_torch.storage.memory", "repro_torch.storage.mmap",
            "repro_torch.storage.windows", "repro_torch.storage.csr",
            "repro_torch.models.tg.edgebank", "repro_torch.serve.faults",
            "repro_torch.serve.graph_service", "repro_torch.obs.profiler",
            "repro_torch.utils", "repro_torch.utils.prof",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.dp_trainer",
            "repro_torch.launch.mesh", "repro_torch.optim.clip",
            "repro_torch.optim.schedule", "repro_torch.data.tokens",
            "repro_torch.train.lm_train"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "'jax.') or m == 'jaxlib' or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_sources_have_no_jax_or_reference_import(path):
    assert not _FORBIDDEN.search(path.read_text()), path


def test_entry_points_default_to_cuda(monkeypatch):
    import torch

    from repro_torch.core import DeviceRecencySampler, PrefetchLoader, snapshot_tensor
    from repro_torch.data import generate
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec
    from repro_torch.train.loop import CTDGLinkPipeline, DTDGLinkPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceRecencySampler(10, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment().compile()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(model=ModelSpec("tgat", {"num_layers": 1})).run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CTDGLinkPipeline("tgat", generate("tiny"),
                         model_kwargs={"num_layers": 1})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrefetchLoader([])
    # TGN and the host sampler (the quickstart's default) run on the card too.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CTDGLinkPipeline("tgn", generate("tiny"), sampler_spec=SamplerSpec(k=10))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(data=DataSpec("tiny"), model=ModelSpec("tgn"),
                   sampler=SamplerSpec(kind="recency", k=10)).compile()
    snapshots = Experiment(data=DataSpec("tiny", discretization="h"),
                           model=ModelSpec("gclstm", {"d_embed": 64}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        snapshots.compile()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DTDGLinkPipeline("gclstm", generate("tiny"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        snapshot_tensor(generate("tiny"), "h")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate("tiny").to_snapshots("h")
    # The rest of the CTDG zoo and the uniform samplers.
    from repro_torch.core import DeviceUniformSampler

    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceUniformSampler(10, 4)
    for name in ("graphmixer", "dygformer", "tpnet"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CTDGLinkPipeline(name, generate("tiny"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(data=DataSpec("tiny"), sampler=SamplerSpec(kind="uniform")).compile()
    # LM serving (the launch entry point defaults to --device cuda).
    from repro_torch.launch.serve import main as serve_main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--arch", "hymba-1.5b", "--reduced"])
    # The online graph service and its learned tier (storage, serving and
    # profiler slice).
    from repro_torch.serve import OnlineGraphService
    from repro_torch.serve.graph_service import learned_link_params

    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineGraphService(10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        learned_link_params(0, 10)
    DeviceRecencySampler(10, 4, device="cpu")  # the explicit CPU path runs


def test_classic_attention_kernels_import_without_jax():
    """K3, its backward kernel K3b, their plain versions and the launch-plan
    mirror import from the port alone, and the autograd Function's two
    launches are the two kernels."""
    code = (
        "import sys\n"
        "from repro_torch.kernels.temporal_attention import (\n"
        "    ta_plan, temporal_attention_bwd_kernel, temporal_attention_bwd_ref,\n"
        "    temporal_attention_kernel, temporal_attention_ref)\n"
        "import repro_torch.kernels.temporal_attention.ops as ops\n"
        "assert ops._TA_FWD is temporal_attention_kernel\n"
        "assert ops._TA_BWD is temporal_attention_bwd_kernel\n"
        "assert ta_plan(600, 10, 2, 50, __import__('torch').float32, True)['chunk'] == 10\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# Verbatim copies of reference modules keep the reference's docstrings.
_COPIED = {"repro_torch.core.batch", "repro_torch.core.hooks"}


@pytest.mark.parametrize("name", [n for n in _port_modules() if n not in _COPIED])
def test_port_public_api_docstrings(name):
    import importlib
    import inspect

    m = importlib.import_module(name)
    missing = [] if inspect.getdoc(m) else [name]
    for attr, obj in vars(m).items():
        if attr.startswith("_") or getattr(obj, "__module__", None) != name:
            continue
        if (inspect.isfunction(obj) or inspect.isclass(obj)) and not inspect.getdoc(obj):
            missing.append(attr)
        if inspect.isclass(obj):
            missing += [f"{attr}.{k}" for k, v in vars(obj).items()
                        if not k.startswith("_") and inspect.isfunction(v)
                        and not inspect.getdoc(v)]
    assert missing == []


def test_init_distributed_takes_the_named_backend_and_the_local_card(monkeypatch):
    """``init_distributed`` reads the launcher's environment, makes the
    rank's card ``cuda:{LOCAL_RANK}`` current by default (or the device
    the caller names), and starts the group with the backend it is given;
    without a GPU the CUDA default raises."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set", d)))
    for key, value in {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "3"}.items():
        monkeypatch.setenv(key, value)
    assert mesh.init_distributed("nccl") == torch.device("cuda", 3)
    assert calls == [("set", torch.device("cuda", 3)),
                     ("nccl", {"init_method": "env://", "rank": 5,
                               "world_size": 8})]
    calls.clear()
    assert mesh.init_distributed("gloo", device="cuda:0") == torch.device("cuda", 0)
    assert calls[-1][0] == "gloo" and calls[0] == ("set", torch.device("cuda", 0))
    calls.clear()
    assert mesh.init_distributed("gloo", device="cpu") == torch.device("cpu")
    assert [c[0] for c in calls] == ["gloo"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.init_distributed("nccl")
