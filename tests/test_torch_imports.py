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
            "repro_torch.distributed.checkpoint"} <= set(names)
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

    from repro_torch.core import DeviceRecencySampler, PrefetchLoader
    from repro_torch.data import generate
    from repro_torch.tg import Experiment, ModelSpec
    from repro_torch.train.loop import CTDGLinkPipeline

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
    DeviceRecencySampler(10, 4, device="cpu")  # the explicit CPU path runs


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
