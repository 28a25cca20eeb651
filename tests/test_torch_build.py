"""The port's kernel build keys (``repro_torch/kernels/_build.py``), on the CPU.

No ``nvcc`` runs here: the tests hold the library names, which carry a hash
of everything a source is compiled from. An edit to a shared header of
``kernels/csrc_common/`` must rebuild every library (each source has it on
its include path), an edit to a header beside a source must rebuild that
source's library, and ``sources()`` finds the ``*.cu`` files and nothing
else.
"""

from __future__ import annotations

import shutil

import pytest

from repro_torch.kernels import _build


def test_sources_are_exactly_the_cuda_files():
    found = _build.sources()
    want = sorted(_build.KERNELS_DIR.glob("*/csrc/*.cu"))
    assert found == want and len(found) >= 8
    assert all(p.suffix == ".cu" and p.parent.name == "csrc" for p in found)
    assert not any(p.parent == _build.COMMON_DIR for p in found)
    assert (_build.COMMON_DIR / "hopper.cuh").is_file()


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of the kernel sources and the shared headers, with ``_build``
    pointed at it."""
    kernels = tmp_path / "kernels"
    for src in _build.sources():
        dst = kernels / src.parent.parent.name / "csrc"
        dst.mkdir(parents=True, exist_ok=True)
        for f in src.parent.iterdir():
            if f.suffix in (".cu", ".cuh"):
                shutil.copy(f, dst / f.name)
    shutil.copytree(_build.COMMON_DIR, kernels / "csrc_common")
    monkeypatch.setattr(_build, "KERNELS_DIR", kernels)
    monkeypatch.setattr(_build, "COMMON_DIR", kernels / "csrc_common")
    monkeypatch.setattr(_build, "BUILD_DIR", kernels / "_build")
    return kernels


def _paths():
    return {src.name: _build.library_path(src) for src in _build.sources()}


def test_a_shared_header_edit_changes_every_library_path(tree):
    before = _paths()
    assert len(set(before.values())) == len(before)
    again = _paths()
    assert again == before  # the key is a function of the bytes
    hdr = tree / "csrc_common" / "hopper.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n// one more line\n")
    after = _paths()
    assert all(after[name] != before[name] for name in before)
    assert all(p.parent == _build.BUILD_DIR for p in after.values())


def test_a_new_shared_header_changes_every_library_path(tree):
    before = _paths()
    (tree / "csrc_common" / "extra.cuh").write_text("#pragma once\n")
    after = _paths()
    assert all(after[name] != before[name] for name in before)


def test_a_local_header_edit_changes_only_its_sources(tree):
    before = _paths()
    hdr = tree / "ssd_chunk" / "csrc" / "ssd_chunk.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n")
    after = _paths()
    for name in before:
        changed = name in ("ssd_chunk.cu", "ssd_chunk_bwd.cu")
        assert (after[name] != before[name]) == changed, name


def test_the_shared_headers_are_on_the_include_path(tree):
    src = tree / "flash_attention" / "csrc" / "flash_attention_bwd.cu"
    assert _build.headers(src)[-1] == tree / "csrc_common" / "hopper.cuh"
    assert '#include "hopper.cuh"' in src.read_text()
    assert not (src.parent / "hopper.cuh").exists()
