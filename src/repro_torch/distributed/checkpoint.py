"""Crash-safe checkpoints in the reference's on-disk layout.

Port of ``repro.distributed.checkpoint`` (``save``/``restore`` and their
helpers) for nested dicts of tensors and numpy arrays:

  * step-numbered directories ``ckpt_<step>/`` holding ``manifest.json``
    (step, one entry per leaf with its ``/``-joined key, file, shape, dtype
    and byte size, and free-form ``extra`` metadata) and one
    ``leaf_<i>.npy`` per leaf;
  * leaves are numbered in JAX's flattening order (dict keys sorted at
    every level), so keys and leaf files match the reference's, and a
    checkpoint written by either package restores in the other;
  * writes go to ``ckpt_<step>.tmp``, every file and the directory are
    fsynced, then one atomic rename publishes it; a torn directory (leaf
    missing or of the wrong size) is skipped by ``latest_step``;
  * retention keeps the newest ``KEEP`` (3) checkpoints.

Restored leaves are host numpy arrays; callers move them to their device.
The reference's elastic resharding (``mesh=``) and ``AsyncCheckpointer``
wait for the multi-GPU and LM slices.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

KEEP = 3  # checkpoints kept by retention, as the reference keeps by default


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in JAX's order: dict keys sorted, ``None``
    (an empty subtree in JAX) skipped."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}{k}/")
        return out
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fsync_path(path: str) -> None:
    """fsync a file or directory so it survives a crash after rename."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree, *,
         extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous checkpoint write; returns the checkpoint path.

    Every leaf and the manifest are fsynced inside the tmp directory, the
    directory itself is fsynced, then one ``os.rename`` publishes it and
    the parent is fsynced: a crash leaves the previous checkpoint or the
    new one, never a torn directory that parses as valid."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": [], "extra": extra_meta or {}}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = _host(leaf)
        fname = f"leaf_{i}.npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        _fsync_path(fpath)
        manifest["leaves"].append({
            "key": key,
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "bytes": os.path.getsize(fpath),  # torn-write detection
            "axes": None,
        })
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)

    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # atomic publish
    _fsync_path(ckpt_dir)
    _retain(ckpt_dir, KEEP)
    return path


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"ckpt_{s}"), ignore_errors=True)


def is_intact(path: str) -> bool:
    """True iff a checkpoint directory's manifest parses and every leaf file
    it names exists with the recorded byte size (a manifest without sizes
    falls back to an existence check). A directory failing this is torn and
    is skipped by ``latest_step`` and a default ``restore``."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    for leaf in manifest.get("leaves", []):
        try:
            size = os.path.getsize(os.path.join(path, leaf["file"]))
        except OSError:
            return False
        if leaf.get("bytes") is not None and size != leaf["bytes"]:
            return False
    return True


def all_steps(ckpt_dir: str, intact_only: bool = False) -> List[int]:
    """Step numbers of the checkpoints under ``ckpt_dir`` (``intact_only``
    filters through ``is_intact``)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("ckpt_") and not name.endswith(".tmp"):
            try:
                s = int(name.split("_", 1)[1])
            except ValueError:
                continue
            if intact_only and not is_intact(os.path.join(ckpt_dir, name)):
                continue
            out.append(s)
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest intact step (torn checkpoints never win the resume race)."""
    steps = all_steps(ckpt_dir, intact_only=True)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, *, target=None):
    """Load a checkpoint; returns ``(tree, step, extra_meta)``.

    ``step=None`` takes the newest intact checkpoint. With ``target`` (a
    nested-dict prototype) the leaves are reassembled into its structure
    (``assemble``); without it a flat ``{key: array}`` dict is returned.
    Leaves are numpy arrays."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no intact checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step}")
    if not is_intact(path):
        raise RuntimeError(
            f"checkpoint {path} is torn/corrupt (manifest or leaf files "
            "missing/truncated); omit `step` to fall back to the newest "
            "intact checkpoint")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat: Dict[str, Any] = {}
    for leaf in manifest["leaves"]:
        arr = np.load(os.path.join(path, leaf["file"]))
        if str(arr.dtype) != leaf["dtype"]:
            raise ValueError(
                f"leaf {leaf['key']!r} is stored as {arr.dtype} for dtype "
                f"{leaf['dtype']}; the port restores numpy's own dtypes only")
        flat[leaf["key"]] = arr
    if target is None:
        return flat, step, manifest["extra"]
    return assemble(flat, target), step, manifest["extra"]


def assemble(flat: Dict[str, Any], target):
    """Reassemble a flat ``{key: array}`` dict (``restore(target=None)``)
    into ``target``'s nested-dict structure. Raises ``KeyError`` on leaves
    the flat dict is missing."""
    missing = [k for k, _ in _flatten_with_paths(target) if k not in flat]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()
                    if v is not None}
        return flat[prefix[:-1]]

    return build(target, "")
