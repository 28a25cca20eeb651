"""How far a float32 LM train step's gradients lie from a float64 one, on
the card: the kernel path, the plain path and the two mixed paths (one of
attention and the SSD scan on its kernel, the other plain), each against
the plain path in float64, per parameter leaf (largest error over the
leaf's largest entry), and the kernel path against the plain path in
float32. This is what sets the tolerance of ``chip_smoke.py``'s float32
step with an SSD scan (``SSM_F32_GRAD_RTOL``).

    python3 scripts/lm_f32_grad_noise.py [--arch hymba-1.5b] [--layers 2]

Seeded random parameters and synthetic tokens (B = 4 x S = 4,096, as
``chip_smoke.py``'s train steps); prints one JSON object. The float64 step
keeps the model's own float32 islands (dt's softplus, A, the loss's sums).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_f32_grad_noise: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic_token_batches
    from repro_torch.kernels import _build
    from repro_torch.models.lm import layers as L
    from repro_torch.models.lm import model as M
    from repro_torch.tree import tree_leaves, tree_map

    _build.build_all()
    dev = "cuda"
    cfg32 = dataclasses.replace(get_arch(args.arch), num_layers=args.layers,
                                param_dtype="float32", compute_dtype="float32")
    cfg64 = dataclasses.replace(cfg32, param_dtype="float64", compute_dtype="float64")
    params = M.init(cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    tokens, labels = next(iter(synthetic_token_batches(
        cfg32.vocab_size, args.batch, args.seq_len, 1, seed=0)))
    batch = {"tokens": torch.as_tensor(tokens, device=dev),
             "labels": torch.as_tensor(labels, device=dev)}

    def paths(tree, pre=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from paths(v, f"{pre}/{k}")
        else:
            yield pre

    names = list(paths(params))

    def grads(cfg, dtype, mode, plain=None):
        """The loss and the float64 copies of its gradients; ``plain`` names
        the block ("ssd" or "attn") forced onto its plain version."""
        leaves = [p.detach().to(dtype).requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        tree = tree_map(lambda _: next(it), params)
        orig = {"ssd": L.ssd_mix, "attn": L.self_attention}
        if plain == "ssd":
            L.ssd_mix = lambda *a, **k: orig["ssd"](*a, **{**k, "mode": "ref"})
        if plain == "attn":
            L.self_attention = lambda *a, **k: orig["attn"](*a, **{**k, "mode": "ref"})
        try:
            loss = M.loss_fn(tree, cfg, batch, kv_block=1024, mode=mode)
            g = torch.autograd.grad(loss, leaves)
        finally:
            L.ssd_mix, L.self_attention = orig["ssd"], orig["attn"]
        return float(loss.detach()), [x.double() for x in g]

    def leaf_rel(got, want):
        return {n: float((a - b).abs().max() / b.abs().max())
                for n, a, b in zip(names, got, want)}

    t0 = time.perf_counter()
    loss64, truth = grads(cfg64, torch.float64, "ref")
    runs = {"kernels": ("auto", None), "plain": ("ref", None),
            "kernels_ssd_plain": ("auto", "ssd"), "kernels_attn_plain": ("auto", "attn")}
    out = {"arch": args.arch, "layers": args.layers, "B": args.batch, "S": args.seq_len,
           "float64_loss": loss64, "vs_float64": {}}
    got = {}
    for name, (mode, plain) in runs.items():
        loss, g = grads(cfg32, torch.float32, mode, plain)
        got[name] = g
        rel = leaf_rel(g, truth)
        out["vs_float64"][name] = {"loss_rel": abs(loss - loss64) / abs(loss64),
                                   "max_leaf_rel": max(rel.values()), "by_leaf": rel}
    rel = leaf_rel(got["kernels"], got["plain"])
    out["kernels_vs_plain"] = {"max_leaf_rel": max(rel.values()), "by_leaf": rel}
    out["seconds"] = time.perf_counter() - t0
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
