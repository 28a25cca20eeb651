"""Snapshot (DTDG) models: GCN, GCLSTM, T-GCN.

Port of ``repro.models.tg.snapshot``. Every model operates on discretized
snapshots (padded COO edge lists of a fixed capacity, the ``SnapshotTensor``
rows built by ``core.loader.snapshot_tensor``) and a learned node embedding
table, and maps a snapshot and its recurrent state to per-node embeddings
Z (N, d); link prediction on snapshot t+1 is decoded from Z of snapshot t.

The ``init_params`` / ``init_state`` / ``make_apply`` registry gives every
model the reference's contract: ``apply(params, src, dst, mask, state) ->
(z, state)`` with the state ``()`` for the stateless GCN, a ``(h, c)`` tuple
for GCLSTM and one (N, d_embed) tensor for T-GCN. The reference scans that
function over an epoch; the port's ``DTDGLinkPipeline`` calls it in a loop.
``apply``'s ``mode`` goes to every segment sum (``nn.graph_conv``).
Parameters are drawn from a ``torch.Generator`` with the reference's
distributions and keys; parity tests move the reference's in with
``repro_torch.convert.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.models.tg.common import link_decoder_init
from repro_torch.nn.graph_conv import gcn, gcn_init, gcn_layer, gcn_layer_init
from repro_torch.nn.init import normal
from repro_torch.nn.linear import dense, dense_init


@dataclasses.dataclass(frozen=True)
class SnapshotConfig:
    """Shared DTDG model hyperparameters (node count, widths, depth)."""

    num_nodes: int
    d_node: int = 256
    d_embed: int = 128
    num_layers: int = 2


# ----------------------------------------------------------------------
# GCN: snapshot-independent encoder
# ----------------------------------------------------------------------
def gcn_model_init(gen, cfg: SnapshotConfig, device="cpu"):
    """Init GCN params: embedding table + GCN stack + link decoder."""
    dims = [cfg.d_node] + [cfg.d_embed] * cfg.num_layers
    return {
        "emb": normal(gen, (cfg.num_nodes, cfg.d_node), 0.02, device),
        "gcn": gcn_init(gen, dims, device),
        "decoder": link_decoder_init(gen, cfg.d_embed, device=device),
    }


def gcn_model_apply(params, cfg: SnapshotConfig, src, dst, edge_mask, *,
                    mode: str = "auto"):
    """Per-node embeddings Z from one padded snapshot (stateless)."""
    return gcn(params["gcn"], params["emb"], src, dst, edge_mask,
               cfg.num_nodes, mode=mode)


# ----------------------------------------------------------------------
# GCLSTM (Chen et al., 2018): LSTM whose hidden transforms are GCNs
# ----------------------------------------------------------------------
_GATES = ("i", "f", "o", "g")


def gclstm_init(gen, cfg: SnapshotConfig, device="cpu"):
    """Init GCLSTM params: embeddings, gate dense/GCN pairs, decoder."""
    d_in, d_h = cfg.d_node, cfg.d_embed
    p = {
        "emb": normal(gen, (cfg.num_nodes, d_in), 0.02, device),
        "decoder": link_decoder_init(gen, d_h, device=device),
    }
    for g in _GATES:
        p[f"w{g}"] = dense_init(gen, d_in, d_h, device=device)
        p[f"u{g}"] = gcn_layer_init(gen, d_h, d_h, device)
    p["out"] = dense_init(gen, d_h, d_h, device=device)
    return p


def gclstm_state(cfg: SnapshotConfig, device="cpu"):
    """Zero (h, c) recurrent state: two (N, d_embed) tensors."""
    z = torch.zeros((cfg.num_nodes, cfg.d_embed), device=device)
    return (z, z)


def gclstm_apply(params, cfg: SnapshotConfig, src, dst, edge_mask, state, *,
                 mode: str = "auto"):
    """One GCLSTM step over a padded snapshot: returns (z, (h, c))."""
    h, c = state
    x = params["emb"]
    n = cfg.num_nodes

    def gate(g, act):
        return act(dense(params[f"w{g}"], x)
                   + gcn_layer(params[f"u{g}"], h, src, dst, edge_mask, n,
                               mode=mode))

    i = gate("i", torch.sigmoid)
    f = gate("f", torch.sigmoid)
    o = gate("o", torch.sigmoid)
    g = gate("g", torch.tanh)
    c = f * c + i * g
    h = o * torch.tanh(c)
    z = dense(params["out"], h)
    return z, (h, c)


# ----------------------------------------------------------------------
# T-GCN (Zhao et al., 2019): GRU whose transforms are GCNs over [X || h]
# ----------------------------------------------------------------------
def tgcn_init(gen, cfg: SnapshotConfig, device="cpu"):
    """Init T-GCN params: embeddings, GRU-gate GCNs, decoder."""
    d_in, d_h = cfg.d_node, cfg.d_embed
    return {
        "emb": normal(gen, (cfg.num_nodes, d_in), 0.02, device),
        "gu": gcn_layer_init(gen, d_in + d_h, d_h, device),
        "gr": gcn_layer_init(gen, d_in + d_h, d_h, device),
        "gc": gcn_layer_init(gen, d_in + d_h, d_h, device),
        "decoder": link_decoder_init(gen, d_h, device=device),
    }


def tgcn_state(cfg: SnapshotConfig, device="cpu"):
    """Zero hidden state: one (N, d_embed) tensor."""
    return torch.zeros((cfg.num_nodes, cfg.d_embed), device=device)


def tgcn_apply(params, cfg: SnapshotConfig, src, dst, edge_mask, h, *,
               mode: str = "auto"):
    """One T-GCN (GRU-over-GCN) step: returns (z, h_new) with z = h_new."""
    x = params["emb"]
    n = cfg.num_nodes

    def conv(name, inp):
        return gcn_layer(params[name], inp, src, dst, edge_mask, n, mode=mode)

    xh = torch.cat([x, h], -1)
    u = torch.sigmoid(conv("gu", xh))
    r = torch.sigmoid(conv("gr", xh))
    c = torch.tanh(conv("gc", torch.cat([x, r * h], -1)))
    h_new = u * h + (1.0 - u) * c
    return h_new, h_new


# ----------------------------------------------------------------------
# Uniform registry
# ----------------------------------------------------------------------
SNAPSHOT_MODELS = ("gcn", "gclstm", "tgcn")


def _check(name: str) -> None:
    if name not in SNAPSHOT_MODELS:
        raise ValueError(f"unknown DTDG model {name!r}; have {SNAPSHOT_MODELS}")


def init_params(name: str, gen, cfg: SnapshotConfig, device="cpu"):
    """Initialize parameters for snapshot model ``name`` from ``gen`` (a
    CPU ``torch.Generator``); the draws are moved to ``device``."""
    _check(name)
    return {"gcn": gcn_model_init, "gclstm": gclstm_init,
            "tgcn": tgcn_init}[name](gen, cfg, device)


def init_state(name: str, cfg: SnapshotConfig, device="cpu"):
    """Initial recurrent state (``()`` for the stateless GCN)."""
    _check(name)
    if name == "gcn":
        return ()
    if name == "gclstm":
        return gclstm_state(cfg, device)
    return tgcn_state(cfg, device)


def make_apply(name: str, cfg: SnapshotConfig):
    """Per-snapshot apply function with the uniform carry signature:
    ``apply(params, src, dst, mask, state, mode="auto") -> (z, new_state)``
    where ``src/dst/mask`` are one padded snapshot's (capacity,) tensors and
    ``state`` matches ``init_state``. The pipeline's train, eval and advance
    steps all run this one function."""
    _check(name)
    if name == "gcn":

        def apply(params, src, dst, mask, state, mode="auto"):
            return gcn_model_apply(params, cfg, src, dst, mask, mode=mode), state

    elif name == "gclstm":

        def apply(params, src, dst, mask, state, mode="auto"):
            return gclstm_apply(params, cfg, src, dst, mask, state, mode=mode)

    else:

        def apply(params, src, dst, mask, state, mode="auto"):
            return tgcn_apply(params, cfg, src, dst, mask, state, mode=mode)

    return apply


# ----------------------------------------------------------------------
# Shared snapshot padding helper
# ----------------------------------------------------------------------
def pad_snapshot(src, dst, capacity: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a host snapshot edge list to ``capacity`` with a validity mask
    (an oversized snapshot is sampled down deterministically)."""
    n = len(src)
    if n > capacity:
        sel = np.linspace(0, n - 1, capacity).astype(np.int64)
        src, dst, n = src[sel], dst[sel], capacity
    mask = np.zeros(capacity, dtype=bool)
    mask[:n] = True
    out_src = np.zeros(capacity, dtype=np.int32)
    out_dst = np.zeros(capacity, dtype=np.int32)
    out_src[:n] = src
    out_dst[:n] = dst
    return out_src, out_dst, mask
