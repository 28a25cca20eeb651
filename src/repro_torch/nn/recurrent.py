"""Recurrent cells (GRU for TGN memory / T-GCN; LSTM for GCLSTM).

Twins of ``repro.nn.recurrent``, as (init, apply) function pairs over
parameter dicts in the reference's layout.
"""

from __future__ import annotations

import torch

from repro_torch.nn.linear import dense, dense_init


def gru_init(gen, d_in: int, d_hidden: int, device="cpu"):
    """Update, reset and candidate gates: input weights with a bias, hidden
    weights without."""
    return {
        "wz": dense_init(gen, d_in, d_hidden, device=device),
        "uz": dense_init(gen, d_hidden, d_hidden, bias=False, device=device),
        "wr": dense_init(gen, d_in, d_hidden, device=device),
        "ur": dense_init(gen, d_hidden, d_hidden, bias=False, device=device),
        "wh": dense_init(gen, d_in, d_hidden, device=device),
        "uh": dense_init(gen, d_hidden, d_hidden, bias=False, device=device),
    }


def gru(params, x, h):
    """One GRU step: x (..., d_in), h (..., d_hidden) -> new h."""
    z = torch.sigmoid(dense(params["wz"], x) + dense(params["uz"], h))
    r = torch.sigmoid(dense(params["wr"], x) + dense(params["ur"], h))
    hh = torch.tanh(dense(params["wh"], x) + dense(params["uh"], r * h))
    return (1.0 - z) * h + z * hh


def lstm_init(gen, d_in: int, d_hidden: int, device="cpu"):
    """Input, forget, output and cell gates (``w*`` with a bias, ``u*``
    without)."""
    p = {}
    for n in ("wi", "ui", "wf", "uf", "wo", "uo", "wg", "ug"):
        d = d_in if n.startswith("w") else d_hidden
        p[n] = dense_init(gen, d, d_hidden, bias=n.startswith("w"),
                          device=device)
    return p


def lstm(params, x, state):
    """One LSTM step: x (..., d_in), state (h, c) -> (h, (h, c))."""
    h, c = state
    i = torch.sigmoid(dense(params["wi"], x) + dense(params["ui"], h))
    f = torch.sigmoid(dense(params["wf"], x) + dense(params["uf"], h))
    o = torch.sigmoid(dense(params["wo"], x) + dense(params["uo"], h))
    g = torch.tanh(dense(params["wg"], x) + dense(params["ug"], h))
    c = f * c + i * g
    h = o * torch.tanh(c)
    return h, (h, c)
