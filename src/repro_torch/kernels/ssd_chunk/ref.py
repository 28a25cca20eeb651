"""Plain PyTorch SSD chunk scan: the versions the CPU runs and the card's
kernel (K6) is held against.

``ssd_ref`` is a copy of the reference's oracle
(``repro.kernels.ssd_chunk.ref.ssd_ref``): the exact sequential recurrence
for one sequence. ``ssd_chunk_ref`` is the plain version of K6's wider
contract (batch, groups, final state): the same chunked arithmetic as the
kernel, in float32, one chunk at a time.
"""

from __future__ import annotations

import torch


def ssd_ref(x, dt, a, B, C, init_state=None):
    """x: (S, H, P); dt: (S, H); a: (H,) negative; B, C: (S, H, N).

    Returns (y (S, H, P), final_state (H, P, N)), float32: the recurrence
    s_t = exp(dt_t a) s_{t-1} + dt_t x_t (x) B_t, y_t = s_t C_t.
    """
    S, H, P = x.shape
    N = B.shape[-1]
    s = (torch.zeros((H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    a = a.float()
    ys = []
    for t in range(S):
        dtt = dt[t].float()
        decay = torch.exp(dtt * a)  # (H,)
        s = s * decay[:, None, None] + torch.einsum(
            "h,hn,hp->hpn", dtt, B[t].float(), x[t].float())
        ys.append(torch.einsum("hpn,hn->hp", s, C[t].float()))
    y = (torch.stack(ys) if ys else
         torch.zeros((0, H, P), dtype=torch.float32, device=x.device))
    return y, s


def ssd_chunk_ref(x, dt, a, Bm, Cm, *, chunk: int = 64):
    """x: (Bsz, S, H, P); dt: (Bsz, S, H); a: (H,); Bm, Cm: (Bsz, S, G, N)
    with H % G == 0 (head h reads group h // (H // G)).

    Returns (y (Bsz, S, H, P) in x's dtype, final_state (Bsz, H, P, N)
    float32), from a zero state, in float32: per chunk y = (C B^T o L)(dt x)
    + exp(cum) C s_prev and s = exp(cum_end) s_prev + sum_j exp(cum_end -
    cum_j) dt_j x_j (x) B_j, with cum the inclusive sum of dt a.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = H // G
    xf = x.float().reshape(Bsz, S, G, Hg, P)
    dtf = dt.float().reshape(Bsz, S, G, Hg)
    af = a.float().reshape(G, Hg)
    Bf, Cf = Bm.float(), Cm.float()
    state = torch.zeros((Bsz, G, Hg, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, S, chunk):
        xc, dtc = xf[:, t0:t0 + chunk], dtf[:, t0:t0 + chunk]
        Bc, Cc = Bf[:, t0:t0 + chunk], Cf[:, t0:t0 + chunk]
        Q = xc.shape[1]
        cum = torch.cumsum(dtc * af, dim=1)                     # (b, Q, g, h)
        low = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
        diff = cum[:, :, None] - cum[:, None, :]                # (b, i, j, g, h)
        L = torch.where(low[None, :, :, None, None], torch.exp(
            torch.where(low[None, :, :, None, None], diff, torch.zeros_like(diff))),
            torch.zeros_like(diff))
        scores = torch.einsum("bign,bjgn->bijg", Cc, Bc)
        xdt = xc * dtc[..., None]                               # (b, j, g, h, p)
        y_diag = torch.einsum("bijgh,bjghp->bighp", scores[..., None] * L, xdt)
        y_off = torch.einsum("bign,bghpn->bighp", Cc, state) * torch.exp(cum)[..., None]
        ys.append(y_diag + y_off)
        to_end = torch.exp(cum[:, -1:] - cum)                   # (b, j, g, h)
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bjghp,bjgn->bghpn", to_end[..., None] * xdt, Bc))
    y = (torch.cat(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, G, Hg, P)))
    return y.reshape(Bsz, S, H, P).to(x.dtype), state.reshape(Bsz, H, P, N)
