"""Plain PyTorch SSD chunk scan: the versions the CPU runs and the card's
kernel (K6) is held against.

``ssd_ref`` is a copy of the reference's oracle
(``repro.kernels.ssd_chunk.ref.ssd_ref``): the exact sequential recurrence
for one sequence. ``ssd_chunk_ref`` is the plain version of K6's wider
contract (batch, groups, final state) in the bfloat16 kernel's structure:
chunk states from zero, the state passed from chunk to chunk, the output
from the diagonal blocks and the incoming states, in float32.
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


def ssd_chunk_ref(x, dt, a, Bm, Cm, *, chunk: int = 128):
    """x: (Bsz, S, H, P); dt: (Bsz, S, H); a: (H,); Bm, Cm: (Bsz, S, G, N)
    with H % G == 0 (head h reads group h // (H // G)).

    Returns (y (Bsz, S, H, P) in x's dtype, final_state (Bsz, H, P, N)
    float32), from a zero state, in float32, in the bfloat16 kernel's three
    passes over chunks of ``chunk`` steps (the last one padded with dt = 0),
    cum the inclusive sum of dt a within a chunk:

    1. each chunk's own end state from zero, local_c = sum_j exp(cum_end -
       cum_j) dt_j x_j (x) B_j, every chunk at once;
    2. the state entering each chunk, s_in,c = exp(cum_end,c-1) s_in,c-1 +
       local_c-1, a loop over chunks; the final state follows the last;
    3. y = (C B^T o L o dt) x + exp(cum) C s_in, every chunk at once, with
       L[i, j] = exp(cum_i - cum_j) for i >= j.

    The decays within a chunk are exp of the sum of dt a over the steps
    between, each sum taken on its own (never exp(cum_i) exp(-cum_j), which
    overflows once cum passes -88, nor the difference of two running sums,
    which loses |cum| ulps when decay is steep).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = H // G
    nc = -(-S // chunk)
    pad = nc * chunk - S
    dev = x.device

    def chunks(t, *tail):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((Bsz, pad) + tuple(t.shape[2:]))], dim=1)
        return t.reshape(Bsz, nc, chunk, *tail)

    xf = chunks(x, G, Hg, P)                                 # (b, c, q, g, h, p)
    dtf = chunks(dt, G, Hg)                                  # (b, c, q, g, h)
    Bf, Cf = chunks(Bm, G, N), chunks(Cm, G, N)              # (b, c, q, g, n)
    adt = dtf * a.float().reshape(G, Hg)
    cum = torch.cumsum(adt, dim=2)
    # seg[i, j] = sum of dt a over steps j+1 .. i (0 where i <= j), each
    # summed on its own: a difference of two running sums loses |cum| ulps,
    # which steep decay makes large (|cum| in the thousands at step 128).
    low = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    low = low[:, :, None, None]
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev), -1)
    seg = torch.cumsum(torch.where(strict[:, :, None, None], adt[:, :, :, None],
                                   torch.zeros_like(adt[:, :, :, None])), dim=2)
    xdt = xf * dtf[..., None]

    # 1. chunk states from zero
    to_end = torch.exp(seg[:, :, -1])                        # (b, c, j, g, h)
    local = torch.einsum("bcjghp,bcjgn->bcghpn", to_end[..., None] * xdt, Bf)

    # 2. state passing, float32
    decay = torch.exp(cum[:, :, -1])                         # (b, c, g, h)
    s = torch.zeros((Bsz, G, Hg, P, N), dtype=torch.float32, device=dev)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * decay[:, c][..., None, None] + local[:, c]
    s_in = (torch.stack(s_in, dim=1) if s_in else
            local.new_zeros((Bsz, 0, G, Hg, P, N)))

    # 3. output: diagonal blocks and the incoming states
    L = torch.where(low, torch.exp(seg), torch.zeros_like(seg))  # (b, c, i, j, g, h)
    scores = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf)
    y_diag = torch.einsum("bcijgh,bcjghp->bcighp", scores[..., None] * L, xdt)
    y_off = (torch.einsum("bcign,bcghpn->bcighp", Cf, s_in)
             * torch.exp(cum)[..., None])
    y = (y_diag + y_off).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), s.reshape(Bsz, H, P, N)
