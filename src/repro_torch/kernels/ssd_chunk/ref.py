"""Plain PyTorch SSD chunk scan: the versions the CPU runs and the card's
kernel (K6) is held against.

``ssd_ref`` is a copy of the reference's oracle
(``repro.kernels.ssd_chunk.ref.ssd_ref``): the exact sequential recurrence
for one sequence. ``ssd_chunk_ref`` is the plain version of K6's wider
contract (batch, groups, final state) in the bfloat16 kernel's structure:
chunk states from zero, the state passed from chunk to chunk, the output
from the diagonal blocks and the incoming states, in float32.
``ssd_chunk_states_ref`` gives the chunk states of its passes 1-2, which K6
keeps for K6b. ``ssd_chunk_bwd_ref`` is the plain version of its backward
kernel (K6b):
the gradients of ``ssd_chunk_ref`` written out in the kernel's structure
(a reverse pass over the chunks' state cotangents, then each chunk on its
own), not by autograd. Both compute in float64 for float64 inputs, so that
the tests can hold the formulas against autograd at that precision.
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


def _wide(t):
    """float64 stays float64, anything else computes in float32."""
    return t if t.dtype == torch.float64 else t.float()


def _decays(adt, chunk: int):
    """From adt = dt a (b, c, q, g, h): cum, its inclusive sum within each
    chunk; seg (b, c, i, j, g, h), the sum of dt a over steps j+1 .. i (0
    where i <= j), each summed on its own (a difference of two running sums
    loses |cum| ulps, which steep decay makes large: |cum| in the thousands
    at step 128); and the (i, j, 1, 1) mask of i >= j."""
    dev = adt.device
    cum = torch.cumsum(adt, dim=2)
    low = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev), -1)
    seg = torch.cumsum(torch.where(strict[:, :, None, None], adt[:, :, :, None],
                                   torch.zeros_like(adt[:, :, :, None])), dim=2)
    return cum, seg, low[:, :, None, None]


def _chunked(t, chunk: int, *tail):
    """(Bsz, S, ...) -> (Bsz, nc, chunk, *tail) in the computing dtype, the
    last chunk padded with zeros (dt = 0: decay 1, no input)."""
    Bsz, S = t.shape[:2]
    nc = -(-S // chunk)
    t = _wide(t)
    if nc * chunk > S:
        t = torch.cat([t, t.new_zeros((Bsz, nc * chunk - S) + tuple(t.shape[2:]))], dim=1)
    return t.reshape(Bsz, nc, chunk, *tail)


def _entering_states(xdt, Bf, seg, cum):
    """Passes 1-2: each chunk's own end state from zero, then the state
    entering each chunk from a zero state. Returns (s_in (b, c, g, h, p, n),
    the final state, the chunk decays exp(cum_end) (b, c, g, h), and
    to_end_j = exp(cum_end - cum_j) (b, c, j, g, h))."""
    to_end = torch.exp(seg[:, :, -1])
    local = torch.einsum("bcjghp,bcjgn->bcghpn", to_end[..., None] * xdt, Bf)
    decay = torch.exp(cum[:, :, -1])
    s = local.new_zeros((local.shape[0],) + tuple(local.shape[2:]))
    s_in = []
    for c in range(local.shape[1]):
        s_in.append(s)
        s = s * decay[:, c][..., None, None] + local[:, c]
    s_in = torch.stack(s_in, dim=1) if s_in else torch.zeros_like(local)
    return s_in, s, decay, to_end


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

    xf = _chunked(x, chunk, G, Hg, P)                        # (b, c, q, g, h, p)
    dtf = _chunked(dt, chunk, G, Hg)                         # (b, c, q, g, h)
    Bf, Cf = _chunked(Bm, chunk, G, N), _chunked(Cm, chunk, G, N)  # (b, c, q, g, n)
    adt = dtf * _wide(a).reshape(G, Hg)
    cum, seg, low = _decays(adt, chunk)
    xdt = xf * dtf[..., None]

    # 1-2. chunk states from zero, then the state passed from chunk to chunk
    s_in, s, _, _ = _entering_states(xdt, Bf, seg, cum)

    # 3. output: diagonal blocks and the incoming states
    L = torch.where(low, torch.exp(seg), torch.zeros_like(seg))  # (b, c, i, j, g, h)
    scores = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf)
    y_diag = torch.einsum("bcijgh,bcjghp->bcighp", scores[..., None] * L, xdt)
    y_off = (torch.einsum("bcign,bcghpn->bcighp", Cf, s_in)
             * torch.exp(cum)[..., None])
    y = (y_diag + y_off).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), s.reshape(Bsz, H, P, N)


def ssd_chunk_states_ref(x, dt, a, Bm, Cm, *, chunk: int = 128):
    """The chunk states ``ssd_chunk_ref``'s passes 1-2 form: (s_in (Bsz, nc,
    H, P, N), the state entering each chunk, and the chunk decays
    exp(cum_end) (Bsz, nc, H)), float32 (float64 for float64 inputs). K6
    keeps these (split, and P and N padded to 16) for K6b when a gradient
    follows (``ssd_chunk_kernel(..., keep=True)``)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = H // G
    nc = -(-S // chunk)
    xf, dtf = _chunked(x, chunk, G, Hg, P), _chunked(dt, chunk, G, Hg)
    cum, seg, _ = _decays(dtf * _wide(a).reshape(G, Hg), chunk)
    s_in, _, decay, _ = _entering_states(xf * dtf[..., None], _chunked(Bm, chunk, G, N), seg,
                                         cum)
    return s_in.reshape(Bsz, nc, H, P, N), decay.reshape(Bsz, nc, H)


def ssd_chunk_bwd_ref(x, dt, a, Bm, Cm, dy, dstate=None, *, chunk: int = 128):
    """The gradients of ``ssd_chunk_ref`` (K6b's plain version).

    x, dt, a, Bm, Cm as ``ssd_chunk_ref`` takes them; dy (Bsz, S, H, P) the
    cotangent of y and ``dstate`` (Bsz, H, P, N) that of the final state
    (None: zero). Returns (dx, ddt, da, dBm, dCm): dx, dBm and dCm in the
    dtypes of x, Bm and Cm, ddt and da in float32 (float64 for float64
    inputs). Per (batch, head h of group g), chunks of ``chunk`` steps (the
    last padded with dt = 0), cum the inclusive sum of dt a within a chunk,
    L_ij = exp(cum_i - cum_j) for i >= j, e_j = exp(cum_end - cum_j), s_in,c
    the state entering chunk c (``ssd_chunk_ref``'s passes 1-2):

    1. the reverse state pass: g_nc = dstate; g_c = exp(cum_end,c) g_c+1 +
       D_c with D_c = sum_i exp(cum_i) dy_i (x) C_i, so that g_c+1 is the
       cotangent of chunk c's end state;
    2. each chunk with g = g_c+1 and s = s_in,c, CB_ij = C_i . B_j and
       DX_ij = dy_i . x_j:
       dx_j = sum_i>=j CB_ij L_ij dt_j dy_i + e_j dt_j g B_j,
       dB_j = sum over the group's heads of sum_i>=j DX_ij L_ij dt_j C_i +
       e_j dt_j g^T x_j,
       dC_i = sum over the group's heads of sum_j<=i DX_ij L_ij dt_j B_j +
       exp(cum_i) s^T dy_i,
       ddt_j = sum_i>=j CB_ij L_ij DX_ij + e_j x_j . (g B_j) (dt's direct
       uses);
    3. through cum: with K_ij = CB_ij L_ij DX_ij (i >= j) and T_j = e_j dt_j
       x_j . (g B_j), dcum_i = sum_j<i K_ij dt_j - dt_i sum_i'>i K_i'i +
       exp(cum_i) dy_i . (s C_i) - T_i (K's diagonal cancels, so it is left
       out of both sums), and the chunk's last step also takes
       sum_j T_j + exp(cum_end) <g, s> (the chunk state's and the state
       pass's decay to the end); d(dt a) is dcum's reverse inclusive sum
       within the chunk, ddt += a d(dt a) and da_h = sum over batch and
       steps of dt d(dt a).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = H // G
    nc = -(-S // chunk)
    dev = x.device

    xf, dyf = _chunked(x, chunk, G, Hg, P), _chunked(dy, chunk, G, Hg, P)
    dtf = _chunked(dt, chunk, G, Hg)                         # (b, c, q, g, h)
    Bf, Cf = _chunked(Bm, chunk, G, N), _chunked(Cm, chunk, G, N)  # (b, c, q, g, n)
    av = _wide(a).reshape(G, Hg)
    cum, seg, low = _decays(dtf * av, chunk)
    ec = torch.exp(cum)                                      # exp(cum_i)
    L = torch.where(low, torch.exp(seg), torch.zeros_like(seg))  # (b, c, i, j, g, h)
    # the states entering each chunk (the forward's passes 1-2); e_j
    s_in, s, decay, e = _entering_states(xf * dtf[..., None], Bf, seg, cum)

    # 1. the reverse state pass
    D = torch.einsum("bcighp,bcign->bcghpn", ec[..., None] * dyf, Cf)
    g = (torch.zeros_like(s) if dstate is None
         else _wide(dstate).reshape(Bsz, G, Hg, P, N))
    g_end = [None] * nc
    for c in reversed(range(nc)):
        g_end[c] = g
        g = g * decay[:, c][..., None, None] + D[:, c]
    g_end = torch.stack(g_end, dim=1) if nc else torch.zeros_like(s_in)

    # 2. each chunk
    CB = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf)[..., None]     # (b, c, i, j, g, 1)
    DX = torch.einsum("bcighp,bcjghp->bcijgh", dyf, xf)
    dtj = dtf[:, :, None]                                          # dt_j on (i, j)
    K = CB * L * DX
    Wx = CB * L * dtj                                              # (CB o L o dt)_ij
    Wb = DX * L * dtj                                              # (DX o L o dt)_ij
    gB = torch.einsum("bcjgn,bcghpn->bcjghp", Bf, g_end)           # g B_j
    xgB = (xf * gB).sum(-1)                                        # x_j . g B_j
    edt = e * dtf
    dx = torch.einsum("bcijgh,bcighp->bcjghp", Wx, dyf) + edt[..., None] * gB
    dB = (torch.einsum("bcijgh,bcign->bcjgn", Wb, Cf)
          + torch.einsum("bcjgh,bcjghp,bcghpn->bcjgn", edt, xf, g_end))
    dC = (torch.einsum("bcijgh,bcjgn->bcign", Wb, Bf)
          + torch.einsum("bcigh,bcighp,bcghpn->bcign", ec, dyf, s_in))
    ddt = K.sum(2) + e * xgB

    # 3. through cum (K's diagonal cancels from dcum: left out of both sums,
    # else steep decay, where it dominates, leaves only its rounding)
    T = edt * xgB
    O = ec * torch.einsum("bcighp,bcghpn,bcign->bcigh", dyf, s_in, Cf)
    Ks = K * torch.tril(torch.ones((chunk, chunk), dtype=K.dtype, device=dev), -1)[:, :, None, None]
    dcum = (Ks * dtj).sum(3) - dtf * Ks.sum(2) + O - T
    end = T.sum(2) + decay * (g_end * s_in).sum((-2, -1))
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + end[:, :, None]], dim=2)
    dadt = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = ddt + av * dadt
    da = (dtf * dadt).sum((0, 1, 2)).reshape(H)

    def steps(t, *tail):
        return t.reshape(Bsz, nc * chunk, *tail)[:, :S]

    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    return (steps(dx, H, P).to(x.dtype), steps(ddt, H).to(wide), da.to(wide),
            steps(dB, G, N).to(Bm.dtype), steps(dC, G, N).to(Cm.dtype))
