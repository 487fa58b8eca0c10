"""Plain PyTorch versions of the port's kernels.

Each function here is what a hand-written kernel of ``kernels/``
computes, written with ordinary tensor operations. The wrappers in
``kernels/ops.py`` use them for tensors on the CPU; on the GPU they are
the yardstick the kernels are held to.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

INT8_MAX = 127.0
BIAS_MAX = 2.0 ** 23          # biases live at accumulator scale, int32-safe
DFA_SHIFT = 7                 # feedback projections are scaled by 2^-7
EXP_FLOOR = -24               # all-zero tensors land on this grid

# order of the ten fp32 multipliers in a packed scales vector
SCALE_KEYS = ("f0", "f1", "fe", "floss", "ftw0", "ftw1", "ftw2",
              "ftb0", "ftb1", "ftb2")


def meta_update(w, w_hat, alpha):
    """Reptile interpolation ``w + alpha * (w_hat - w)`` in fp32 math,
    stored in w's dtype. ``alpha`` is a float or a one-element fp32
    tensor.

    The difference is rounded to fp32, then the product and the sum are
    rounded once together: ``fma(alpha, w_hat - w, w)``, as the JAX
    engine's jitted interpolation compiles. The sum is taken in float64,
    where ``alpha * d`` is exact, and rounded to odd (one float64 ulp
    toward the rounding error where it is nonzero and the last bit
    even), so the one cast to fp32 that follows rounds exactly as a
    single fp32 FMA does."""
    w32 = w.float()
    a = torch.as_tensor(alpha, dtype=torch.float32, device=w.device)
    prod = a.double() * (w_hat.float() - w32).double()        # exact
    base = w32.double()
    s = base + prod
    back = s - base                                           # TwoSum
    err = (base - (s - back)) + (prod - back)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float().to(w.dtype)


def online_sgd(p, g, lr, m=None, momentum=0.0):
    """Streaming SGD step ``p - lr * g`` in fp32 math, stored in p's
    dtype; with ``m``, the momentum form ``m' = momentum * m + g``,
    ``p' = p - lr * m'`` (m' in fp32)."""
    if m is None:
        return (p.float() - lr * g.float()).to(p.dtype)
    m_new = momentum * m + g.float()
    return (p.float() - lr * m_new).to(p.dtype), m_new


def flash_decode(q, k_cache, v_cache, cache_len, *, window=0):
    """Single-token GQA attention. q: (B, H, hd); caches: (B, S, Kv, hd)
    with H = Kv * R; cache_len: an int. Positions ``pos < cache_len``
    (and ``pos >= cache_len - window`` with a window) are attended; q is
    scaled by ``hd ** -0.5`` and everything is computed in fp32. Returns
    (B, H, hd) fp32."""
    B, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    R = H // Kv
    qg = q.reshape(B, Kv, R, hd).float() * hd ** -0.5
    s = torch.einsum("bkrh,bskh->bkrs", qg, k_cache.float())
    pos = torch.arange(S, device=q.device)
    valid = pos < cache_len
    if window:
        valid &= pos >= cache_len - window
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrs,bskh->bkrh", p, v_cache.float())
    return out.reshape(B, H, hd)


def exp2_int(e):
    """``2.0 ** e`` as fp32 for an integer tensor ``e``, exact: the float's
    bits are built from the exponent, so no ``pow`` or ``exp2`` routine
    (whose results on the card are not promised exact) is involved.
    Exponents are clamped to the normal range [-126, 127], which holds
    every grid the TIFeD path reaches. Runs on the device, inside a
    captured graph too."""
    e = torch.clamp(torch.as_tensor(e).to(torch.int32), -126, 127)
    return torch.bitwise_left_shift(e + 127, 23).view(torch.float32)


def pow2_exponent(maxabs, limit=INT8_MAX):
    """Smallest integer e with ``maxabs * 2^-e <= limit``, floored at
    -24 (the grid of an all-zero tensor).

    Computed exactly from the binary exponents (``torch.frexp``):
    with maxabs = m 2^k and limit = mL 2^kL (m, mL in [0.5, 1)), the
    answer is k - kL, plus one when m > mL. The JAX package's
    ``ceil(log2(.))`` form returns one more than this at some exact
    boundaries ``maxabs = 127 * 2^k`` (k = -21, -17, -15, -13, 15, 19 on
    JAX 0.9 CPU); elsewhere the two agree. Makes no tensor from the
    host, so it runs inside a captured graph."""
    maxabs = torch.as_tensor(maxabs, dtype=torch.float32)
    m, k = torch.frexp(maxabs)
    ml, kl = math.frexp(float(limit))
    e = k - kl + (m > ml).to(k.dtype)
    e = torch.where(maxabs > 0, e, torch.full_like(e, EXP_FLOOR))
    return torch.clamp(e, min=EXP_FLOOR).to(torch.int32)


def quantize_pow2(w, limit=INT8_MAX):
    """Per-tensor power-of-two symmetric quantization: ``(q, e)`` with
    ``q`` the integer-valued fp32 codes in [-limit, limit] and ``w ~=
    q * 2^e`` (``e`` an int32 scalar tensor)."""
    e = pow2_exponent(w.abs().max(), limit)
    q = torch.clamp(torch.round(w * exp2_int(-e)), -limit, limit)
    return q, e


def stochastic_round(v, dither):
    """Unbiased stochastic rounding ``floor(v + u)``, u ~ U[0, 1) given
    by the caller."""
    return torch.floor(v + dither)


def pack_scales(scales: Dict, device=None) -> torch.Tensor:
    """The scales dict (f0, f1, fe, floss, ftw 3-tuple, ftb 3-tuple) ->
    a (10,) fp32 tensor in ``SCALE_KEYS`` order, as the kernel reads
    it."""
    vals = [scales["f0"], scales["f1"], scales["fe"], scales["floss"],
            *scales["ftw"], *scales["ftb"]]
    return torch.tensor([float(v) for v in vals], dtype=torch.float32,
                        device=device)


def dfa_int8_epoch(ws: Sequence, bs: Sequence, xq, yal, layer,
                   fb: Sequence, dither: Sequence, scales):
    """One TIFeD epoch for each of B slots: int8 forward with exact
    integer accumulation, uint7 activation requantization, quantized
    output error, direct-feedback-alignment projection through the fixed
    int8 ``fb``, and a stochastic-rounding update of the one layer
    ``layer[b]`` selects (the others pass through).

      ws:     (w0 (B,din,H1), w1 (B,H1,H2), w2 (B,H2,dout)) int8
      bs:     (b0 (B,H1), b1 (B,H2), b2 (B,dout)) int32, accumulator scale
      xq:     (B,S,din) int8;  yal: (B,S,dout) int32
      layer:  (B,) int32 in {0, 1, 2}
      fb:     (fb1 (dout,H1), fb2 (dout,H2)) int8, shared by the slots
      dither: (d0 (B,din,H1), d1 (B,H1,H2), d2 (B,H2,dout)) fp32 U[0,1)
      scales: (10,) fp32 in ``SCALE_KEYS`` order (see ``pack_scales``)

    Returns ((w0', w1', w2') int8, (b0', b1', b2') int32, loss (B,) fp32).

    Integer sums run in float64, exact for any integer below 2^53; the
    requantization steps run in fp32 as the JAX oracle does, where every
    multiplier is a power of two. The loss is summed in float64 and
    rounded once to fp32.
    """
    f64, f32 = torch.float64, torch.float32
    sc = scales.to(f32)
    f0, f1, fe, floss = sc[0], sc[1], sc[2], sc[3]
    ftw, ftb = sc[4:7], sc[7:10]
    w0, w1, w2 = (w.to(f64) for w in ws)
    b0, b1, b2 = (b.to(f64) for b in bs)
    fb1, fb2 = (f.to(f64) for f in fb)
    x = xq.to(f64)

    def requant(z, f):
        zf = torch.clamp(z, min=0.0).to(f32)
        return torch.clamp(torch.round(zf * f), 0.0, INT8_MAX).to(f64)

    z0 = torch.matmul(x, w0) + b0.unsqueeze(1)
    a1 = requant(z0, f0)
    z1 = torch.matmul(a1, w1) + b1.unsqueeze(1)
    a2 = requant(z1, f1)
    z2 = torch.matmul(a2, w2) + b2.unsqueeze(1)
    err = z2 - yal.to(f64)
    eq = torch.clamp(torch.round(err.to(f32) * fe), -INT8_MAX, INT8_MAX)
    eq = eq.to(f64)
    loss = (torch.square(err).sum(dim=(1, 2)) * floss.to(f64)).to(f32)

    def delta(z, fbm):
        proj = torch.matmul(eq, fbm).to(f32)
        d = torch.round(torch.where(z > 0, proj, torch.zeros_like(proj))
                        * 2.0 ** -DFA_SHIFT)
        return d.to(f64)

    def wstep(w, a_in, d, i, dith):
        g = torch.matmul(a_in.transpose(1, 2), d).to(f32)
        wn = w.to(f32) - stochastic_round(g * ftw[i], dith.to(f32))
        return torch.clamp(wn, -INT8_MAX, INT8_MAX).to(torch.int8)

    def bstep(b, d, i):
        bn = b.to(f32) - torch.round(d.sum(dim=1).to(f32) * ftb[i])
        return torch.clamp(bn, -BIAS_MAX, BIAS_MAX).to(torch.int32)

    d0 = delta(z0, fb1)
    d1 = delta(z1, fb2)
    cand = ((wstep(w0, x, d0, 0, dither[0]), bstep(b0, d0, 0)),
            (wstep(w1, a1, d1, 1, dither[1]), bstep(b1, d1, 1)),
            (wstep(w2, a2, eq, 2, dither[2]), bstep(b2, eq, 2)))
    lay = layer.to(torch.int64).clamp(0, 2)      # as lax.switch clamps
    new_w, new_b = [], []
    for i in range(3):
        sel = lay == i
        new_w.append(torch.where(sel.view(-1, 1, 1), cand[i][0], ws[i]))
        new_b.append(torch.where(sel.view(-1, 1), cand[i][1], bs[i]))
    return tuple(new_w), tuple(new_b), loss


def ssd_scan(xd, dA, Bm, Cm):
    """Chunked Mamba2 SSD forward in the kernel's layout.

    xd (B, H, nc, Q, P) dt-scaled inputs; dA (B, H, nc, Q) log-decay
    increments dt * A (<= 0); Bm, Cm (B, nc, Q, N), shared by the heads
    (ngroups = 1). Returns y (B, H, nc, Q, P) fp32: the in-chunk term
    (C B^T o L) xd plus the (P, N) state carried across chunks (zero
    before the first) and decayed by exp(sum dA). The scan over chunks is
    a Python loop."""
    xd, dA, Bm, Cm = (t.float() for t in (xd, dA, Bm, Cm))
    B, H, nc, Q, P = xd.shape
    N = Bm.shape[-1]
    dA_cs = torch.cumsum(dA, dim=-1)                       # (B,H,nc,Q)
    diff = dA_cs[..., :, None] - dA_cs[..., None, :]       # (B,H,nc,Q,Q)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xd.device))
    # mask inside the exp (exp(-1e30) = 0), so the gradient stays finite
    L = torch.exp(torch.where(mask, diff, torch.full_like(diff, -1e30)))
    CB = torch.einsum("bcin,bcjn->bcij", Cm, Bm)           # (B,nc,Q,Q)
    y_diag = torch.einsum("bhcij,bhcjp->bhcip", L * CB[:, None], xd)
    decay_out = torch.exp(dA_cs[..., -1:] - dA_cs)         # (B,H,nc,Q)
    states = torch.einsum("bcln,bhcl,bhclp->bhcpn", Bm, decay_out, xd)
    chunk_decay = torch.exp(dA_cs[..., -1])                # (B,H,nc)
    state = torch.zeros(B, H, P, N, dtype=torch.float32, device=xd.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, :, c, None, None] + states[:, :, c]
    prev = torch.stack(prev, dim=2)                        # (B,H,nc,P,N)
    y_off = torch.einsum("bcln,bhcpn,bhcl->bhclp", Cm, prev, torch.exp(dA_cs))
    return y_diag + y_off


# -- the three phases of the ssd_scan kernel (kernels/ssd_scan.py) ----------
# Their composition is ssd_scan: ssd_chunk_outputs(xd, cs, Bm, Cm,
# ssd_state_pass(*ssd_chunk_states(xd, dA, Bm))[0]). States are stored
# transposed, (N, P) per (b, h, c), as the kernel keeps them.


def ssd_chunk_states(xd, dA, Bm):
    """Phase 1: cs = cumsum(dA) within each chunk (B, H, nc, Q), and each
    chunk's own state st[b,h,c] = (B_c o exp(cs[-1] - cs))^T xd_c, as
    (B, H, nc, N, P). Returns (st, cs)."""
    cs = torch.cumsum(dA.float(), dim=-1)
    decay = torch.exp(cs[..., -1:] - cs)
    st = torch.einsum("bcln,bhcl,bhclp->bhcnp", Bm.float(), decay,
                      xd.float())
    return st.contiguous(), cs


def ssd_state_pass(st, cs):
    """Phase 2: the state entering each chunk, zero before the first and
    s_in[c+1] = s_in[c] exp(cs[c, -1]) + st[c]. Returns (s_in (B, H, nc,
    N, P), the state after the last chunk (B, H, N, P))."""
    decay = torch.exp(cs[..., -1])                         # (B,H,nc)
    state = torch.zeros_like(st[:, :, 0])
    s_in = []
    for c in range(st.shape[2]):
        s_in.append(state)
        state = state * decay[:, :, c, None, None] + st[:, :, c]
    return torch.stack(s_in, dim=2), state


def ssd_chunk_outputs(xd, cs, Bm, Cm, s_in):
    """Phase 3: y = (C B^T o L) xd + exp(cs) C s_in, with L[i,j] =
    exp(cs[i] - cs[j]) for i >= j, else 0. Returns (B, H, nc, Q, P)."""
    xd, Bm, Cm = xd.float(), Bm.float(), Cm.float()
    Q = xd.shape[3]
    diff = cs[..., :, None] - cs[..., None, :]             # (B,H,nc,Q,Q)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xd.device))
    L = torch.exp(torch.where(mask, diff, torch.full_like(diff, -1e30)))
    CB = torch.einsum("bcin,bcjn->bcij", Cm, Bm)           # (B,nc,Q,Q)
    y_diag = torch.einsum("bhcij,bhcjp->bhcip", L * CB[:, None], xd)
    y_off = torch.einsum("bcin,bhcnp,bhci->bhcip", Cm, s_in, torch.exp(cs))
    return y_diag + y_off
