"""GQA attention, the port of the JAX package's ``models/attention.py``:
RoPE, the blockwise online-softmax attention of the train and prefill
path, and single-token attention against a KV cache through the
hand-written ``flash_decode`` kernel.

``flash_attention`` and ``attention_block`` are plain jnp in the JAX
package (no Pallas kernel), and plain tensor ops here: KV blocks of 512
keys folded into a running max, sum and output per query block of 512,
masked scores filled with ``NEG_INF`` (-1e30, not -inf: a KV block that
is wholly masked for a row then leaves a finite sum that the row's first
real block wipes, where -inf would give NaN). The scores and the PV
product accumulate in fp32 whatever the operands' dtype (the JAX
package's ``preferred_element_type``): bf16 operands are upcast first,
which is exact, and p is rounded to v's dtype before PV as there.

The JAX package's ``decode_attention`` is plain jnp (its module says the
decode hot spot dispatches to ``repro.kernels.flash_decode``; no model
path calls the kernel there). The port's routes through
``kernels/ops.py::flash_decode``: the kernel on the card, the plain
version on the CPU. Both compute the same function; in fp32 the two
packages agree to 1e-5.

The encoder-decoder family's pieces: ``attention_block(kv_x=...)`` is
cross-attention (k and v from ``kv_x``, no RoPE, no positions, so only
padded keys are masked), ``use_rope=False`` drops the rotation (the
encoder and whisper's decoder), and ``decode_attention_block`` without
``rope`` is the JAX package's ``use_rope=False`` decode step. Operands
of mixed dtypes (whisper's fp32 frames against bf16 weights) are
promoted, as jnp promotes them.

Of the routes the JAX package takes under ``runtime/flags.py``'s
levers, two change the work on one device and are ported: ``banded``
(``_banded_attention``: each query block against its KV band only) and
the ``ringkv`` decode step (a cache of ``window`` rows written as a
ring, attended through ``flash_decode`` with window 0). The others
compute what the default route computes: ``gqa_flat`` (K and V repeated
to the H query heads) and ``seqpar`` (one query block) exist to be
sharded over a device mesh (their sharding is not ported; the 2-D
route's tensor-parallel attention runs ``attention_block`` on a rank's
heads with ``partial=True``), and probe mode's
single-shot masked attention serves XLA's cost analysis. Under them
``flash_attention`` takes its default route.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import normal_init, promoted
from repro_torch.runtime.flags import feature

NEG_INF = -1e30


def attention_shapes(d_model, num_heads, num_kv_heads, head_dim, dtype):
    """``{leaf: (shape, dtype)}`` of one attention sub-block, as
    ``init_attention`` builds it."""
    return {"wq": ((d_model, num_heads, head_dim), dtype),
            "wk": ((d_model, num_kv_heads, head_dim), dtype),
            "wv": ((d_model, num_kv_heads, head_dim), dtype),
            "wo": ((num_heads, head_dim, d_model), dtype)}


def init_attention(gen: torch.Generator, d_model, num_heads, num_kv_heads,
                   head_dim, dtype, device=None):
    """One attention sub-block's random weights (``normal_init`` of each
    matrix, in sorted-name order), drawn on the CPU from ``gen``."""
    shapes = attention_shapes(d_model, num_heads, num_kv_heads, head_dim,
                              dtype)
    return {name: normal_init(gen, shape, 1.0, dt, device)
            for name, (shape, dt) in sorted(shapes.items())}


def project(x, w):
    """``einsum("bsd,dnh->bsnh", x, w)`` in the promoted dtype."""
    return torch.einsum("bsd,dnh->bsnh", *promoted(x, w))


def unproject(out, w):
    """``einsum("bsnh,nhd->bsd", out, w)`` in the promoted dtype."""
    return torch.einsum("bsnh,nhd->bsd", *promoted(out, w))


def rope_angles(positions, head_dim, theta) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """cos and sin of the rotary angles, (B, S, 1, hd / 2) fp32, for
    positions (S,) or (B, S): ``theta ** (-i / half)`` per pair, in fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x, cos, sin):
    """x (B, S, N, hd) rotated by ``rope_angles``' cos and sin, in fp32,
    cast back to x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope(x, positions, theta):
    """x: (B, S, N, hd); positions: (S,) or (B, S)."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0):
    """Single-token attention against a KV cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, S, Kv, hd); cache_len: the
    number of valid cache entries, an int or an int32 tensor of one element
    on q's device (the JAX package's traced scalar; ``flash_decode`` reads
    it on the card). The new token attends to ``cache[max(0, cache_len -
    window):cache_len]``. Returns (B, 1, H, hd) in q's dtype."""
    B, _, H, hd = q.shape
    out = ops.flash_decode(q.reshape(B, H, hd), k_cache, v_cache, cache_len,
                           window=window)
    return out.reshape(B, 1, H, hd)


def decode_attention_block(params, x, k_cache, v_cache, cache_len,
                           rope: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]], *,
                           window=0):
    """Decode sub-block: project one token, rotate q and k by ``rope``
    (``rope_angles`` of the position ``cache_len``, which the caller
    computes once per step for all layers; None for no rotation, the JAX
    package's ``use_rope=False``), write k and v at ``cache_len``, attend
    over ``cache_len + 1`` entries. Returns (out, k_cache, v_cache).

    With the ``ringkv`` lever on, a windowed layer whose cache has
    exactly ``window`` rows keeps it as a ring: k and v are written at
    ``cache_len % window`` and the token attends to all ``min(cache_len +
    1, window)`` rows with no window mask. K carries the RoPE of its true
    position, so the ring is the window whatever order its rows are in.

    The caches are written in place (the JAX package returns new
    arrays): its callers never reuse a cache from before a step.
    ``cache_len`` is an int or an int32 tensor of one element on x's
    device; then the write index and the attended length are computed
    on the device, with no host index. Off the ring it must be below the
    cache length: the JAX package's ``dynamic_update_slice`` clamps the
    write index and silently overwrites the last row instead. An int is
    checked here; a tensor's caller, which knows the step, keeps it in
    range."""
    S_cache = k_cache.shape[1]
    ring = bool(feature("ringkv") and window and S_cache == window)
    if isinstance(cache_len, torch.Tensor):
        at = (torch.remainder(cache_len, S_cache) if ring
              else cache_len).reshape(1)
        length = (torch.clamp(cache_len + 1, max=S_cache) if ring
                  else cache_len + 1)
    else:
        if cache_len < 0 or (not ring and cache_len >= S_cache):
            raise ValueError(f"decode_attention_block: the cache holds "
                             f"{S_cache} entries; cannot write at "
                             f"{cache_len}")
        w = cache_len % S_cache if ring else cache_len
        at = slice(w, w + 1)
        length = min(cache_len + 1, S_cache) if ring else cache_len + 1
    q = project(x, params["wq"])
    k = project(x, params["wk"])
    v = project(x, params["wv"])
    if rope is not None:
        q, k = rotate(q, *rope), rotate(k, *rope)
    k_cache[:, at] = k.to(k_cache.dtype)
    v_cache[:, at] = v.to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, length,
                           window=0 if ring else window)
    return unproject(out, params["wo"]), k_cache, v_cache


def _block_mask(qpos, kpos, causal, window):
    """qpos: (qb,), kpos: (kb,) -> (qb, kb) validity; a position of -1
    (padding) is never a valid key."""
    valid = (kpos[None, :] >= 0).expand(qpos.shape[0], -1)
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
    if window:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    return valid


def _scaled(q, scale):
    """q times ``scale`` rounded to q's dtype (as the JAX package scales),
    then fp32 for the products. The scale is a tensor made on the
    device (a host copy cannot be captured in a CUDA graph)."""
    return (q * torch.full((), scale, dtype=q.dtype,
                           device=q.device)).float()


def _masked_softmax_attention(q, k, v, valid, R):
    """One query block's attention, q (B, Sq, Kv * R, hd) against its KV
    band k, v (B, Skv, Kv, hd) under ``valid`` (Sq, Skv): fp32 scores,
    masked scores ``NEG_INF``, the softmax, p rounded to v's dtype, fp32
    PV. q is already scaled and fp32. Returns (B, Sq, H, hd) fp32."""
    B, Sq, H, hd = q.shape
    qg = q.reshape(B, Sq, H // R, R, hd)
    s = torch.einsum("bqkrh,bskh->bkrqs", qg, k.float())
    s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrqs,bskh->bkrqh", p.to(v.dtype).float(),
                       v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def _banded_attention(q, k, v, *, window, q_block=512):
    """The ``banded`` lever: causal sliding-window self-attention (aligned
    q and kv, positions 0 ... S - 1) that gathers only the KV band of each
    query block, ``band = (window // qb + 2) * qb`` keys starting at
    ``qs + qb - band`` clipped to ``[0, Skv - band]``, which covers
    ``(qs - window, qs + qb)``: O(S window) work, not O(S^2). Each block
    is one masked softmax over its band (the JAX package scans the blocks,
    or unrolls them in probe mode; here they are a loop either way)."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    R = H // Kv
    qb = min(q_block, Sq)
    pad = (-Sq) % qb
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    nq = q.shape[1] // qb
    band = min((window // qb + 2) * qb, Skv)
    qs = _scaled(q, hd ** -0.5)
    dev = q.device
    outs = []
    for i in range(nq):
        start = min(max(i * qb + qb - band, 0), Skv - band)
        kpos = start + torch.arange(band, device=dev)
        qpos = i * qb + torch.arange(qb, device=dev)
        valid = ((kpos[None, :] <= qpos[:, None])
                 & (kpos[None, :] > qpos[:, None] - window))
        outs.append(_masked_softmax_attention(
            qs[:, i * qb:(i + 1) * qb], k[:, start:start + band],
            v[:, start:start + band], valid, R))
    return torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)


def flash_attention(q, k, v, *, causal, window=0, q_positions=None,
                    kv_positions=None, q_block=512, kv_block=512):
    """Blockwise online-softmax attention.

    q: (B, Sq, H, hd); k, v: (B, Skv, Kv, hd), H = Kv * R (GQA);
    positions (Sq,) and (Skv,) int tensors, default 0 ... S - 1.
    Returns (B, Sq, H, hd) in q's dtype.

    Under the ``banded`` lever, with a window, causal, and more keys
    than the window, it goes to ``_banded_attention``, as the JAX
    package does."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    R = H // Kv
    dev = q.device
    if feature("banded") and window and causal and Skv > window:
        return _banded_attention(q, k, v, window=window, q_block=q_block)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)

    q_block, kv_block = min(q_block, Sq), min(kv_block, Skv)
    pq, pk = (-Sq) % q_block, (-Skv) % kv_block
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_positions = F.pad(q_positions, (0, pq), value=-1)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        kv_positions = F.pad(kv_positions, (0, pk), value=-1)
    nq, nk = q.shape[1] // q_block, k.shape[1] // kv_block
    qs = _scaled(q, hd ** -0.5)
    k32 = k.float()
    outs = []
    for i in range(nq):
        q_i = qs[:, i * q_block:(i + 1) * q_block].reshape(
            B, q_block, Kv, R, hd)
        qp_i = q_positions[i * q_block:(i + 1) * q_block]
        m = torch.full((B, Kv, R, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Kv, R, q_block, hd), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            sl = slice(j * kv_block, (j + 1) * kv_block)
            s = torch.einsum("bqkrh,bskh->bkrqs", q_i, k32[:, sl])
            mask = _block_mask(qp_i, kv_positions[sl], causal, window)
            s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkrqs,bskh->bkrqh", p.to(v.dtype).float(),
                v[:, sl].float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, qb, Kv, R, hd)
    out = torch.cat(outs, dim=1).reshape(B, nq * q_block, H, hd)
    return out[:, :Sq].to(q.dtype)


def attention_block(params, x, *, num_kv_heads, rope_theta, causal=True,
                    window=0, positions=None, kv_x=None, use_rope=True,
                    partial=False):
    """Full attention sub-block (projections, RoPE, ``flash_attention``,
    output projection) on x (B, S, d); positions (S,), default 0 ... S -
    1. With ``kv_x`` (B, Skv, d) it is cross-attention: k and v project
    ``kv_x``, nothing is rotated, and queries and keys take the default
    positions (so ``causal`` and ``window`` see 0 ... S - 1 against 0
    ... Skv - 1). Returns (B, S, d).

    ``partial``: the params are one rank's heads (the 2-D route's
    tensor-parallel attention) and the output projection is returned in
    fp32 (exact products, an fp32 sum), to be summed over the ranks'
    heads before one rounding."""
    S = x.shape[1]
    src = x if kv_x is None else kv_x
    q = project(x, params["wq"])
    k = project(src, params["wk"])
    v = project(src, params["wv"])
    if use_rope and kv_x is None:
        pos = (torch.arange(S, device=x.device) if positions is None
               else positions)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    own = positions if kv_x is None else None
    out = flash_attention(q, k, v, causal=causal, window=window,
                          q_positions=own, kv_positions=own)
    if partial:
        return torch.einsum("bsnh,nhd->bsd", out.float(),
                            params["wo"].float())
    return unproject(out, params["wo"])
