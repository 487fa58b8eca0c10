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
levers, two change the work on one device: ``banded``
(``_banded_attention``: each query block against its KV band only) and
the ``ringkv`` decode step (a cache of ``window`` rows written as a
ring, attended through ``flash_decode`` with window 0). Two act on the
production mesh's train and prefill attention
(``models/transformer.py::_attention_route``): ``gqa_flat``
(``attention_block(heads=)``: K and V repeated to the H query heads, a
rank's H / model of them kept, where the kv heads do not split over
``model``) and ``seqpar`` (``attention_rows``: a rank's S / model query
rows against every key). With no mesh both compute what the default
route computes, which they take; so does probe mode's single-shot
masked attention, which serves XLA's cost analysis. The 2-D route's
tensor-parallel attention runs ``attention_block`` on a rank's heads
with ``partial=True``.

On the production mesh a decode cache splits on its sequence over the
ranks (``runtime.sharding.CacheShards``): ``cache_attention`` writes the
new k and v on the rank that owns their row, each rank attends its slice
(``decode_attention(offset=, lse=True)``, the kernel's log-sum-exp out)
and ``merge_partials`` merges the slices across the ranks.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import normal_init, promoted
from repro_torch.runtime.flags import feature
from repro_torch.runtime.sharding import MERGE_CALLS, all_reduce

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


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0, offset=0,
                     lse=False):
    """Single-token attention against a KV cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, S, Kv, hd); cache_len: the
    number of valid cache entries, an int or an int32 tensor of one element
    on q's device (the JAX package's traced scalar; ``flash_decode`` reads
    it on the card). The new token attends to ``cache[max(0, cache_len -
    window):cache_len]``. Returns (B, 1, H, hd) in q's dtype.

    ``offset`` and ``lse``: the caches are one rank's slice of a cache
    split on its sequence, from global position ``offset`` (``cache_len``
    and ``window`` stay global); with ``lse`` the result is ``(out,
    lse)``, the slice's partial output in fp32 (whatever q's dtype) and its
    fp32 log-sum-exp (B, 1, H), to be merged across the ranks by
    ``merge_partials``, which rounds the merged output once."""
    B, _, H, hd = q.shape
    out = ops.flash_decode(q.reshape(B, H, hd), k_cache, v_cache, cache_len,
                           window=window, offset=offset, return_lse=lse)
    if lse:
        return out[0].reshape(B, 1, H, hd), out[1].reshape(B, 1, H)
    return out.reshape(B, 1, H, hd)


def merge_partials(out, lse, groups, dtype=None):
    """The slices' partial outputs ``out`` (..., H, hd) and their
    log-sum-exps ``lse`` (..., H) merged over each process group of
    ``groups`` in turn (None skipped): ``M = max_r lse_r`` (an ``all_reduce``
    MAX), then ``out = sum_r e^(lse_r - M) out_r / sum_r e^(lse_r - M)`` in
    fp32, with one ``all_reduce`` of the weighted outputs and the weights
    together (gloo takes only ``all_reduce`` and ``broadcast`` of CUDA
    tensors), and ``lse = M + log sum_r e^(lse_r - M)`` for the next
    group. The merge is associative, so a sequence split over several mesh
    axes is merged one axis at a time, in the order of its spec. An empty
    slice (-inf) weighs exactly 0; a group whose slices are all empty gives
    0 and -inf. Returns ``(out in dtype, lse)``, ``dtype`` by default
    out's: the partials are fp32, so the merged output is rounded once,
    here, as one call over the whole cache rounds it. Not bit-equal to
    that call: its tolerance is the caller's."""
    o = out.float()
    for group in groups:
        if group is None:
            continue
        m = lse.clone()
        _count_merge("max", m)
        all_reduce(m, group, "max")
        m = torch.where(m == -math.inf, torch.zeros_like(m), m)
        w = torch.exp(lse - m)[..., None]
        buf = torch.cat([o * w, w], dim=-1)
        _count_merge("sum", buf)
        all_reduce(buf, group)
        den = buf[..., -1:]
        o = buf[..., :-1] / torch.where(den > 0, den, torch.ones_like(den))
        lse = m + torch.log(den[..., 0])
    return o.to(out.dtype if dtype is None else dtype), lse


def _count_merge(kind, t):
    MERGE_CALLS[kind] += 1
    MERGE_CALLS[kind + "_bytes"] += t.numel() * t.element_size()


def cache_attention(q, k, v, k_cache, v_cache, cache_len, *, window=0,
                    seq=None):
    """Write one token's k and v (B, 1, Kv, hd) into the caches at
    ``cache_len`` and attend q (B, 1, H, hd) over them, as
    ``decode_attention_block`` describes (the ring included). Returns (B,
    1, H, hd) in q's dtype.

    ``seq`` (a ``runtime.sharding.SeqSlice``): the caches are this rank's
    slice of the sequence, global rows ``seq.offset ...``, of
    ``seq.rows`` in all. Only the rank that owns the written row (the ring
    slot ``cache_len % seq.rows`` on a ring) writes it: with a tensor
    cursor through a clamped local index and a ``torch.where`` against the
    row already there, nothing read on the host. Every rank then attends
    over its slice and the partials are merged over ``seq.groups``."""
    S_cache = k_cache.shape[1]
    rows = S_cache if seq is None else seq.rows
    offset = 0 if seq is None else seq.offset
    ring = bool(feature("ringkv") and window and rows == window)
    if isinstance(cache_len, torch.Tensor):
        w = torch.remainder(cache_len, rows) if ring else cache_len
        length = (torch.clamp(cache_len + 1, max=rows) if ring
                  else cache_len + 1)
        if seq is None:
            at = w.reshape(1)
            k_cache[:, at] = k.to(k_cache.dtype)
            v_cache[:, at] = v.to(v_cache.dtype)
        else:
            local = (w - offset).reshape(1)
            own = (local >= 0) & (local < S_cache)
            at = local.clamp(0, S_cache - 1)
            k_cache[:, at] = torch.where(own, k.to(k_cache.dtype),
                                         k_cache[:, at])
            v_cache[:, at] = torch.where(own, v.to(v_cache.dtype),
                                         v_cache[:, at])
    else:
        if cache_len < 0 or (not ring and cache_len >= rows):
            raise ValueError(f"decode_attention_block: the cache holds "
                             f"{rows} entries; cannot write at "
                             f"{cache_len}")
        w = (cache_len % rows if ring else cache_len) - offset
        length = min(cache_len + 1, rows) if ring else cache_len + 1
        if 0 <= w < S_cache:
            k_cache[:, w:w + 1] = k.to(k_cache.dtype)
            v_cache[:, w:w + 1] = v.to(v_cache.dtype)
    window = 0 if ring else window
    if seq is None:
        return decode_attention(q, k_cache, v_cache, length, window=window)
    out, lse = decode_attention(q, k_cache, v_cache, length, window=window,
                                offset=offset, lse=True)
    return merge_partials(out, lse, seq.groups, q.dtype)[0]


def decode_attention_block(params, x, k_cache, v_cache, cache_len,
                           rope: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]], *,
                           window=0, seq=None):
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
    range.

    ``seq``: the caches are this rank's slice of a cache split on its
    sequence (``cache_attention``)."""
    q = project(x, params["wq"])
    k = project(x, params["wk"])
    v = project(x, params["wv"])
    if rope is not None:
        q, k = rotate(q, *rope), rotate(k, *rope)
    out = cache_attention(q, k, v, k_cache, v_cache, cache_len,
                          window=window, seq=seq)
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


def _banded_attention(q, k, v, *, window, q_block=512, q_offset=0):
    """The ``banded`` lever: causal sliding-window self-attention (keys
    at positions 0 ... Skv - 1, queries at ``q_offset`` on: 0 unless q
    is one rank's rows under ``seqpar``) that gathers only the KV band
    of each query block, ``band = (window // qb + 2) * qb`` keys starting
    at ``qs + qb - band`` clipped to ``[0, Skv - band]``, which covers
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
        q0 = q_offset + i * qb
        start = min(max(q0 + qb - band, 0), Skv - band)
        kpos = start + torch.arange(band, device=dev)
        qpos = q0 + torch.arange(qb, device=dev)
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
                    partial=False, heads=None):
    """Full attention sub-block (projections, RoPE, ``flash_attention``,
    output projection) on x (B, S, d); positions (S,), default 0 ... S -
    1. With ``kv_x`` (B, Skv, d) it is cross-attention: k and v project
    ``kv_x``, nothing is rotated, and queries and keys take the default
    positions (so ``causal`` and ``window`` see 0 ... S - 1 against 0
    ... Skv - 1). Returns (B, S, d).

    ``partial``: the params are one rank's heads (the 2-D route's
    tensor-parallel attention) and the output projection is returned in
    fp32 (exact products, an fp32 sum), to be summed over the ranks'
    heads before one rounding.

    ``heads`` = (index, parts), the ``gqa_flat`` lever on a mesh whose
    model axis does not divide the kv heads: ``wq`` and ``wo`` are rank
    ``index``'s H / parts heads and ``wk``/``wv`` whole; K and V are
    repeated to the H heads (as ``jnp.repeat`` on the head axis) and this
    rank's H / parts of them kept, so it attends its heads alone."""
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
    if heads is not None:
        index, parts = heads
        n = q.shape[2]
        mine = torch.arange(index * n, (index + 1) * n,
                            device=x.device) // (n * parts // k.shape[2])
        k, v = k.index_select(2, mine), v.index_select(2, mine)
    own = positions if kv_x is None else None
    out = flash_attention(q, k, v, causal=causal, window=window,
                          q_positions=own, kv_positions=own)
    if partial:
        return torch.einsum("bsnh,nhd->bsd", out.float(),
                            params["wo"].float())
    return unproject(out, params["wo"])


def attention_rows(params, x, start, rows, *, rope_theta, window=0,
                   use_rope=True):
    """The ``seqpar`` lever's causal self-attention for the query rows
    ``start ... start + rows - 1`` of x (B, S, d) (one model rank's S /
    model rows): q projected for those rows, K and V for all S, every
    head, each row at its global position (the causal mask, the window
    and RoPE are the whole sequence's), in blocks of 512 query rows (per
    row the JAX package's one block). Under ``banded`` the band route on
    those rows, as the JAX package's ``flash_attention`` takes it first.
    Returns the rows' output projection (B, rows, d)."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    qpos = pos[start:start + rows]
    q = project(x[:, start:start + rows], params["wq"])
    k = project(x, params["wk"])
    v = project(x, params["wv"])
    if use_rope:
        q = apply_rope(q, qpos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    if feature("banded") and window and S > window:
        out = _banded_attention(q, k, v, window=window, q_offset=start)
    else:
        out = flash_attention(q, k, v, causal=True, window=window,
                              q_positions=qpos, kv_positions=pos)
    return unproject(out, params["wo"])
