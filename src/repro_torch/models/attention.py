"""GQA attention on the decode path, the port of the JAX package's
``models/attention.py``: RoPE, and single-token attention against a KV
cache through the hand-written ``flash_decode`` kernel.

The JAX package's ``decode_attention`` is plain jnp (its module says the
decode hot spot dispatches to ``repro.kernels.flash_decode``; no model
path calls the kernel there). The port's routes through
``kernels/ops.py::flash_decode``: the kernel on the card, the plain
version on the CPU. Both compute the same function; in fp32 the two
packages agree to 1e-5.

Only the decode half is ported: the train and prefill attention
(``flash_attention``, ``attention_block``) waits for the dense training
slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops


def attention_shapes(d_model, num_heads, num_kv_heads, head_dim, dtype):
    """``{leaf: (shape, dtype)}`` of one attention sub-block, as
    ``init_attention`` builds it."""
    return {"wq": ((d_model, num_heads, head_dim), dtype),
            "wk": ((d_model, num_kv_heads, head_dim), dtype),
            "wv": ((d_model, num_kv_heads, head_dim), dtype),
            "wo": ((num_heads, head_dim, d_model), dtype)}


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
                           rope: Tuple[torch.Tensor, torch.Tensor], *,
                           window=0):
    """Decode sub-block: project one token, rotate q and k by ``rope``
    (``rope_angles`` of the position ``cache_len``, which the caller
    computes once per step for all layers), write k and v at
    ``cache_len``, attend over ``cache_len + 1`` entries. Returns (out,
    k_cache, v_cache).

    The caches are written in place (the JAX package returns new
    arrays): its callers never reuse a cache from before a step.
    ``cache_len`` is an int or an int32 tensor of one element on x's
    device; then the write and the attention take it on the device, with
    no host index. It must be below the cache length: the JAX package's
    ``dynamic_update_slice`` clamps the write index and silently
    overwrites the last row instead. An int is checked here; a tensor's
    caller, which knows the step, keeps it in range."""
    if isinstance(cache_len, torch.Tensor):
        at = cache_len.reshape(1)
    else:
        S_cache = k_cache.shape[1]
        if not 0 <= cache_len < S_cache:
            raise ValueError(f"decode_attention_block: the cache holds "
                             f"{S_cache} entries; cannot write at "
                             f"{cache_len}")
        at = slice(cache_len, cache_len + 1)
    q = rotate(torch.einsum("bsd,dnh->bsnh", x, params["wq"]), *rope)
    k = rotate(torch.einsum("bsd,dnh->bsnh", x, params["wk"]), *rope)
    v = torch.einsum("bsd,dnh->bsnh", x, params["wv"])
    k_cache[:, at] = k.to(k_cache.dtype)
    v_cache[:, at] = v.to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, cache_len + 1, window=window)
    out = torch.einsum("bsnh,nhd->bsd", out, params["wo"])
    return out, k_cache, v_cache
