"""Single-token GQA attention over a KV cache as a CUDA C++ kernel
(flash-decoding).

Replaces the TPU kernel ``repro/kernels/flash_decode.py::flash_decode``
(``_flash_decode_kernel``). The port's ``models/attention.py::
decode_attention`` calls this wrapper once per attention layer per
decode step, so one step of tinyllama-1.1b launches it 22 times.
``csrc/flash_decode.cu`` gives the design (one block per (batch, KV
head) and its query heads, the KV axis split across blocks and the
partials combined by a second kernel) and the bound (the K and V bytes
of the attended positions). This module checks the operands, plans the
split, and launches it through ``ctypes``; a CPU tensor gets the plain
version ``ref.flash_decode``.

The kernel reads only the attended positions ``[max(0, L - window),
L)``; ``L = 0``, which would attend nothing, raises.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32                  # positions per tile of the kernel
MAX_ROWS = 8               # query heads one block takes (kRows)
TARGET_BLOCKS = 4 * 132    # four blocks per SM of an H100


@functools.lru_cache(maxsize=1)
def _bind():
    """The library's entry point, typed; built at first use."""
    launch = build.load("flash_decode").flash_decode_launch
    launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    launch.restype = ctypes.c_int
    return launch


def plan(B: int, Kv: int, R: int, n: int):
    """(n_split, chunk) for n attended positions: the query heads of a KV
    head go to blocks in groups of at most ``MAX_ROWS``, and the positions
    in ``n_split`` stretches of ``chunk`` (a multiple of the tile, every
    stretch non-empty), enough for some ``TARGET_BLOCKS`` blocks."""
    blocks = B * Kv * -(-R // MAX_ROWS)
    tiles = -(-n // TILE)
    n_split = max(1, min(tiles, -(-TARGET_BLOCKS // blocks)))
    chunk = -(-tiles // n_split) * TILE
    return -(-n // chunk), chunk


def _check(q, k_cache, v_cache, cache_len, window):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"flash_decode: q must be (B, H, hd) and the caches "
                         f"(B, S, Kv, hd); got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    B, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != B or \
            k_cache.shape[3] != hd:
        raise ValueError(f"flash_decode: caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)} as (B, S, Kv, hd)")
    if Kv < 1 or H % Kv:
        raise ValueError(f"flash_decode: H={H} query heads must be a "
                         f"multiple of Kv={Kv} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode: q, K and V must share one dtype of "
                        f"float32 or bfloat16; got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on "
                             f"{q.device}")
    L, window = operator.index(cache_len), operator.index(window)
    if not 1 <= L <= S:
        raise ValueError(f"flash_decode: cache_len must be in [1, S={S}]; "
                         f"got {L}")
    if window < 0:
        raise ValueError(f"flash_decode: window must be >= 0; got {window}")
    return L, window


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: int, *,
                 window: int = 0) -> torch.Tensor:
    """q (B, H, hd), caches (B, S, Kv, hd) with H a multiple of Kv, hd 64
    or 128, all fp32 or all bf16; ``cache_len`` an int in [1, S] ->
    (B, H, hd) in q's dtype, as ``ref.flash_decode`` computes it over the
    positions ``[max(0, cache_len - window), cache_len)``. A CPU tensor
    gets the plain version; a CUDA tensor gets the kernel
    (``flash_decode.launches`` counts its launches) or an error."""
    L, window = _check(q, k_cache, v_cache, cache_len, window)
    if q.device.type == "cpu":
        return ref.flash_decode(q, k_cache, v_cache, L,
                                window=window).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode: q and the caches must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode: the caches must start on a 16-byte "
                         "boundary (the kernel reads them in 16-byte "
                         "vectors)")
    B, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    lo = max(0, L - window) if window else 0
    n_split, chunk = plan(B, Kv, H // Kv, L - lo)
    out = torch.empty_like(q)
    ws = (torch.empty(n_split * B * H * (hd + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    launch = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                     out.data_ptr(), 0 if ws is None else ws.data_ptr(),
                     _DTYPE_CODES[q.dtype], B, S, H, Kv, hd, lo, L,
                     chunk, n_split, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
