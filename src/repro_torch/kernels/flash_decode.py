"""Single-token GQA attention over a KV cache as a CUDA C++ kernel
(flash-decoding).

Replaces the TPU kernel ``repro/kernels/flash_decode.py::flash_decode``
(``_flash_decode_kernel``). The port's ``models/attention.py::
decode_attention`` calls this wrapper once per attention layer per
decode step, so one step of tinyllama-1.1b launches it 22 times.
``csrc/flash_decode.cu`` gives the design (one block per (batch, KV
head) and its query heads, the KV axis split across blocks whose
partials are merged inside the same launch, bf16 on the tensor cores)
and the bound (the K and V bytes of the attended positions). This module checks the operands, plans the split, and
launches it through ``ctypes``; a CPU tensor gets the plain version
``ref.flash_decode``.

The kernel reads only the attended positions ``[max(0, L - window),
L)``; ``L = 0``, which would attend nothing, raises. L is a host int, or
an int32 tensor of one element on q's device, as the TPU kernel reads it
from SMEM: then the wrapper never reads it on the host, the grid is
planned for the longest stretch the call allows (S, or the window), and
the kernel plans the split from L on the device by ``plan``'s rule, so one
launch recorded in a CUDA graph serves every L, bit-equal to the host-int
call at the same L. The kernel clamps a device L to [1, S]; its caller
keeps it in range.

A split bf16 call merges its splits inside a thread-block cluster and
needs no scratch. A split fp32 call uses a workspace for the splits'
partials and one counter per (batch, head group), both held per (device,
stream) and grown on demand. The counters are allocated zeroed and
every call leaves them at 0, so no call clears them or waits on the
host.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                  # positions per tile of the bf16 kernel
MAX_ROWS = 8               # query heads one block takes (kRows)
MAX_SPLITS = 128           # fp32: kMaxSplits
CLUSTER_SPLITS = 8         # bf16: kMaxCluster, a portable cluster's blocks
MIN_TILES = 4              # tiles a block streams, where n allows
TARGET_BLOCKS = 4 * 132    # blocks a call aims for: four per SM of an H100

# (device index, stream) -> (workspace, counters)
_SCRATCH: dict = {}
# outgrown scratch, kept: a captured CUDA graph may still point at it
_OUTGROWN: list = []


@functools.lru_cache(maxsize=1)
def _bind():
    """The library's entry points, typed; built at first use: the host-int
    route and the device-L route."""
    lib = build.load("flash_decode")
    launch, launch_len = lib.flash_decode_launch, lib.flash_decode_launch_len
    launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    launch_len.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                           + [ctypes.c_float, ctypes.c_void_p])
    launch.restype = launch_len.restype = ctypes.c_int
    return launch, launch_len


def split_cap(B: int, Kv: int, R: int, max_splits: int) -> int:
    """The most splits a call takes: enough for some ``TARGET_BLOCKS``
    blocks, whose query heads of a KV head go in groups of at most
    ``MAX_ROWS``, and at most ``max_splits``."""
    return min(-(-TARGET_BLOCKS // (B * Kv * -(-R // MAX_ROWS))), max_splits)


def splits_for(B: int, Kv: int, R: int, n: int, max_splits: int) -> int:
    """The splits ``plan`` aims n positions at, before it drops the empty
    ones: at most ``split_cap``, each streaming at least ``MIN_TILES``
    tiles where n has them. Monotone in n, so the device-L route's grid,
    sized by it for the longest stretch, holds every shorter one's."""
    return max(1, min(-(-n // TILE) // MIN_TILES,
                      split_cap(B, Kv, R, max_splits)))


@functools.lru_cache(maxsize=4096)
def plan(B: int, Kv: int, R: int, n: int, max_splits: int = MAX_SPLITS):
    """(n_split, chunk) for n attended positions: ``splits_for``'s count
    of stretches of ``chunk`` positions (whole tiles), less those left
    empty: some ``TARGET_BLOCKS`` blocks, each streaming at least
    ``MIN_TILES`` tiles where n has them, at most ``max_splits``
    (``CLUSTER_SPLITS`` for bf16, whose splits are one cluster). The
    device-L route's kernel plans by this rule from L on the device."""
    tiles = -(-n // TILE)
    chunk = -(-tiles // splits_for(B, Kv, R, n, max_splits)) * TILE
    return -(-n // chunk), chunk


def scratch_sizes(B: int, H: int, Kv: int, hd: int, n_split: int):
    """(workspace floats, counters) one fp32 call needs: every split's
    partial accumulator, max and sum for each (b, h), and one counter per
    (b, head group); none without a split. (bf16 merges its splits in
    the cluster's shared memory and needs neither.)"""
    if n_split == 1:
        return 0, 0
    return n_split * B * H * (hd + 2), B * Kv * -(-(H // Kv) // MAX_ROWS)


def _scratch(index: int, stream: int, n_ws: int, n_counters: int):
    """The (device, stream)'s workspace and counters, grown to hold
    ``n_ws`` floats and ``n_counters`` ints. Calls on one stream run in
    order, so they share them safely; a graph captured on the stream keeps
    their addresses, so what is outgrown is kept, never freed."""
    ws, counters = _SCRATCH.get((index, stream), (None, None))
    _OUTGROWN.extend(t for t, n in ((ws, n_ws), (counters, n_counters))
                     if t is not None and t.numel() < n)
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(max(n_ws, 2 * (0 if ws is None else ws.numel())),
                         dtype=torch.float32, device=f"cuda:{index}")
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32,
                               device=f"cuda:{index}")
    _SCRATCH[(index, stream)] = (ws, counters)
    return ws.data_ptr(), counters.data_ptr()


@functools.lru_cache(maxsize=256)
def _shapes(q_shape, k_shape, v_shape, q_dtype, k_dtype, v_dtype):
    """(B, H, hd, S, Kv) of valid operands; raises on invalid ones. Cached,
    as the decode path passes the same shapes at every call."""
    if len(q_shape) != 3 or len(k_shape) != 4:
        raise ValueError(f"flash_decode: q must be (B, H, hd) and the caches "
                         f"(B, S, Kv, hd); got {tuple(q_shape)} and "
                         f"{tuple(k_shape)}")
    B, H, hd = q_shape
    S, Kv = k_shape[1], k_shape[2]
    if v_shape != k_shape or k_shape[0] != B or k_shape[3] != hd:
        raise ValueError(f"flash_decode: caches {tuple(k_shape)} and "
                         f"{tuple(v_shape)} do not match q "
                         f"{tuple(q_shape)} as (B, S, Kv, hd)")
    if Kv < 1 or H % Kv:
        raise ValueError(f"flash_decode: H={H} query heads must be a "
                         f"multiple of Kv={Kv} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {hd} not in {HEAD_DIMS}")
    if q_dtype not in _DTYPE_CODES or k_dtype != q_dtype or \
            v_dtype != q_dtype:
        raise TypeError(f"flash_decode: q, K and V must share one dtype of "
                        f"float32 or bfloat16; got {q_dtype}, {k_dtype}, "
                        f"{v_dtype}")
    return B, H, hd, S, Kv


def _check_len(cache_len: torch.Tensor, dev: int) -> None:
    """A tensor ``cache_len`` must be one int32 on q's device."""
    if cache_len.dtype != torch.int32 or cache_len.numel() != 1:
        raise TypeError(f"flash_decode: a tensor cache_len must be one "
                        f"int32; got {cache_len.dtype} of "
                        f"{cache_len.numel()} elements")
    if cache_len.get_device() != dev:
        raise ValueError(f"flash_decode: cache_len on {cache_len.device}, "
                         f"q on device {dev}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len, *,
                 window: int = 0) -> torch.Tensor:
    """q (B, H, hd), caches (B, S, Kv, hd) with H a multiple of Kv, hd 64,
    128 or 256, all fp32 or all bf16; ``cache_len`` an int in [1, S], or an
    int32 tensor of one element on q's device -> (B, H, hd) in q's dtype,
    as ``ref.flash_decode`` computes it over the positions ``[max(0,
    cache_len - window), cache_len)``. A CPU tensor gets the plain version;
    a CUDA tensor gets the kernel (``flash_decode.launches`` counts its
    launches) or an error. A tensor L on the card is never read on the
    host: the kernel reads it (the device-L route)."""
    B, H, hd, S, Kv = _shapes(q.shape, k_cache.shape, v_cache.shape,
                              q.dtype, k_cache.dtype, v_cache.dtype)
    dev = q.get_device()                # -1 on the CPU
    if k_cache.get_device() != dev or v_cache.get_device() != dev:
        raise ValueError(f"flash_decode: caches on {k_cache.device} and "
                         f"{v_cache.device}, q on {q.device}")
    window = operator.index(window)
    if window < 0:
        raise ValueError(f"flash_decode: window must be >= 0; got {window}")
    if isinstance(cache_len, torch.Tensor):
        _check_len(cache_len, dev)
        if not q.is_cuda:               # a CPU tensor: read, as an int
            cache_len = int(cache_len)
    on_device = isinstance(cache_len, torch.Tensor)
    if not on_device:
        L = operator.index(cache_len)
        if not 1 <= L <= S:
            raise ValueError(f"flash_decode: cache_len must be in "
                             f"[1, S={S}]; got {L}")
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_decode: unsupported device {q.device}")
        return ref.flash_decode(q, k_cache, v_cache, L,
                                window=window).to(q.dtype)
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("flash_decode: q and the caches must be contiguous")
    k_ptr, v_ptr = k_cache.data_ptr(), v_cache.data_ptr()
    if k_ptr % 16 or v_ptr % 16:
        raise ValueError("flash_decode: the caches must start on a 16-byte "
                         "boundary (the kernel reads them in 16-byte "
                         "vectors)")
    code = _DTYPE_CODES[q.dtype]
    cap = CLUSTER_SPLITS if code else MAX_SPLITS
    out = torch.empty_like(q)
    if on_device:
        n_max = min(window, S) if window else S
        err = build.launch_on(
            dev, _launch_len, dev, q.data_ptr(), k_ptr, v_ptr,
            out.data_ptr(), cache_len.data_ptr(), code, B, S, H, Kv, hd,
            window, splits_for(B, Kv, H // Kv, n_max, cap),
            split_cap(B, Kv, H // Kv, cap), MIN_TILES)
    else:
        lo = max(0, L - window) if window else 0
        n_split, chunk = plan(B, Kv, H // Kv, L - lo, cap)
        err = build.launch_on(dev, _launch, dev, q.data_ptr(), k_ptr,
                              v_ptr, out.data_ptr(), code, B, S, H, Kv, hd,
                              lo, L, chunk, n_split)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {err}")
    flash_decode.launches += 1
    return out


def _workspace(index, stream, dtype, B, H, Kv, hd, n_split):
    """The fp32 split merge's workspace and counters for a grid of
    ``n_split`` splits, or none."""
    if n_split > 1 and dtype == 0:
        return _scratch(index, stream, *scratch_sizes(B, H, Kv, hd, n_split))
    return 0, 0


def _launch(index, q, k, v, out, dtype, B, S, H, Kv, hd, lo, L, chunk,
            n_split, stream):
    ws, counters = _workspace(index, stream, dtype, B, H, Kv, hd, n_split)
    return _bind()[0](q, k, v, out, ws, counters, dtype, B, S, H, Kv, hd, lo,
                      L, chunk, n_split, hd ** -0.5, stream)


def _launch_len(index, q, k, v, out, len_ptr, dtype, B, S, H, Kv, hd, window,
                n_grid, cap, min_tiles, stream):
    ws, counters = _workspace(index, stream, dtype, B, H, Kv, hd, n_grid)
    return _bind()[1](q, k, v, out, ws, counters, len_ptr, dtype, B, S, H,
                      Kv, hd, window, n_grid, cap, min_tiles, hd ** -0.5,
                      stream)


flash_decode.launches = 0
