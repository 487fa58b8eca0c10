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

A slice (``offset``, ``return_lse``): the caches are rows ``offset ...
offset + S - 1`` of a cache split on its sequence over ranks (the
production decode step, ``models/attention.py``), L and the window stay
global, and the call attends what of ``[max(0, L - window), L)`` falls
in the slice, on both routes (the device-L route shifts and clamps the
stretch on the card, so one captured launch still serves every L). With
``return_lse`` it also returns the (B, H) fp32 log-sum-exp of the
attended scaled scores, and the output is fp32 whatever the caches'
dtype (the kernel's bf16 instantiation with an fp32 output), so that
the slices are merged before anything is rounded; an empty slice gives
zeros and -inf, and with a host-int L launches nothing (a device L is
read only by the kernel, which writes them). The bound of a slice call
is the K and V bytes of its attended local positions.

A fake or ``meta`` tensor (``costs.shape_only``: the dry run's trace)
gets outputs of the right shapes without a launch; under a
``costs.CostMode`` every call records ``cost``'s operations and bytes.
"""
from __future__ import annotations

import ctypes
import functools
import math
import operator

import torch

from repro_torch.kernels import build, costs, ref

HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BF16_FP32_OUT = 2          # bf16 operands, fp32 output: a slice's partial
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
    launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    launch_len.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
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


def _check_int(L, S: int, sliced: bool) -> int:
    """A host-int ``cache_len``: in [1, S], or >= 0 for a slice."""
    L = operator.index(L)
    if not (L >= 0 if sliced else 1 <= L <= S):
        raise ValueError(f"flash_decode: cache_len must be in [1, S={S}] "
                         f"(>= 0 for a slice); got {L}")
    return L


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
                 v_cache: torch.Tensor, cache_len, *, window: int = 0,
                 offset: int = 0, return_lse: bool = False):
    """q (B, H, hd), caches (B, S, Kv, hd) with H a multiple of Kv, hd 64,
    128 or 256, all fp32 or all bf16; ``cache_len`` an int in [1, S], or an
    int32 tensor of one element on q's device -> (B, H, hd) in q's dtype,
    as ``ref.flash_decode`` computes it over the positions ``[max(0,
    cache_len - window), cache_len)``. A CPU tensor gets the plain version;
    a CUDA tensor gets the kernel (``flash_decode.launches`` counts its
    launches) or an error; a fake or ``meta`` one its outputs' shapes
    alone (``costs.shape_only``). A tensor L on the card is never read on
    the host: the kernel reads it (the device-L route).

    ``offset`` (an int >= 0) and ``return_lse`` make the call a slice's
    (the module's docstring): L is global, any int >= 0, and with
    ``return_lse`` the result is ``(out, lse)``, out (B, H, hd) and lse
    (B, H) both fp32, so that the slices merge before anything is
    rounded. A host-int L whose stretch misses the slice launches nothing
    and gives zeros and -inf."""
    B, H, hd, S, Kv = _shapes(q.shape, k_cache.shape, v_cache.shape,
                              q.dtype, k_cache.dtype, v_cache.dtype)
    dev = q.get_device()                # -1 on the CPU
    if k_cache.get_device() != dev or v_cache.get_device() != dev:
        raise ValueError(f"flash_decode: caches on {k_cache.device} and "
                         f"{v_cache.device}, q on {q.device}")
    window, offset = operator.index(window), operator.index(offset)
    if window < 0 or offset < 0:
        raise ValueError(f"flash_decode: window and offset must be >= 0; "
                         f"got {window} and {offset}")
    sliced = bool(offset or return_lse)
    on_device = isinstance(cache_len, torch.Tensor)
    if on_device:
        _check_len(cache_len, dev)
        lo, hi = 0, min(window, S) if window else S
    else:
        lo, hi = local_stretch(_check_int(cache_len, S, sliced), window,
                               offset, S)
    mode = costs.active()
    if mode is not None:
        mode.record("flash_decode", *cost(B, H, hd, Kv, hi - lo, q.dtype,
                                          return_lse))
    out_dtype = torch.float32 if return_lse else q.dtype
    if costs.shape_only(q):
        costs.same_device("flash_decode", q, k_cache, v_cache,
                          *([cache_len] if on_device else []))
        out = costs.empty_like_shape(q, dtype=out_dtype)
        return ((out, costs.empty_like_shape(q, (B, H), torch.float32))
                if return_lse else out)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"flash_decode: unsupported device {q.device}")
        L = _check_int(int(cache_len), S, sliced)   # a CPU tensor: read
        with costs.uncounted():
            out = ref.flash_decode(q, k_cache, v_cache, L, window=window,
                                   offset=offset, return_lse=return_lse)
        return out if return_lse else out.to(q.dtype)
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("flash_decode: q and the caches must be contiguous")
    if not on_device and hi <= lo:      # a slice the stretch misses
        out = torch.zeros((B, H, hd), dtype=out_dtype, device=q.device)
        return ((out, torch.full((B, H), -math.inf, dtype=torch.float32,
                                 device=q.device)) if return_lse else out)
    k_ptr, v_ptr = k_cache.data_ptr(), v_cache.data_ptr()
    if k_ptr % 16 or v_ptr % 16:
        raise ValueError("flash_decode: the caches must start on a 16-byte "
                         "boundary (the kernel reads them in 16-byte "
                         "vectors)")
    code = _DTYPE_CODES[q.dtype]
    cap = CLUSTER_SPLITS if code else MAX_SPLITS
    if code and return_lse:
        code = BF16_FP32_OUT
    out = torch.empty((B, H, hd), dtype=out_dtype, device=q.device)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lse_ptr = lse.data_ptr() if return_lse else 0
    if on_device:
        err = build.launch_on(
            dev, _launch_len, dev, q.data_ptr(), k_ptr, v_ptr,
            out.data_ptr(), cache_len.data_ptr(), lse_ptr, code, B, S, H,
            Kv, hd, window, offset, splits_for(B, Kv, H // Kv, hi, cap),
            split_cap(B, Kv, H // Kv, cap), MIN_TILES)
    else:
        n_split, chunk = (plan(B, Kv, H // Kv, hi - lo, cap) if hi > lo
                          else (1, TILE))
        err = build.launch_on(dev, _launch, dev, q.data_ptr(), k_ptr,
                              v_ptr, out.data_ptr(), lse_ptr, code, B, S, H,
                              Kv, hd, lo, hi, chunk, n_split)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {err}")
    flash_decode.launches += 1
    return (out, lse) if return_lse else out


def cost(B: int, H: int, hd: int, Kv: int, n: int, dtype: torch.dtype,
         return_lse: bool = False):
    """(operations, bytes) of one call attending ``n`` positions: q K^T
    and P V, 4 B H n hd; the attended K and V read once, q read and the
    output (and the log-sum-exp) written once. A device-L call is counted
    at its longest stretch, which its grid is planned for."""
    size = dtype.itemsize
    out_size = 4 if return_lse else size
    moved = (2 * B * n * Kv * hd * size + B * H * hd * (size + out_size)
             + (4 * B * H if return_lse else 0))
    return 4 * B * H * n * hd, moved


def local_stretch(L: int, window: int, offset: int, S: int):
    """The local rows ``[lo, hi)`` that a cache slice of S rows from
    global position ``offset`` attends for global length L: ``[max(0, L -
    window), L)`` (``[0, L)`` without a window) shifted by ``-offset`` and
    clamped to [0, S]; ``lo == hi`` for an empty slice."""
    glo = max(0, L - window) if window else 0
    return (min(max(glo - offset, 0), S), min(max(L - offset, 0), S))


def _workspace(index, stream, dtype, B, H, Kv, hd, n_split):
    """The fp32 split merge's workspace and counters for a grid of
    ``n_split`` splits, or none."""
    if n_split > 1 and dtype == 0:
        return _scratch(index, stream, *scratch_sizes(B, H, Kv, hd, n_split))
    return 0, 0


def _launch(index, q, k, v, out, lse, dtype, B, S, H, Kv, hd, lo, hi, chunk,
            n_split, stream):
    ws, counters = _workspace(index, stream, dtype, B, H, Kv, hd, n_split)
    return _bind()[0](q, k, v, out, ws, counters, lse, dtype, B, S, H, Kv,
                      hd, lo, hi, chunk, n_split, hd ** -0.5, stream)


def _launch_len(index, q, k, v, out, len_ptr, lse, dtype, B, S, H, Kv, hd,
                window, offset, n_grid, cap, min_tiles, stream):
    ws, counters = _workspace(index, stream, dtype, B, H, Kv, hd, n_grid)
    return _bind()[1](q, k, v, out, ws, counters, len_ptr, lse, dtype, B, S,
                      H, Kv, hd, window, offset, n_grid, cap, min_tiles,
                      hd ** -0.5, stream)


flash_decode.launches = 0
