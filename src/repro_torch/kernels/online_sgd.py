"""Streaming SGD update ``p - lr * g`` and its momentum form as CUDA
C++ kernels.

``online_sgd`` replaces the TPU kernel
``repro/kernels/online_sgd.py::online_sgd_2d`` (``_sgd_kernel``), which
the JAX server reaches once per parameter leaf through
``kernels/ops.py::tree_online_sgd``. Here the adaptation server keeps
every slot's parameters in one flat ``(B, 1153)`` buffer, and a
TinyReptile client its 1,153, so one launch of ``csrc/online_sgd.cu``
updates all slots and all six leaves of the sine MLP; the source gives
the design and the bound. At these sizes the host's cost of a launch
is the cost of the update, so the wrapper does little: its checks, one
``torch.empty_like``, one ``ctypes`` call with the pointers and lr by
value on the current stream. A CPU tensor gets the plain version
``ref.online_sgd`` instead. The kernel rounds like the plain version,
so the two agree bit for bit.

``online_sgd_momentum`` replaces ``online_sgd_momentum_2d``
(``_sgd_momentum_kernel``): ``m' = mu * m + g`` in fp32, then ``p' = p -
lr * m'``, one pass that reads p, g and m and writes p' and m' (20 bytes
per element in fp32, 14 with bf16 p and g: 100.2 us and 70.1 us at 2^24
elements). Its kernel is the second entry point of the same source and
its wrapper is as lean: the checks, ``torch.empty_like`` for p' and for
m' (on the card's host two allocations cost less than one carved into
two views), one ``ctypes`` call with lr and mu by value. It also agrees
with its plain version bit for bit. No path calls it (nor does the JAX
package).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, costs, ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}   # online_sgd.cu's dtype
_DTYPES = tuple(_CODES)


@functools.lru_cache(maxsize=1)
def _bind():
    """The library's two entry points, typed; built at first use."""
    lib = build.load("online_sgd")
    fn = lib.online_sgd_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mom = lib.online_sgd_momentum_launch
    mom.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_float,
                                            ctypes.c_void_p]
    mom.restype = ctypes.c_int
    return fn, mom


def _check(p, g):
    """Raise unless p and g share a shape, a supported dtype and a
    device; returns the dtype's code and the device index (-1 off the
    card)."""
    if p.shape != g.shape:
        raise ValueError(f"p {tuple(p.shape)} and g {tuple(g.shape)} "
                         f"differ in shape")
    code = _CODES.get(p.dtype)
    if code is None or g.dtype != p.dtype:
        raise TypeError(f"p and g must share a dtype in {_DTYPES}; got "
                        f"{p.dtype} and {g.dtype}")
    index = p.get_device()
    if g.get_device() != index:
        raise ValueError(f"p on {p.device}, g on {g.device}")
    return code, index


def online_sgd(p: torch.Tensor, g: torch.Tensor, lr: float,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(p - lr * g)`` in fp32 math, stored in p's dtype, as a new
    tensor, or into ``out`` (p's shape, dtype and device; it may be p
    itself, the update in place). A CPU tensor gets the plain version; a
    CUDA tensor gets the kernel (``online_sgd.launches`` counts its
    launches) or an error; a fake or ``meta`` one its output's shape
    alone (``costs.shape_only``). Its cost: a multiply and a subtraction
    an element; p and g read once, the result written once."""
    code, index = _check(p, g)
    if out is not None:
        _check(p, out)
    mode = costs.active()
    if mode is not None:
        mode.record("online_sgd", 2 * p.numel(), 3 * p.numel() * p.itemsize)
    if costs.shape_only(p):
        costs.same_device("online_sgd", p, g, *([] if out is None else [out]))
        return costs.empty_like_shape(p) if out is None else out
    if index < 0:
        if p.device.type != "cpu" or g.device.type != "cpu":
            raise ValueError(f"online_sgd: unsupported device {p.device}, "
                             f"{g.device}")
        with costs.uncounted():
            new = ref.online_sgd(p, g, float(lr))
            return new if out is None else out.copy_(new)
    if out is None:
        out = torch.empty_like(p)
    if not (p.is_contiguous() and g.is_contiguous() and out.is_contiguous()):
        raise ValueError("online_sgd: p, g and out must be contiguous")
    n = p.numel()
    if n:
        err = build.launch_on(index, _bind()[0], p.data_ptr(), g.data_ptr(),
                              out.data_ptr(), n, code, float(lr))
        if err != 0:
            raise RuntimeError(f"online_sgd launch failed: cudaError {err}")
        online_sgd.launches += 1
    return out


online_sgd.launches = 0


def online_sgd_momentum(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                        lr: float, momentum: float):
    """``(p', m')`` with ``m' = momentum * m + g`` (fp32) and ``p' = p -
    lr * m'`` stored in p's dtype, as new tensors. ``m`` must be fp32. A
    CPU tensor gets the plain version; a CUDA tensor gets the kernel
    (``online_sgd_momentum.launches`` counts its launches) or an
    error; a fake or ``meta`` one its outputs' shapes alone. Its cost:
    two multiplies and two adds an element; p, g and m read once, p' and
    m' written once."""
    code, index = _check(p, g)
    if m.shape != p.shape or m.dtype != torch.float32:
        raise ValueError(f"m must be fp32 of shape {tuple(p.shape)}; got "
                         f"{m.dtype} {tuple(m.shape)}")
    if m.get_device() != index:
        raise ValueError(f"p on {p.device}, m on {m.device}")
    mode = costs.active()
    if mode is not None:
        mode.record("online_sgd_momentum", 4 * p.numel(),
                    p.numel() * (3 * p.itemsize + 8))
    if costs.shape_only(p):
        costs.same_device("online_sgd_momentum", p, g, m)
        return costs.empty_like_shape(p), costs.empty_like_shape(m)
    if index < 0:
        if {p.device.type, g.device.type, m.device.type} != {"cpu"}:
            raise ValueError(f"online_sgd_momentum: unsupported device "
                             f"{p.device}")
        with costs.uncounted():
            return ref.online_sgd(p, g, float(lr), m=m,
                                  momentum=float(momentum))
    if not (p.is_contiguous() and g.is_contiguous() and m.is_contiguous()):
        raise ValueError("online_sgd_momentum: p, g and m must be "
                         "contiguous")
    out_p, out_m = torch.empty_like(p), torch.empty_like(m)
    n = p.numel()
    if n:
        err = build.launch_on(index, _bind()[1], p.data_ptr(), g.data_ptr(),
                              m.data_ptr(), out_p.data_ptr(),
                              out_m.data_ptr(), n, code, float(lr),
                              float(momentum))
        if err != 0:
            raise RuntimeError(
                f"online_sgd_momentum launch failed: cudaError {err}")
        online_sgd_momentum.launches += 1
    return out_p, out_m


online_sgd_momentum.launches = 0
