"""TIFeD integer epoch for every slot at once, as a CUDA C++ kernel.

Replaces the TPU kernel ``repro/kernels/online_sgd_int8.py::
dfa_epoch_int8`` (``_dfa_epoch_kernel``). The kernel
(``csrc/dfa_epoch_int8.cu``) runs one CTA per slot, so one launch
advances all B slots of the adaptation server by one epoch; its source
gives the design and the bound. This module checks the operands and
launches it through ``ctypes``; a CPU tensor gets the plain version
``ref.dfa_int8_epoch`` instead.

The serving tick calls it once per step, and the round engine once per
TIFeD epoch of a cohort, so the wrapper is kept lean:
the checks compare tuples of shapes and dtypes, the seven outputs are
views of one allocation (``carve_outputs``), and the launch goes
through ``build.launch_on`` on the current stream.

CUDA C++ and not Triton: the arithmetic must be integer-exact with the
rounding under control, and the sine MLP's 1-wide contractions are
below ``tl.dot``'s smallest tile.
"""
from __future__ import annotations

import ctypes
import functools
from operator import attrgetter
from typing import Sequence

import torch

from repro_torch.kernels import build, costs, ref

MAX_SMEM = 232448          # bytes of shared memory an H100 block may use
_I8, _I32, _F32 = torch.int8, torch.int32, torch.float32
# the operands in the order the kernel takes them
_NAMES = ("xq", "yal", "w0", "w1", "w2", "b0", "b1", "b2", "fb1", "fb2",
          "d0", "d1", "d2", "scales", "layer")
_KINDS = (_I8, _I32, _I8, _I8, _I8, _I32, _I32, _I32, _I8, _I8, _F32, _F32,
          _F32, _F32, _I32)
_SHAPE, _DTYPE = attrgetter("shape"), attrgetter("dtype")
_ALIGN = 16                # bytes: where each output view starts


@functools.lru_cache(maxsize=1)
def _bind():
    """The library's entry points, typed; built at first use: the launch
    (a compile-time instantiation where one matches the shape: the sine
    MLP at S = 8 and S = 32), the shared-memory size, and the launch
    that always takes the generic instantiation."""
    lib = build.load("dfa_epoch_int8")
    launches = []
    for name in ("dfa_epoch_int8_launch", "dfa_epoch_int8_launch_generic"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launches.append(fn)
    sm = lib.dfa_epoch_int8_smem_bytes
    sm.argtypes = [ctypes.c_int] * 5
    sm.restype = ctypes.c_size_t
    return launches[0], sm, launches[1]


@functools.lru_cache(maxsize=64)
def _shapes(B, S, din, h1, h2, dout):
    """The shape each operand of ``_NAMES`` must have."""
    return ((B, S, din), (B, S, dout), (B, din, h1), (B, h1, h2),
            (B, h2, dout), (B, h1), (B, h2), (B, dout), (dout, h1),
            (dout, h2), (B, din, h1), (B, h1, h2), (B, h2, dout), (10,),
            (B,))


@functools.lru_cache(maxsize=64)
def output_layout(B, din, h1, h2, dout):
    """Where the seven outputs lie in one int8 buffer: ``(total bytes,
    ((shape, stride, offset), ...), byte offsets)`` for w0', w1', w2'
    (int8), b0', b1', b2' (int32) and the loss (fp32), each view starting
    on a 16-byte boundary, its ``offset`` counted in its own elements."""
    views, starts, at = [], [], 0
    for size, shape in ((1, (B, din, h1)), (1, (B, h1, h2)), (1, (B, h2, dout)),
                        (4, (B, h1)), (4, (B, h2)), (4, (B, dout)), (4, (B,))):
        stride = tuple(int(torch.Size(shape[k + 1:]).numel())
                       for k in range(len(shape)))
        views.append((shape, stride, at // size))
        starts.append(at)
        at = -(-(at + size * torch.Size(shape).numel()) // _ALIGN) * _ALIGN
    return at, tuple(views), tuple(starts)


@functools.lru_cache(maxsize=64)
def _launch_plan(B, S, din, h1, h2, dout):
    """(shared memory a CTA needs, ``output_layout``) for these dims."""
    return (_bind()[1](S, din, h1, h2, dout),
            output_layout(B, din, h1, h2, dout))


def carve_outputs(buf: torch.Tensor, layout):
    """The seven output views of ``buf`` (int8, ``layout[0]`` bytes, 16-byte
    aligned) where ``output_layout`` places them: ((w0', w1', w2'), (b0',
    b1', b2'), loss). Works on any device."""
    v0, v1, v2, v3, v4, v5, v6 = layout[1]
    i32 = buf.view(_I32)
    return ((buf.as_strided(*v0), buf.as_strided(*v1), buf.as_strided(*v2)),
            (i32.as_strided(*v3), i32.as_strided(*v4), i32.as_strided(*v5)),
            buf.view(_F32).as_strided(*v6))


def _check(ins):
    """Raise unless every operand has its dtype and shape and all lie on
    one device; returns (B, S, din, h1, h2, dout)."""
    xq, w0, w1, w2 = ins[0], ins[2], ins[3], ins[4]
    if xq.dim() != 3 or w0.dim() != 3 or w1.dim() != 3 or w2.dim() != 3:
        raise ValueError("xq and the weights need a leading slot axis")
    B, din, h1 = w0.shape
    dims = (B, xq.shape[1], din, h1, w1.shape[2], w2.shape[2])
    want = _shapes(*dims)
    if tuple(map(_SHAPE, ins)) != want or tuple(map(_DTYPE, ins)) != _KINDS:
        for name, t, dtype, shape in zip(_NAMES, ins, _KINDS, want):
            if t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(f"dfa_epoch_int8: {name} must be {dtype} "
                                 f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if len(set(map(torch.Tensor.get_device, ins))) != 1:
        raise ValueError("dfa_epoch_int8: the operands lie on "
                         f"{sorted(set(str(t.device) for t in ins))}; "
                         "they must share one device")
    return dims


def _launch(entry: int, ins, dims):
    """Launch entry point ``entry`` of ``_bind()`` on CUDA operands."""
    B, S, din, h1, h2, dout = dims
    if not all(map(torch.Tensor.is_contiguous, ins)):
        raise ValueError("dfa_epoch_int8: every operand must be contiguous")
    smem, layout = _launch_plan(B, S, din, h1, h2, dout)
    if smem > MAX_SMEM:
        raise ValueError(
            f"dfa_epoch_int8: S={S}, dims={(din, h1, h2, dout)} need "
            f"{smem} bytes of shared memory per slot; the limit is "
            f"{MAX_SMEM}")
    xq = ins[0]
    buf = torch.empty(layout[0], dtype=_I8, device=xq.device)
    ow, ob, loss = carve_outputs(buf, layout)
    base = buf.data_ptr()
    err = build.launch_on(xq.get_device(), _bind()[entry],
                          *map(torch.Tensor.data_ptr, ins),
                          *(base + at for at in layout[2]),
                          B, S, din, h1, h2, dout)
    if err != 0:
        raise RuntimeError(f"dfa_epoch_int8 launch failed: cudaError {err}")
    return ow, ob, loss


def dfa_epoch_int8(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                   xq, yal, layer, fb, dither, scales):
    """One TIFeD epoch per slot; the contract of ``ref.dfa_int8_epoch``
    (native int8 / int32 operands with a leading slot axis, per-slot
    ``layer``, packed (10,) fp32 ``scales``). Returns (ws', bs', loss).
    ``dfa_epoch_int8.launches`` counts kernel launches; a fake or
    ``meta`` operand gets the outputs' shapes alone
    (``costs.shape_only``)."""
    ins = (xq, yal, *ws, *bs, *fb, *dither, scales, layer)
    dims = _check(ins)
    mode = costs.active()
    if mode is not None:
        mode.record("dfa_epoch_int8", *cost(ins, dims))
    if costs.shape_only(xq):
        costs.same_device("dfa_epoch_int8", *ins)
        return (tuple(costs.empty_like_shape(w) for w in ws),
                tuple(costs.empty_like_shape(b) for b in bs),
                costs.empty_like_shape(scales, (dims[0],)))
    if xq.get_device() < 0:
        if any(t.device.type != "cpu" for t in ins):
            raise ValueError(f"dfa_epoch_int8: unsupported device "
                             f"{xq.device}")
        with costs.uncounted():
            return ref.dfa_int8_epoch(ws, bs, xq, yal, layer, fb, dither,
                                      scales)
    out = _launch(0, ins, dims)
    dfa_epoch_int8.launches += 1
    return out


def cost(ins, dims):
    """(operations, bytes) of one epoch: for each slot and sample the
    three layers' products forward, the error's projection through the
    two feedback matrices, and the three rank-one updates, two operations
    a multiply-add; every operand read once and every output written
    once."""
    B, S, din, h1, h2, dout = dims
    weights = din * h1 + h1 * h2 + h2 * dout
    ops = 2 * B * S * (2 * weights + dout * (h1 + h2))
    outs = B * (weights + 4 * (h1 + h2 + dout) + 4)
    return ops, sum(t.numel() * t.element_size() for t in ins) + outs


dfa_epoch_int8.launches = 0


def dfa_epoch_int8_generic(ws, bs, xq, yal, layer, fb, dither, scales):
    """``dfa_epoch_int8`` on CUDA tensors through the generic
    instantiation whatever the shape: no path calls it; it times a
    specialized instantiation against the generic one."""
    ins = (xq, yal, *ws, *bs, *fb, *dither, scales, layer)
    dims = _check(ins)
    if xq.get_device() < 0:
        raise ValueError("dfa_epoch_int8_generic runs on CUDA tensors")
    return _launch(2, ins, dims)
