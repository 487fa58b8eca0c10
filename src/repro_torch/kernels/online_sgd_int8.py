"""TIFeD integer epoch for every slot at once, as a CUDA C++ kernel.

Replaces the TPU kernel ``repro/kernels/online_sgd_int8.py::
dfa_epoch_int8`` (``_dfa_epoch_kernel``). The kernel
(``csrc/dfa_epoch_int8.cu``) runs one CTA per slot, so one launch
advances all B slots of the adaptation server by one epoch; its source
gives the design and the bound. This module checks the operands and
launches it through ``ctypes``; a CPU tensor gets the plain version
``ref.dfa_int8_epoch`` instead.

CUDA C++ and not Triton: the arithmetic must be integer-exact with the
rounding under control, and the sine MLP's 1-wide contractions are
below ``tl.dot``'s smallest tile.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import build, ref

MAX_SMEM = 232448          # bytes of shared memory an H100 block may use
_I8, _I32, _F32 = torch.int8, torch.int32, torch.float32


@functools.lru_cache(maxsize=1)
def _bind():
    """The library's two entry points, typed; built at first use."""
    lib = build.load("dfa_epoch_int8")
    fn = lib.dfa_epoch_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sm = lib.dfa_epoch_int8_smem_bytes
    sm.argtypes = [ctypes.c_int] * 5
    sm.restype = ctypes.c_size_t
    return fn, sm


def _dims(ws, xq, yal):
    B, din, h1 = ws[0].shape
    h2, dout = ws[2].shape[1], ws[2].shape[2]
    return B, xq.shape[1], din, h1, h2, dout


def _check(ws, bs, xq, yal, layer, fb, dither, scales):
    if xq.dim() != 3 or any(w.dim() != 3 for w in ws):
        raise ValueError("xq and the weights need a leading slot axis")
    B, S, din, h1, h2, dout = _dims(ws, xq, yal)
    want = {
        "w0": (ws[0], _I8, (B, din, h1)), "w1": (ws[1], _I8, (B, h1, h2)),
        "w2": (ws[2], _I8, (B, h2, dout)), "b0": (bs[0], _I32, (B, h1)),
        "b1": (bs[1], _I32, (B, h2)), "b2": (bs[2], _I32, (B, dout)),
        "xq": (xq, _I8, (B, S, din)), "yal": (yal, _I32, (B, S, dout)),
        "layer": (layer, _I32, (B,)), "fb1": (fb[0], _I8, (dout, h1)),
        "fb2": (fb[1], _I8, (dout, h2)),
        "d0": (dither[0], _F32, (B, din, h1)),
        "d1": (dither[1], _F32, (B, h1, h2)),
        "d2": (dither[2], _F32, (B, h2, dout)),
        "scales": (scales, _F32, (10,)),
    }
    dev = xq.device
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"dfa_epoch_int8: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"dfa_epoch_int8: {name} on {t.device}, "
                             f"xq on {dev}")


def dfa_epoch_int8(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                   xq, yal, layer, fb, dither, scales):
    """One TIFeD epoch per slot; the contract of ``ref.dfa_int8_epoch``
    (native int8 / int32 operands with a leading slot axis, per-slot
    ``layer``, packed (10,) fp32 ``scales``). Returns (ws', bs', loss).
    ``dfa_epoch_int8.launches`` counts kernel launches."""
    _check(ws, bs, xq, yal, layer, fb, dither, scales)
    if xq.device.type == "cpu":
        return ref.dfa_int8_epoch(ws, bs, xq, yal, layer, fb, dither,
                                  scales)
    if xq.device.type != "cuda":
        raise ValueError(f"dfa_epoch_int8: unsupported device {xq.device}")
    ins = [xq, yal, *ws, *bs, *fb, *dither, scales, layer]
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("dfa_epoch_int8: every operand must be contiguous")
    B, S, din, h1, h2, dout = _dims(ws, xq, yal)
    launch, smem_bytes = _bind()
    smem = smem_bytes(S, din, h1, h2, dout)
    if smem > MAX_SMEM:
        raise ValueError(
            f"dfa_epoch_int8: S={S}, dims={(din, h1, h2, dout)} need "
            f"{smem} bytes of shared memory per slot; the limit is "
            f"{MAX_SMEM}")
    ow = tuple(torch.empty_like(w) for w in ws)
    ob = tuple(torch.empty_like(b) for b in bs)
    loss = torch.empty((B,), dtype=_F32, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = launch(*(t.data_ptr() for t in
                       (xq, yal, *ws, *bs, *fb, *dither, scales, layer,
                        *ow, *ob, loss)),
                     B, S, din, h1, h2, dout, stream)
    if err != 0:
        raise RuntimeError(f"dfa_epoch_int8 launch failed: cudaError {err}")
    dfa_epoch_int8.launches += 1
    return ow, ob, loss


dfa_epoch_int8.launches = 0
