"""Reptile server interpolation ``w + alpha * (w_hat - w)`` as a CUDA
C++ kernel.

Replaces the TPU kernel ``repro/kernels/meta_update.py::meta_update_2d``
(``_meta_update_kernel``), which the JAX engine reaches once per
parameter leaf through ``meta_interpolate``. The port's engine keeps phi
in one flat buffer, so one launch of ``csrc/meta_update.cu`` updates the
whole model; the source gives the design and the bound. This module
checks the operands and launches it through ``ctypes``; a CPU tensor
gets the plain version ``ref.meta_update`` instead.

``alpha`` is read on the device from a one-element fp32 tensor, as the
TPU kernel reads it from SMEM, so the engine hands the kernel a slice of
the block's staged annealing schedule and no round pays a host->device
copy. A Python float is accepted too and copied to the device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def _bind():
    """The library's entry point, typed; built at first use."""
    fn = build.load("meta_update").meta_update_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _alpha_tensor(alpha, w):
    if isinstance(alpha, torch.Tensor):
        if (alpha.dtype != torch.float32 or alpha.numel() != 1
                or alpha.device != w.device):
            raise ValueError(
                f"meta_update: alpha must be one fp32 element on "
                f"{w.device}; got {alpha.dtype} {tuple(alpha.shape)} on "
                f"{alpha.device}")
        return alpha.reshape(1)
    return torch.tensor([float(alpha)], dtype=torch.float32, device=w.device)


def meta_update(w: torch.Tensor, w_hat: torch.Tensor,
                alpha) -> torch.Tensor:
    """``w + alpha * (w_hat - w)`` in fp32 math, stored in w's dtype, as
    a new tensor; ``w_hat`` is cast to w's dtype first, as the JAX
    wrapper does. A CPU tensor gets the plain version; a CUDA tensor gets
    the kernel (``meta_update.launches`` counts its launches) or an
    error."""
    if w.shape != w_hat.shape:
        raise ValueError(f"w {tuple(w.shape)} and w_hat "
                         f"{tuple(w_hat.shape)} differ in shape")
    if w.dtype not in _DTYPES:
        raise TypeError(f"meta_update: w must be one of {tuple(_DTYPES)}; "
                        f"got {w.dtype}")
    if w.device != w_hat.device:
        raise ValueError(f"w on {w.device}, w_hat on {w_hat.device}")
    w_hat = w_hat.to(w.dtype)
    a = _alpha_tensor(alpha, w)
    if w.device.type == "cpu":
        return ref.meta_update(w, w_hat, a)
    if w.device.type != "cuda":
        raise ValueError(f"meta_update: unsupported device {w.device}")
    if not (w.is_contiguous() and w_hat.is_contiguous()):
        raise ValueError("meta_update: w and w_hat must be contiguous")
    out = torch.empty_like(w)
    n = w.numel()
    if n:
        launch = _bind()
        with torch.cuda.device(w.device):
            stream = torch.cuda.current_stream(w.device).cuda_stream
            err = launch(w.data_ptr(), w_hat.data_ptr(), a.data_ptr(),
                         out.data_ptr(), n, _DTYPES[w.dtype], stream)
        if err != 0:
            raise RuntimeError(f"meta_update launch failed: cudaError {err}")
        meta_update.launches += 1
    return out


meta_update.launches = 0
