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

A bf16 ``w`` takes an fp32 ``w_hat`` as it is (the engine's fp32 client
mean of a bf16 dtype group): the kernel's mixed instantiation reads it
unrounded, which is the JAX package's plain interpolation
(``repro/core/engine.py::meta_interpolate``, the route its LM
launcher's FedBuff flush asks for), not its Pallas wrapper, which casts
``w_hat`` to w's dtype first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (w, w_hat) dtype pairs the kernel takes as they are, by launch code;
#: any other w_hat is cast to w's dtype first
_CODES = {(torch.float32, torch.float32): 0,
          (torch.bfloat16, torch.bfloat16): 1,
          (torch.bfloat16, torch.float32): 2}


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
                or alpha.get_device() != w.get_device()):
            raise ValueError(
                f"meta_update: alpha must be one fp32 element on "
                f"{w.device}; got {alpha.dtype} {tuple(alpha.shape)} on "
                f"{alpha.device}")
        return alpha
    return torch.tensor([float(alpha)], dtype=torch.float32, device=w.device)


def meta_update(w: torch.Tensor, w_hat: torch.Tensor,
                alpha) -> torch.Tensor:
    """``w + alpha * (w_hat - w)`` in fp32 math, stored in w's dtype, as
    a new tensor. An fp32 ``w_hat`` beside a bf16 ``w`` is read
    unrounded; any other ``w_hat`` is cast to w's dtype first, as the
    JAX wrapper does. A CPU tensor gets the plain version; a CUDA tensor
    gets the kernel (``meta_update.launches`` counts its launches) or an
    error."""
    if w.shape != w_hat.shape:
        raise ValueError(f"w {tuple(w.shape)} and w_hat "
                         f"{tuple(w_hat.shape)} differ in shape")
    if w.dtype not in _DTYPES:
        raise TypeError(f"meta_update: w must be one of {tuple(_DTYPES)}; "
                        f"got {w.dtype}")
    if w_hat.get_device() != w.get_device() or w_hat.is_cuda != w.is_cuda:
        raise ValueError(f"w on {w.device}, w_hat on {w_hat.device}")
    if (w.dtype, w_hat.dtype) not in _CODES:
        w_hat = w_hat.to(w.dtype)
    code = _CODES[w.dtype, w_hat.dtype]
    a = _alpha_tensor(alpha, w)
    if not w.is_cuda:
        if w.device.type != "cpu":
            raise ValueError(f"meta_update: unsupported device {w.device}")
        return ref.meta_update(w, w_hat, a.reshape(1))
    if not (w.is_contiguous() and w_hat.is_contiguous()):
        raise ValueError("meta_update: w and w_hat must be contiguous")
    out = torch.empty_like(w)
    n = w.numel()
    if n:
        err = build.launch_on(w.get_device(), _bind(), w.data_ptr(),
                              w_hat.data_ptr(), a.data_ptr(), out.data_ptr(),
                              n, code)
        if err != 0:
            raise RuntimeError(f"meta_update launch failed: cudaError {err}")
        meta_update.launches += 1
    return out


meta_update.launches = 0
