"""The weighted client mean ``sum_c w[c] * where(w[c] > 0, q[c], 0)`` as
a CUDA C++ kernel.

No TPU kernel computes it: the JAX engine runs
``repro/core/strategies.py::weighted_client_mean`` under ``jax.jit``,
and XLA on the CPU fixes where it rounds (a chain of fused multiply-adds
up to 32 clients, windows of 32 above; ``ref.client_mean`` gives both).
``csrc/client_mean.cu`` sums in that order, so the port's weighted
server updates equal the jitted JAX engine's bit for bit. This module
checks the operands and launches it through ``ctypes``; a CPU tensor
gets the plain version ``ref.client_mean`` instead. The weights are read
on the device, so a captured round replays it with each round's weights.
bf16 results (a bf16 dtype group of the engine's cohort) are read as
they are, each value widened to fp32 in registers: the sums are the fp32
kernel's on ``results.float()``, without that copy of the cohort.
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
    fn = build.load("client_mean").client_mean_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def client_mean(results: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The weighted mean of ``results`` (C, ...) over its leading clients
    axis with ``weights`` (C,), in fp32, shaped ``results.shape[1:]``;
    ``results`` fp32 or bf16 (other dtypes are widened to fp32 first). A
    CPU tensor gets the plain version; a CUDA tensor gets the kernel
    (``client_mean.launches`` counts its launches) or an error."""
    if results.dim() < 1 or weights.shape != results.shape[:1]:
        raise ValueError(f"client_mean: weights {tuple(weights.shape)} do "
                         f"not match the clients axis of results "
                         f"{tuple(results.shape)}")
    if (weights.get_device() != results.get_device()
            or weights.is_cuda != results.is_cuda):
        raise ValueError(f"client_mean: results on {results.device}, "
                         f"weights on {weights.device}")
    if not results.is_cuda:
        if results.device.type != "cpu":
            raise ValueError(f"client_mean: unsupported device "
                             f"{results.device}")
        return ref.client_mean(results, weights)
    C = results.shape[0]
    if C < 1:
        raise ValueError("client_mean: no clients")
    q = results if results.dtype in _DTYPES else results.float()
    q = q.reshape(C, -1).contiguous()
    w = weights.float().contiguous()
    out = torch.empty(q.shape[1], dtype=torch.float32, device=q.device)
    if q.shape[1]:
        err = build.launch_on(q.get_device(), _bind(), q.data_ptr(),
                              w.data_ptr(), out.data_ptr(), q.shape[1], C,
                              _DTYPES[q.dtype])
        if err != 0:
            raise RuntimeError(f"client_mean launch failed: cudaError {err}")
        client_mean.launches += 1
    return out.reshape(results.shape[1:])


client_mean.launches = 0
