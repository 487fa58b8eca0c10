"""The chunked Mamba2 SSD forward scan as a CUDA C++ kernel.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
(``_ssd_kernel``), which the JAX package reaches once per Mamba2 layer
per forward through ``models/mamba2.py::ssd_chunked_pallas``. The port's
``models/mamba2.py`` calls this wrapper on the same route, so one
forward of mamba2-130m launches it 24 times. ``csrc/ssd_scan.cu`` gives
the design (one block per (batch, head), the chunk recurrence carried
in shared memory) and the bound (fp32 operations, about 100 us at the
slice's shape). This module checks the operands and launches it through
``ctypes``; a CPU tensor gets the plain version ``ref.ssd_scan``.

The kernel takes whole chunks only: padding a ragged sequence to whole
chunks stays in Python (``models/mamba2.py``), and anything else raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

SMEM_LIMIT = 232_448           # dynamic shared memory one H100 block may use
MAX_STATE = 8192               # P * N: the state sits in registers to update


@functools.lru_cache(maxsize=1)
def _bind():
    """The library's entry points, typed; built at first use."""
    lib = build.load("ssd_scan")
    launch = lib.ssd_scan_launch
    launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    launch.restype = ctypes.c_int
    smem = lib.ssd_scan_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    return launch, smem


def _check(xd, dA, Bm, Cm):
    if xd.dim() != 5:
        raise ValueError(f"ssd_scan: xd must be (B, H, nc, Q, P); got "
                         f"{tuple(xd.shape)}")
    B, H, nc, Q, P = xd.shape
    if dA.shape != (B, H, nc, Q):
        raise ValueError(f"ssd_scan: dA must be {(B, H, nc, Q)} (whole "
                         f"chunks); got {tuple(dA.shape)}")
    if Bm.dim() != 4 or Bm.shape[:3] != (B, nc, Q) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: Bm and Cm must be ({B}, {nc}, {Q}, N); "
                         f"got {tuple(Bm.shape)} and {tuple(Cm.shape)}")
    for name, t in (("xd", xd), ("dA", dA), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32; got "
                            f"{t.dtype}")
        if t.device != xd.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, xd on "
                             f"{xd.device}")


def ssd_scan(xd: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor) -> torch.Tensor:
    """xd (B, H, nc, Q, P), dA (B, H, nc, Q), Bm and Cm (B, nc, Q, N), all
    fp32 -> y (B, H, nc, Q, P) fp32, as ``ref.ssd_scan`` computes it. A
    CPU tensor gets the plain version; a CUDA tensor gets the kernel
    (``ssd_scan.launches`` counts its launches) or an error."""
    _check(xd, dA, Bm, Cm)
    if xd.device.type == "cpu":
        return ref.ssd_scan(xd, dA, Bm, Cm)
    if xd.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {xd.device}")
    if not all(t.is_contiguous() for t in (xd, dA, Bm, Cm)):
        raise ValueError("ssd_scan: xd, dA, Bm and Cm must be contiguous")
    B, H, nc, Q, P = xd.shape
    N = Bm.shape[-1]
    if P % 16 or P > 128 or P * N > MAX_STATE:
        raise ValueError(f"ssd_scan: the kernel takes P a multiple of 16 up "
                         f"to 128 and P * N <= {MAX_STATE}; got P={P}, N={N}")
    launch, smem = _bind()
    if smem(Q, P, N) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: Q={Q}, P={P}, N={N} needs "
                         f"{smem(Q, P, N)} bytes of shared memory, over "
                         f"{SMEM_LIMIT}")
    y = torch.empty_like(xd)
    if y.numel():
        with torch.cuda.device(xd.device):
            stream = torch.cuda.current_stream(xd.device).cuda_stream
            err = launch(xd.data_ptr(), dA.data_ptr(), Bm.data_ptr(),
                         Cm.data_ptr(), y.data_ptr(), B, H, nc, Q, P, N,
                         stream)
        if err != 0:
            raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
        ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
