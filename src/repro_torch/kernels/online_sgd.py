"""Streaming SGD update ``p - lr * g``, and its momentum form, as
Triton kernels.

Replaces the TPU kernel ``repro/kernels/online_sgd.py::online_sgd_2d``
(``_sgd_kernel``), which the JAX server reaches once per parameter leaf
through ``kernels/ops.py::tree_online_sgd``. Here the adaptation
server keeps every slot's parameters in one flat ``(B, 1153)`` buffer,
so one launch updates all slots and all six leaves of the sine MLP.

What bounds it on an H100: it reads p and g and writes p' once, 3 * n *
itemsize bytes over 3.35 TB/s. At the serving shape (B = 64 slots x
1153 fp32) that is 0.89 MB, about 0.26 us: launch latency, not the
memory, sets the pace, which is why the update is one launch per step
rather than one per leaf. A flat 2^24-element buffer (201 MB in fp32)
is where the memory bound shows.

The math is fp32 whatever the storage (fp32 or bf16); lr is a runtime
fp32 scalar, so a new learning rate does not recompile. The compiler
may contract ``p - lr * g`` into one FMA, so the fp32 result can differ
from the plain version in the last bit.

``online_sgd_momentum`` replaces ``online_sgd_momentum_2d``
(``_sgd_momentum_kernel``): ``m' = mu * m + g`` in fp32, then ``p' = p -
lr * m'``, one pass that reads p, g and m and writes p' and m' (20 bytes
per element in fp32, 14 with bf16 p and g: 100.2 us and 70.1 us at 2^24
elements). Triton because it is the same streaming elementwise pass as
the kernel beside it, with the same dtype checks and launcher; code
generation loses nothing on a pass with no reuse.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref

BLOCK = 1024
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=1)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def sgd_kernel(p_ptr, g_ptr, out_ptr, lr, n,
                   BLOCK_SIZE: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK_SIZE + tl.arange(
            0, BLOCK_SIZE)
        mask = offs < n
        p = tl.load(p_ptr + offs, mask=mask).to(tl.float32)
        g = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
        out = p - lr * g
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty),
                 mask=mask)

    @triton.jit
    def sgd_momentum_kernel(p_ptr, g_ptr, m_ptr, out_p_ptr, out_m_ptr, lr,
                            mu, n, BLOCK_SIZE: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK_SIZE + tl.arange(
            0, BLOCK_SIZE)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
        m = tl.load(m_ptr + offs, mask=mask)
        m_new = mu * m + g
        tl.store(out_m_ptr + offs, m_new, mask=mask)
        p = tl.load(p_ptr + offs, mask=mask).to(tl.float32)
        tl.store(out_p_ptr + offs,
                 (p - lr * m_new).to(out_p_ptr.dtype.element_ty), mask=mask)

    return sgd_kernel, sgd_momentum_kernel, triton.cdiv


def _check(p, g):
    if p.shape != g.shape:
        raise ValueError(f"p {tuple(p.shape)} and g {tuple(g.shape)} "
                         f"differ in shape")
    if p.dtype != g.dtype or p.dtype not in _DTYPES:
        raise TypeError(f"p and g must share a dtype in {_DTYPES}; got "
                        f"{p.dtype} and {g.dtype}")
    if p.device != g.device:
        raise ValueError(f"p on {p.device}, g on {g.device}")


def online_sgd(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """``(p - lr * g)`` in fp32 math, stored in p's dtype, as a new
    tensor. A CPU tensor gets the plain version; a CUDA tensor gets the
    kernel (``online_sgd.launches`` counts its launches) or an error."""
    _check(p, g)
    if p.device.type == "cpu":
        return ref.online_sgd(p, g, float(lr))
    if p.device.type != "cuda":
        raise ValueError(f"online_sgd: unsupported device {p.device}")
    if not (p.is_contiguous() and g.is_contiguous()):
        raise ValueError("online_sgd: p and g must be contiguous")
    out = torch.empty_like(p)
    n = p.numel()
    if n:
        kernel, _, cdiv = _kernel()
        with torch.cuda.device(p.device):
            kernel[(cdiv(n, BLOCK),)](p, g, out, float(lr), n,
                                      BLOCK_SIZE=BLOCK, num_warps=4)
        online_sgd.launches += 1
    return out


online_sgd.launches = 0


def online_sgd_momentum(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                        lr: float, momentum: float):
    """``(p', m')`` with ``m' = momentum * m + g`` (fp32) and ``p' = p -
    lr * m'`` stored in p's dtype, as new tensors. ``m`` must be fp32. A
    CPU tensor gets the plain version; a CUDA tensor gets the kernel
    (``online_sgd_momentum.launches`` counts its launches) or an
    error."""
    _check(p, g)
    if m.shape != p.shape or m.dtype != torch.float32:
        raise ValueError(f"m must be fp32 of shape {tuple(p.shape)}; got "
                         f"{m.dtype} {tuple(m.shape)}")
    if m.device != p.device:
        raise ValueError(f"p on {p.device}, m on {m.device}")
    if p.device.type == "cpu":
        return ref.online_sgd(p, g, float(lr), m=m, momentum=float(momentum))
    if p.device.type != "cuda":
        raise ValueError(f"online_sgd_momentum: unsupported device "
                         f"{p.device}")
    if not (p.is_contiguous() and g.is_contiguous() and m.is_contiguous()):
        raise ValueError("online_sgd_momentum: p, g and m must be "
                         "contiguous")
    out_p, out_m = torch.empty_like(p), torch.empty_like(m)
    n = p.numel()
    if n:
        _, kernel, cdiv = _kernel()
        with torch.cuda.device(p.device):
            kernel[(cdiv(n, BLOCK),)](p, g, m, out_p, out_m, float(lr),
                                      float(momentum), n, BLOCK_SIZE=BLOCK,
                                      num_warps=4)
        online_sgd_momentum.launches += 1
    return out_p, out_m


online_sgd_momentum.launches = 0
