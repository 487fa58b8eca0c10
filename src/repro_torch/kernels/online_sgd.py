"""Streaming SGD update ``p - lr * g`` as a Triton kernel.

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

    return sgd_kernel, triton.cdiv


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
        kernel, cdiv = _kernel()
        with torch.cuda.device(p.device):
            kernel[(cdiv(n, BLOCK),)](p, g, out, float(lr), n,
                                      BLOCK_SIZE=BLOCK, num_warps=4)
        online_sgd.launches += 1
    return out


online_sgd.launches = 0
