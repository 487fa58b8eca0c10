"""Shared layer primitives of the LM family: the initializer and the
RMS norm, as the JAX package's ``models/layers.py`` defines them."""
from __future__ import annotations

import math

import torch


def normal_init(gen: torch.Generator, shape, scale, dtype, device=None):
    """N(0, 1) * scale / sqrt(fan_in), drawn in fp32 and cast to
    ``dtype``; fan_in is the first axis of a matrix, the size of a
    vector. ``gen`` is a CPU ``torch.Generator`` (torch's numbers, not
    ``jax.random``'s)."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) >= 2 else max(math.prod(shape), 1)
    w = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (w * (scale / math.sqrt(fan_in))).to(device=device, dtype=dtype)


def rms_norm(x, weight, eps):
    """x / rms(x) * (1 + weight), in fp32, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)
