"""Shared layer primitives of the LM family: the initializer, the RMS
norm and the MLP, as the JAX package's ``models/layers.py`` defines
them."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def silu(x):
    """x * sigmoid(x), the form ``jax.nn.silu`` computes."""
    return x * torch.sigmoid(x)


def mlp_shapes(d_model, d_ff, act, dtype):
    """``{leaf: (shape, dtype)}`` of the SwiGLU (``silu``) or plain
    two-layer (``gelu``) MLP, as ``init_mlp`` builds them."""
    if act == "silu":
        return {"w_gate": ((d_model, d_ff), dtype),
                "w_up": ((d_model, d_ff), dtype),
                "w_down": ((d_ff, d_model), dtype)}
    return {"w_in": ((d_model, d_ff), dtype), "b_in": ((d_ff,), dtype),
            "w_out": ((d_ff, d_model), dtype), "b_out": ((d_model,), dtype)}


def promoted(*xs):
    """The tensors cast to their promoted dtype, as jnp promotes mixed
    operands of a product (torch's matmul refuses them): the
    encoder-decoder family's fp32 frames meet bf16 weights."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def matmul(a, w):
    """``a @ w`` in the operands' promoted dtype."""
    return torch.matmul(*promoted(a, w))


def mlp_partial(params, x):
    """The SwiGLU MLP on a slice of ``d_ff`` (``w_gate``/``w_up`` columns,
    ``w_down`` rows of one rank): the gate in the operands' dtype, then
    its part of the down product in fp32 (exact products, an fp32 sum),
    to be summed over the slices before one rounding."""
    g = silu(matmul(x, params["w_gate"]))
    h = g * matmul(x, params["w_up"])
    return torch.matmul(h.float(), params["w_down"].float())


def mlp(params, x, act):
    """SwiGLU, or the gelu MLP with ``jax.nn.gelu``'s default: the tanh
    approximation (torch's default is the exact erf form). Mixed operand
    dtypes are promoted, as in jnp."""
    if act == "silu":
        g = silu(matmul(x, params["w_gate"]))
        return matmul(g * matmul(x, params["w_up"]), params["w_down"])
    h = F.gelu(matmul(x, params["w_in"]) + params["b_in"],
               approximate="tanh")
    return matmul(h, params["w_out"]) + params["b_out"]
