"""TIFeD's integer grids, for serving a TIFeD-trained meta-init.

The rest of the JAX package's strategies come with the training slice.
Exponents are powers of two throughout, so every requantization
multiplier is an exact fp32 scaling: inputs on the 2^EX grid, hidden
activations on 2^ACT as unsigned 7-bit, the quantized error SERR grid
steps below the output accumulator. Weight exponents are per tensor
(``kernels.ref.pow2_exponent``); biases sit at accumulator scale.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import ref as kref

TIFED_EX = -4
TIFED_ACT = -3
TIFED_SERR = -5


@functools.lru_cache(maxsize=32)
def _tifed_constants(seed, epochs, dims):
    """Fixed DFA feedback matrices and per-epoch stochastic-rounding
    dither planes, drawn with NumPy exactly as the JAX package draws
    them: ``(fb1, fb2)`` int-valued fp32 ``(dout, H)``, and one
    ``(epochs, a, b)`` fp32 U[0, 1) plane per weight. Read-only arrays
    (the cache hands the same ones to every caller)."""
    din, h1, h2, dout = dims
    npr = np.random.default_rng(seed)
    fb = tuple(np.asarray(npr.integers(-127, 128, (dout, h)), np.float32)
               for h in (h1, h2))
    dith = tuple(np.asarray(npr.random((epochs, a, b)), np.float32)
                 for a, b in ((din, h1), (h1, h2), (h2, dout)))
    for arr in fb + dith:
        arr.setflags(write=False)
    return fb, dith


def tifed_dequantize(result):
    """``{"q": {leaf: codes}, "exp": {leaf: exponent}}`` -> fp32 params,
    ``q * 2^exp`` per leaf (the exponent broadcasts over trailing
    axes)."""
    out = {}
    for k, q in result["q"].items():
        e = torch.as_tensor(result["exp"][k], device=q.device).float()
        out[k] = q.float() * torch.exp2(
            e.reshape(e.shape + (1,) * (q.dim() - e.dim())))
    return out


def tifed_requantize(phi):
    """Snap fp32 phi onto the integer grids: weights to their per-tensor
    int8 grid, biases to the matching accumulator grid."""
    out = {}
    for i, ea in enumerate((TIFED_EX, TIFED_ACT, TIFED_ACT)):
        q, e = kref.quantize_pow2(phi[f"w{i}"])
        out[f"w{i}"] = torch.ldexp(q, e)
        eb = e + ea
        out[f"b{i}"] = torch.ldexp(torch.clamp(
            torch.round(torch.ldexp(phi[f"b{i}"], -eb)),
            -kref.BIAS_MAX, kref.BIAS_MAX), eb)
    return out
