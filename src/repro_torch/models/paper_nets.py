"""The paper's sine MLP (Table I: 1 -> 32 -> 32 -> 1, 1,153 params) as
functions over a ``{w0, b0, w1, b1, w2, b2}`` dict of tensors.

Every function takes parameters with or without a leading slot axis:
``w{i}`` is ``(din, dout)`` or ``(B, din, dout)``, ``b{i}`` is
``(dout,)`` or ``(B, dout)``, and ``x`` is ``(N, *input_shape)`` or
``(B, N, *input_shape)`` to match. A loss is a scalar per slot. The
convolutional paper nets come with the training slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.paper_models import PaperModelConfig
from repro_torch.device import DeviceLike, resolve_device


def _require_mlp(cfg: PaperModelConfig) -> None:
    if cfg.kind != "mlp":
        raise NotImplementedError(
            f"{cfg.name}: only the MLP paper model is ported so far")


def init_paper_model(cfg: PaperModelConfig, generator: torch.Generator,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """He-normal weights (std sqrt(2 / fan_in)) and zero biases, drawn on
    the CPU from ``generator`` and then moved, so one seed gives the same
    weights on every device. The same law as the JAX package's init,
    not the same numbers: ``jax.random`` streams differ from torch's."""
    _require_mlp(cfg)
    dev = resolve_device(device)
    dims = (int(np.prod(cfg.input_shape)),) + cfg.hidden + (cfg.num_outputs,)
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((din, dout), generator=generator,
                        dtype=torch.float32) * float(np.sqrt(2.0 / din))
        params[f"w{i}"] = w.to(dev)
        params[f"b{i}"] = torch.zeros((dout,), dtype=torch.float32,
                                      device=dev)
    return params


def _mlp(params, x, n_in: int, act):
    h = x.reshape(x.shape[:x.ndim - n_in] + (-1,))
    n = sum(1 for k in params if k.startswith("w"))
    for i in range(n):
        h = torch.matmul(h, params[f"w{i}"]) + params[f"b{i}"].unsqueeze(-2)
        if i < n - 1:
            h = act(h)
    return h


def _mse(pred, y):
    return torch.square(pred - y.reshape(pred.shape)).mean(dim=(-2, -1))


def paper_model_apply(cfg: PaperModelConfig, params, x):
    """``(..., N, *input_shape)`` -> ``(..., N, num_outputs)``, tanh
    hidden layers (the paper's sine net)."""
    _require_mlp(cfg)
    return _mlp(params, x, len(cfg.input_shape), torch.tanh)


def paper_model_loss(cfg: PaperModelConfig, params, batch):
    """Mean squared error per slot; ``batch`` = {"x", "y"}."""
    _require_mlp(cfg)
    return _mse(paper_model_apply(cfg, params, batch["x"]), batch["y"])


def relu_mlp_apply(params, x):
    """ReLU forward on the ``{w*, b*}`` MLP: the network TIFeD's integer
    arithmetic computes. ``(..., N, din)`` -> ``(..., N, dout)``."""
    return _mlp(params, x, 1, torch.relu)


def relu_mlp_loss(params, batch):
    """Mean squared error of the ReLU MLP, per slot."""
    return _mse(relu_mlp_apply(params, batch["x"]), batch["y"])


def param_count(params) -> int:
    """Parameters of one model (a slot axis, if any, is not counted:
    pass one slot's params)."""
    return sum(int(np.prod(p.shape)) for p in params.values())
