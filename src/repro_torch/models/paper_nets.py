"""The paper's three models (Table I) as functions over a dict of
tensors: the sine MLP (1 -> 32 -> 32 -> 1, 1,153 params, ``{w0, b0, w1,
b1, w2, b2}``) and the two conv classifiers, KWS (20,612 params) and
Omniglot (112,709), each a stack of 3x3 stride-2 ``SAME`` convolutions
with ReLU and a linear head (``{conv0, cb0, ..., head_w, head_b}``).

Every function takes parameters with or without a leading slot axis: an
MLP's ``w{i}`` is ``(din, dout)`` or ``(B, din, dout)``; a conv net's
``conv{i}`` is ``(3, 3, cin, cout)`` (HWIO) or ``(B, 3, 3, cin, cout)``,
``cb{i}`` ``(cout,)`` or ``(B, cout)``, and ``head_w`` ``(h*w*c, out)``
over an NHWC flatten, as in the JAX package, so its params carry across
unchanged. ``x`` is ``(N, *input_shape)`` or ``(B, N, *input_shape)`` to
match (NHWC for the conv nets). A loss or a metric is a scalar per slot.

The B slots of a conv net run as ONE grouped convolution a layer
(``groups=B``), so a cohort's forward and backward are one launch of
each, not B. JAX's ``padding="SAME"`` at stride 2 pads the extra row or
column on the high side, which ``F.pad`` does here. The convolutions run
in full fp32 with deterministic cuDNN algorithms whatever the caller's
cuDNN flags say (``_Conv``): the JAX package computes them in fp32, and a
replayed CUDA graph must equal the eager step bit for bit.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import PaperModelConfig
from repro_torch.device import DeviceLike, resolve_device


def init_paper_model(cfg: PaperModelConfig, generator: torch.Generator,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The JAX package's init law, drawn on the CPU from ``generator`` and
    then moved, so one seed gives the same weights on every device (not
    the JAX package's numbers: ``jax.random`` streams differ from
    torch's). MLP: ``w{i}`` He-normal, std sqrt(2 / din), drawn layer by
    layer. Conv: ``conv{i}`` std sqrt(2 / (9 cin)), drawn layer by layer,
    then ``head_w`` std sqrt(1 / (h w c)). Biases are zero."""
    dev = resolve_device(device)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * float(std)).to(dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    params = {}
    if cfg.kind == "mlp":
        dims = (int(np.prod(cfg.input_shape)),) + cfg.hidden + (
            cfg.num_outputs,)
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"w{i}"] = normal((din, dout), np.sqrt(2.0 / din))
            params[f"b{i}"] = zeros(dout)
        return params
    cin = cfg.input_shape[-1]
    for i, cout in enumerate(cfg.channels):
        params[f"conv{i}"] = normal((3, 3, cin, cout),
                                    np.sqrt(2.0 / (9 * cin)))
        params[f"cb{i}"] = zeros(cout)
        cin = cout
    h, w = conv_shapes(cfg)[-1][:2]
    flat = h * w * cin
    params["head_w"] = normal((flat, cfg.num_outputs), np.sqrt(1.0 / flat))
    params["head_b"] = zeros(cfg.num_outputs)
    return params


def conv_shapes(cfg: PaperModelConfig) -> List[Tuple[int, int, int]]:
    """``(h, w, c)`` after each conv layer: ``ceil(in / 2)`` a side."""
    h, w = cfg.input_shape[0], cfg.input_shape[1]
    out = []
    for cout in cfg.channels:
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w, cout))
    return out


def same_pads(size: int) -> Tuple[int, int]:
    """JAX's ``SAME`` padding of a 3-wide stride-2 window over ``size``:
    ``(low, high)``, the odd one out on the high side."""
    total = max(((size + 1) // 2 - 1) * 2 + 3 - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def _fp32_cudnn():
    """cuDNN in full fp32 (no TF32) with deterministic algorithms chosen
    by heuristics (no benchmarking), the caller's flags put back after."""
    c = torch.backends.cudnn
    saved = (c.enabled, c.benchmark, c.deterministic, c.allow_tf32)
    c.enabled, c.benchmark, c.deterministic, c.allow_tf32 = (True, False,
                                                             True, False)
    try:
        yield
    finally:
        c.enabled, c.benchmark, c.deterministic, c.allow_tf32 = saved


class _Conv(torch.autograd.Function):
    """A 3x3 stride-2 grouped convolution (input already padded) whose
    forward and backward both run under ``_fp32_cudnn``: the backward
    runs later, in autograd's thread, outside any scope the forward
    could open."""

    @staticmethod
    def forward(ctx, x, w, b, groups):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        with _fp32_cudnn():
            return F.conv2d(x, w, b, stride=2, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _fp32_cudnn():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]], [2, 2], [0, 0], [1, 1], False, [0, 0],
                ctx.groups, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


def _conv_net(cfg: PaperModelConfig, params, x):
    """``(..., N, H, W, cin)`` -> ``(..., N, num_outputs)``; the B slots
    (if any) as the groups of one convolution a layer, on NCHW
    ``(N, B * c, h, w)`` activations."""
    slotted = params["conv0"].dim() == 5
    if not slotted:
        params = {k: v.unsqueeze(0) for k, v in params.items()}
        x = x.unsqueeze(0)
    B, N, H, W, cin = x.shape
    h = x.permute(1, 0, 4, 2, 3).reshape(N, B * cin, H, W)
    for i, (hh, ww, cout) in enumerate(conv_shapes(cfg)):
        wt = params[f"conv{i}"].permute(0, 4, 3, 1, 2).reshape(
            B * cout, cin, 3, 3)
        h = F.pad(h, same_pads(h.shape[3]) + same_pads(h.shape[2]))
        h = torch.relu(_Conv.apply(h, wt, params[f"cb{i}"].reshape(-1), B))
        cin = cout
    # NHWC flatten per slot, the order head_w's rows follow
    flat = h.reshape(N, B, cin, hh, ww).permute(1, 0, 3, 4, 2).reshape(
        B, N, hh * ww * cin)
    out = torch.matmul(flat, params["head_w"]) + params["head_b"].unsqueeze(-2)
    return out if slotted else out[0]


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
    """``(..., N, *input_shape)`` -> ``(..., N, num_outputs)``: tanh
    hidden layers for the MLP (the paper's sine net), ReLU after each
    convolution for the conv nets."""
    if cfg.kind == "mlp":
        return _mlp(params, x, len(cfg.input_shape), torch.tanh)
    return _conv_net(cfg, params, x)


def paper_model_loss(cfg: PaperModelConfig, params, batch):
    """Per slot: the mean squared error (``loss="mse"``), or the mean
    negative log-probability of the true class (``"xent"``, ``y`` integer
    labels); ``batch`` = {"x", "y"}."""
    pred = paper_model_apply(cfg, params, batch["x"])
    if cfg.loss == "mse":
        return _mse(pred, batch["y"])
    labels = batch["y"].reshape(pred.shape[:-1]).long()
    logp = torch.log_softmax(pred, dim=-1)
    return -logp.gather(-1, labels.unsqueeze(-1)).squeeze(-1).mean(dim=-1)


def paper_model_accuracy(cfg: PaperModelConfig, params, batch):
    """Per slot: the share of samples whose largest output is the label."""
    pred = paper_model_apply(cfg, params, batch["x"])
    labels = batch["y"].reshape(pred.shape[:-1])
    return (pred.argmax(dim=-1) == labels).float().mean(dim=-1)


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
