"""Minimal tree optimizers (SGD, AdamW) in the optax ``(init, update)``
style, the port of the JAX package's ``optim/optimizers.py``.

A params tree is the port's nested dicts and lists of tensors. Each
update is plain tensor ops a leaf, and rounds where the JAX package
rounds: plain SGD stores ``p - (lr g)`` with the product rounded to p's
dtype first; the moments are fp32 whatever p's dtype; AdamW takes its
step in fp32 and casts the result to p's dtype. ``sgd(momentum > 0)`` is
not the ``online_sgd_momentum`` kernel's function: the JAX package
rounds ``lr m`` to p's dtype before it subtracts, where the kernel
subtracts in fp32 and rounds once.

``lr`` is a number (a NumPy float32 from ``optim.schedules`` included)
or a one-element fp32 tensor on the params' device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.bridge import tree_leaves, unflatten_tree


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]  # (grads, state, params, lr)


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    leaves = [dict(tree_leaves(t)) for t in trees]
    return unflatten_tree({path: fn(*(t[path] for t in leaves))
                           for path in leaves[0]})


def _lr(lr):
    """A number as a Python float (an fp32 value stays exact); a tensor
    as it is."""
    return lr if isinstance(lr, torch.Tensor) else float(lr)


def _zeros32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def sgd(momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return _map(_zeros32, params)

    def update(grads, state, params, lr):
        lr = _lr(lr)
        if momentum == 0.0:
            new_params = _map(
                lambda p, g: p - (lr * g.float()).to(p.dtype), params, grads)
            return new_params, state
        new_state = _map(lambda m, g: momentum * m + g.float(), state, grads)
        new_params = _map(lambda p, m: p - (lr * m).to(p.dtype), params,
                          new_state)
        return new_params, new_state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        device = next(tree_leaves(params))[1].device
        return AdamState(mu=_map(_zeros32, params), nu=_map(_zeros32, params),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=device))

    def update(grads, state, params, lr):
        lr = _lr(lr)
        count = state.count + 1
        steps = count.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, device=steps.device), steps)
        c2 = 1.0 - torch.pow(torch.tensor(b2, device=steps.device), steps)
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu,
                  grads)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                  state.nu, grads)

        def upd(p, m, v):
            step = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step = step + lr * weight_decay * p.float()
            return (p.float() - step).to(p.dtype)

        new_params = _map(upd, params, mu, nu)
        return new_params, AdamState(mu, nu, count)

    return Optimizer(init, update)
