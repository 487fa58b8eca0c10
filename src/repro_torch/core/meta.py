"""Meta-learning substrate shared by every training strategy.

The paper's evaluation protocol (§III-A): to score an initialization
phi, fine-tune it for K steps on each testing client's support set S,
then measure the loss on the query set Q, averaged over clients — Eq.
(1): L(phi) = sum_n l_n(phi_n^k).

The inner loops work on a COHORT: C models as one flat ``(C, P)``
buffer laid out by a ``bridge.FlatLayout``, with ``loss_fn(params,
batch)`` returning one loss per model. The gradient of the summed
losses with respect to the buffer is every model's own gradient, so
each SGD step of the whole cohort is one backward pass and one
``online_sgd`` launch, where the JAX package vmaps one model's loop.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.bridge import FlatLayout
from repro_torch.data.tasks import TaskDistribution
from repro_torch.kernels import ops as kops


def tree_sub(a, b):
    return {k: a[k] - b[k] for k in a}


def tree_add_scaled(a, b, scale):
    return {k: a[k] + scale * b[k] for k in a}


def tree_lerp(phi, phi_hat, alpha):
    """Reptile interpolation: phi + alpha (phi_hat - phi)."""
    return {k: phi[k] + alpha * (phi_hat[k] - phi[k]) for k in phi}


def tree_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in params.values())


def cohort_grad(loss_fn: Callable, layout: FlatLayout, flat: torch.Tensor,
                batch: Dict):
    """Per-model losses ``(C,)`` and gradients ``(C, P)`` of a cohort
    buffer on its ``(C, ...)`` batch. Each leaf's view of the buffer is
    its own autograd leaf and the leaf gradients are concatenated once:
    differentiating through the slices instead would zero-fill, copy
    and add a full ``(C, P)`` buffer per leaf on every step."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in layout.views(flat).items()}
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss.sum(),
                                    [leaves[k] for k in layout.names])
    g = torch.cat([gr.reshape(flat.shape[:-1] + (-1,)) for gr in grads],
                  dim=-1)
    return loss.detach(), g


def _sgd(loss_fn, layout, flat, batches: Iterable[Dict], lr,
         k: Optional[torch.Tensor] = None):
    """One ``online_sgd`` step per batch of ``batches``. With ``k``
    ``(C,)`` (a per-model live-step budget), step i is dead for models
    with ``k <= i``: their gradient and loss are zeroed, so their
    params pass through exactly (``p - lr * 0 == p``). Returns the new
    buffer and the losses ``(C, steps)``."""
    losses = []
    for i, batch in enumerate(batches):
        loss, g = cohort_grad(loss_fn, layout, flat, batch)
        if k is not None:
            live = k > i
            g = torch.where(live[:, None], g, 0.0)
            loss = torch.where(live, loss, 0.0)
        flat = kops.online_sgd(flat, g, lr)
        losses.append(loss)
    return flat, torch.stack(losses, dim=1)


def finetune_batch(loss_fn, layout, flat, batch, steps: int, lr):
    """``steps`` steps of full-batch gradient descent of every model of
    the cohort on its own support set (Reptile's inner loop / the
    evaluation fine-tune). ``batch`` leaves are ``(C, S, ...)``."""
    return _sgd(loss_fn, layout, flat, (batch for _ in range(steps)), lr)


def finetune_online(loss_fn, layout, flat, xs, ys, lr):
    """One SGD step per sample, in arrival order (TinyReptile's inner
    loop). ``xs``, ``ys``: ``(C, S, ...)``; step i sees sample i of
    every model's stream."""
    return _sgd(loss_fn, layout, flat,
                ({"x": xs[:, i:i + 1], "y": ys[:, i:i + 1]}
                 for i in range(xs.shape[1])), lr)


def finetune_online_masked(loss_fn, layout, flat, xs, ys, lr, k):
    """``finetune_online`` where model c takes only its first ``k[c]``
    samples; later steps are no-ops (loss 0, params pass through).
    ``k == S`` everywhere reproduces ``finetune_online``."""
    return _sgd(loss_fn, layout, flat,
                ({"x": xs[:, i:i + 1], "y": ys[:, i:i + 1]}
                 for i in range(xs.shape[1])), lr, k)


def finetune_batch_masked(loss_fn, layout, flat, batch, steps: int, lr, k):
    """``finetune_batch`` where model c runs only its first ``k[c]``
    epochs; later epochs are no-ops (loss 0)."""
    return _sgd(loss_fn, layout, flat, (batch for _ in range(steps)), lr, k)


def evaluate_init(loss_fn: Callable, params, task_dist: TaskDistribution,
                  rng: np.random.Generator, *, num_tasks: int = 10,
                  support: int = 8, query: int = 64, k_steps: int = 8,
                  lr: float = 0.01) -> Dict[str, float]:
    """Paper protocol: per testing client, fine-tune ``k_steps`` on S
    then score on Q; average over clients. ``params`` is one model's
    ``{leaf: tensor}`` tree; the clients are drawn from ``rng`` in the
    JAX package's order (task, query, then support, client by client),
    then fine-tuned together as one cohort."""
    draws = []
    for _ in range(num_tasks):
        task = task_dist.sample_task(rng)
        qry = task.query_batch(rng, query)
        sup = task.support_batch(rng, support) if support > 0 else None
        draws.append((qry, sup))
    layout = FlatLayout.of(params)
    dev = params[layout.names[0]].device

    def stack(batches):
        return {k: torch.from_numpy(np.stack([b[k] for b in batches])).to(dev)
                for k in ("x", "y")}

    flat = layout.pack(params).expand(num_tasks, -1).contiguous()
    if support > 0:
        flat, _ = finetune_batch(loss_fn, layout, flat,
                                 stack([s for _, s in draws]), k_steps, lr)
    # support == 0: no adaptation (paper Fig. 6)
    losses = loss_fn(layout.views(flat), stack([q for q, _ in draws]))
    return {"query_loss": float(np.mean(losses.tolist()))}
