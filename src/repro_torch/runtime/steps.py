"""Step builders: the paper's technique (a TinyReptile round) as the LM
train step, the port of the JAX package's ``runtime/steps.py`` on its
single-device route.

``make_meta_train_step`` is TinyReptile with one client per round, built
from the round engine's building blocks (``core/engine.py``):

- ``streaming_sgd``: K streaming SGD steps, one microbatch each (the
  paper's online learning), one ``online_sgd`` launch per dtype group
  per step;
- ``kernels/ops.py::tree_meta_update``: the Reptile server update phi
  <- phi + alpha (phi_hat - phi), one ``meta_update`` launch per dtype
  group.

``make_decode_step`` is the dense LM's decode step (``Model.decode_fn``),
which the serve launcher's decode mode drives.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

from repro_torch.core.engine import streaming_sgd
from repro_torch.core.pipeline import prefetch_items
from repro_torch.kernels.ops import tree_meta_update


def make_meta_train_step(model, *, beta: float = 0.01,
                         alpha: float = 0.5) -> Callable:
    """TinyReptile round. batch: {"tokens": (K, mb, S), "labels": ...}.

    ``step(phi, batch, alpha)`` returns (new_phi, metrics): the mean,
    first and last inner losses as fp32 tensors on the device. ``alpha``
    is a float or a one-element fp32 tensor on phi's device.
    """
    def step(phi, batch, alpha=alpha):
        phi_hat, losses = streaming_sgd(model.loss_fn, phi, batch, beta)
        new_phi = tree_meta_update(phi, phi_hat, alpha)
        return new_phi, {"loss": losses.mean(), "inner_first": losses[0],
                         "inner_last": losses[-1]}

    return step


def make_decode_step(model) -> Callable:
    """One decode step: ``step(params, batch)`` is ``model.decode_fn``
    (batch: tokens (B, 1), cache, cache_len), returning (logits, cache)."""
    def step(params, batch):
        return model.decode_fn(params, batch)
    return step


def microbatch(batch: Dict[str, Any], k: int) -> Dict[str, Any]:
    """Reshape (B, ...) arrays to (k, B//k, ...) inner-stream
    microbatches (NumPy arrays or tensors)."""
    def r(x):
        b = x.shape[0]
        return x.reshape(k, b // k, *x.shape[1:])
    return {name: r(x) for name, x in batch.items()}


def prefetch_batches(make_batch: Callable[[int], Any], num_batches: int,
                     depth: int = 2) -> Iterator[Any]:
    """Yield ``make_batch(i)`` for ``i in range(num_batches)``, built by
    a background thread strictly in index order, so a seeded host RNG
    drawn inside it gives exactly the synchronous sequence (``depth=0``
    calls it inline)."""
    return prefetch_items(make_batch, num_batches, depth=depth)
