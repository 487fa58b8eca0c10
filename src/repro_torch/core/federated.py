"""Pod-client mode: each pod of the mesh is one federated client, after
the JAX package's ``core/federated.py``.

Two mappings of the paper's schema onto a mesh of ranks:

1. Cohort mode (``runtime/steps.py::make_meta_train_step(mesh=)``, the
   launcher's ``--mesh data``): the data axis acts as one composite
   client; each of the K inner SGD steps all-reduces its gradient over
   the ranks, then the Reptile interpolation closes the round.
2. Pod-client mode (here, ``--mesh pod``): each pod is one client. Its
   inner steps need no collective across pods; the pods' results meet
   once a round, in one all-reduce across the ``pod`` axis:
   TinyReptile's thrift with communication written as a collective
   schedule (K steps inside a pod, one exchange across pods).

The round is built from the engine's pieces: each pod runs
``engine.streaming_sgd`` on its own rows of the round's microbatches,
and the server fold is the strategies' collective aggregation
(``strategies.reptile_aggregate_weighted(..., group=)``), each pod a
client of weight 1/n_pods, as the client-sharded engine sums its
shards. Inside a pod every rank computes the pod's whole client batch
(the JAX package's fully manual form; the same numbers as its
partial-auto form).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.bridge import GroupedLayout
from repro_torch.core.engine import streaming_sgd
from repro_torch.core.strategies import reptile_aggregate_weighted
from repro_torch.runtime.sharding import all_reduce
from repro_torch.runtime.steps import data_rows


def make_pod_client_meta_step(model, mesh, *, beta: float = 0.01,
                              alpha: float = 0.5) -> Callable:
    """TinyReptile round with pods as clients on ``mesh`` (a
    ``ProcessMesh`` with a ``pod`` axis). ``step(phi, batch, alpha_t=None)``
    takes the round's whole batch on every rank, leaves (K, mb, ...), and
    returns (new_phi, metrics): each pod trains on its mb/n_pods rows,
    the pods' results are averaged with weight 1/n_pods each in one
    all-reduce a dtype group, phi moves toward the mean by ``alpha_t``
    (default ``alpha``; a float or a one-element fp32 tensor), and the
    mean, first and last inner losses are averaged over the pods."""
    if "pod" not in mesh.axis_names:
        raise ValueError("pod-client mode needs the multi-pod mesh")
    n_pods = mesh.shape["pod"]
    group = mesh.group("pod")

    def step(phi, batch, alpha_t=None):
        if alpha_t is None:
            alpha_t = alpha
        phi_hat, losses = streaming_sgd(model.loss_fn, phi,
                                        data_rows(batch, mesh, "pod"), beta)
        layout = GroupedLayout.of_tree(phi)
        flat = layout.pack(layout.named(phi))
        mine = tuple(q[None] for q in layout.pack(layout.named(phi_hat)))
        del phi_hat
        dev = flat[0].device
        weight = torch.full((1,), 1.0 / n_pods, dtype=torch.float32,
                            device=dev)
        if not isinstance(alpha_t, torch.Tensor):
            alpha_t = torch.tensor([alpha_t], dtype=torch.float32,
                                   device=dev)
        new = reptile_aggregate_weighted(flat, mine, alpha_t, weight, group)
        metrics = all_reduce(torch.stack(
            [losses.mean(), losses[0], losses[-1]]), group) / n_pods
        return layout.tree_views(new), {"loss": metrics[0],
                                        "inner_first": metrics[1],
                                        "inner_last": metrics[2]}

    return step
