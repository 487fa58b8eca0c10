"""TinyReptile (the paper's Algorithm 1).

Per round:
  1. sample ONE client t from the training population (serial schema);
  2. send phi to the client                      (bytes accounted);
  3. the client runs one SGD step per STREAMING support sample;
  4. the client returns phi_hat                  (bytes accounted);
  5. server: phi <- phi + alpha (phi_hat - phi).

The server rate optionally anneals linearly. The loop is the shared
round engine (``core/engine.py``); this module binds the strategy.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.engine import CommChannel, run_federated
from repro_torch.core.pipeline import SamplingPolicy
from repro_torch.core.strategies import TinyReptileStrategy
from repro_torch.data.tasks import TaskDistribution
from repro_torch.device import DeviceLike


def tinyreptile_train(loss_fn: Callable, init_params,
                      task_dist: TaskDistribution, *,
                      rounds: int = 1000, alpha: float = 1.0,
                      beta: float = 0.01, support: int = 32,
                      anneal: bool = True, seed: int = 0,
                      eval_every: int = 0, eval_kwargs: Optional[dict] = None,
                      channel: Optional[CommChannel] = None,
                      prefetch: int = 2, sampler: str = "reference",
                      max_block: int = 512,
                      clients_per_round: int = 1,
                      sampling: Optional[SamplingPolicy] = None,
                      pool=None, buffered=None, mesh=None,
                      tracker=None, device: DeviceLike = None) -> Dict:
    """Returns {"params", "history", "comm_bytes", "per_client_bytes"};
    see ``run_federated``. ``clients_per_round`` > 1 grows the paper's
    serial schema into a cohort for the scheduled policies."""
    return run_federated(
        init_params, task_dist, TinyReptileStrategy(loss_fn),
        rounds=rounds, clients_per_round=clients_per_round, alpha=alpha,
        beta=beta, support=support, anneal=anneal, seed=seed,
        eval_every=eval_every, eval_kwargs=eval_kwargs, channel=channel,
        prefetch=prefetch, sampler=sampler, max_block=max_block,
        sampling=sampling, pool=pool, buffered=buffered, mesh=mesh,
        tracker=tracker, device=device)
