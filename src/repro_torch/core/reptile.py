"""Reptile baseline [Nichol et al. 2018], batched and serial — the
paper's main comparison (Figs. 2-4, Tables II-IV).

Unlike TinyReptile, the client trains on its ENTIRE support set in batch
for E epochs (data stored and reused). The loop is the shared round
engine; with clients_per_round > 1 the cohort's inner loops run as one
flat buffer, one launch per epoch for every client."""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.engine import CommChannel, run_federated
from repro_torch.core.pipeline import SamplingPolicy
from repro_torch.core.strategies import ReptileStrategy
from repro_torch.data.tasks import TaskDistribution
from repro_torch.device import DeviceLike


def reptile_train(loss_fn: Callable, init_params,
                  task_dist: TaskDistribution, *,
                  rounds: int = 1000, alpha: float = 1.0, beta: float = 0.01,
                  support: int = 32, epochs: int = 8,
                  clients_per_round: int = 1, anneal: bool = True,
                  seed: int = 0, eval_every: int = 0,
                  eval_kwargs: Optional[dict] = None,
                  channel: Optional[CommChannel] = None,
                  prefetch: int = 2, sampler: str = "reference",
                  max_block: int = 512,
                  sampling: Optional[SamplingPolicy] = None,
                  pool=None, buffered=None, mesh=None,
                  tracker=None, device: DeviceLike = None) -> Dict:
    """clients_per_round == 1 -> serial Reptile; > 1 -> batched Reptile
    (the server averages the per-client pseudo-gradients)."""
    return run_federated(
        init_params, task_dist, ReptileStrategy(loss_fn, epochs=epochs),
        rounds=rounds, clients_per_round=clients_per_round, alpha=alpha,
        beta=beta, support=support, anneal=anneal, seed=seed,
        eval_every=eval_every, eval_kwargs=eval_kwargs, channel=channel,
        prefetch=prefetch, sampler=sampler, max_block=max_block,
        sampling=sampling, pool=pool, buffered=buffered, mesh=mesh,
        tracker=tracker, device=device)
