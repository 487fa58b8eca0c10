"""FedAVG and FedSGD [McMahan et al. 2016] — the traditional-FL
baselines the paper shows FAIL in the meta-learning regime (Fig. 2):
their objective is Eq. (2) (one model good for all clients now), not
Eq. (1) (a model that adapts). Both bind the shared round engine."""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.engine import CommChannel, run_federated
from repro_torch.core.pipeline import SamplingPolicy
from repro_torch.core.strategies import FedAvgStrategy, FedSGDStrategy
from repro_torch.data.tasks import TaskDistribution
from repro_torch.device import DeviceLike


def fedavg_train(loss_fn: Callable, init_params,
                 task_dist: TaskDistribution, *,
                 rounds: int = 1000, beta: float = 0.01, support: int = 32,
                 epochs: int = 8, clients_per_round: int = 8, seed: int = 0,
                 eval_every: int = 0,
                 eval_kwargs: Optional[dict] = None,
                 channel: Optional[CommChannel] = None,
                 prefetch: int = 2, sampler: str = "reference",
                 max_block: int = 512,
                 sampling: Optional[SamplingPolicy] = None,
                 pool=None, buffered=None, mesh=None,
                 tracker=None, device: DeviceLike = None) -> Dict:
    """FedAVG: clients run E local epochs; the server averages the MODELS
    (participation-weighted under a scheduled ``sampling`` policy)."""
    return run_federated(
        init_params, task_dist, FedAvgStrategy(loss_fn, epochs=epochs),
        rounds=rounds, clients_per_round=clients_per_round, alpha=1.0,
        beta=beta, support=support, anneal=False, seed=seed,
        eval_every=eval_every, eval_kwargs=eval_kwargs, channel=channel,
        prefetch=prefetch, sampler=sampler, max_block=max_block,
        sampling=sampling, pool=pool, buffered=buffered, mesh=mesh,
        tracker=tracker, device=device)


def fedsgd_train(loss_fn: Callable, init_params,
                 task_dist: TaskDistribution, *,
                 rounds: int = 1000, beta: float = 0.01, support: int = 32,
                 clients_per_round: int = 8, seed: int = 0,
                 eval_every: int = 0,
                 eval_kwargs: Optional[dict] = None,
                 channel: Optional[CommChannel] = None,
                 prefetch: int = 2, sampler: str = "reference",
                 max_block: int = 512,
                 sampling: Optional[SamplingPolicy] = None,
                 pool=None, buffered=None, mesh=None,
                 tracker=None, device: DeviceLike = None) -> Dict:
    """FedSGD: each client sends ONE gradient; the server applies the
    mean (participation-weighted under a scheduled ``sampling``
    policy)."""
    return run_federated(
        init_params, task_dist, FedSGDStrategy(loss_fn),
        rounds=rounds, clients_per_round=clients_per_round, alpha=1.0,
        beta=beta, support=support, anneal=False, seed=seed,
        eval_every=eval_every, eval_kwargs=eval_kwargs, channel=channel,
        prefetch=prefetch, sampler=sampler, max_block=max_block,
        sampling=sampling, pool=pool, buffered=buffered, mesh=mesh,
        tracker=tracker, device=device)
