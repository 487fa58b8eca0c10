"""Transfer-learning / joint-training baseline (paper Fig. 1): train one
model on pooled data from all clients — Eq. (2). On the sine task it
converges to E_t[f_t(x)] ~ 0, which is why meta-learning is needed.

On the shared round engine it is the strategy whose clients forward raw
batches and whose server takes one SGD step on the pool (no federation,
so no comm accounting)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.engine import run_federated
from repro_torch.core.pipeline import SamplingPolicy
from repro_torch.core.strategies import TransferStrategy
from repro_torch.data.tasks import TaskDistribution
from repro_torch.device import DeviceLike


def transfer_train(loss_fn: Callable, init_params,
                   task_dist: TaskDistribution, *,
                   rounds: int = 1000, beta: float = 0.01,
                   batch_per_round: int = 32, tasks_per_round: int = 8,
                   seed: int = 0, eval_every: int = 0,
                   eval_kwargs: Optional[dict] = None,
                   prefetch: int = 2, sampler: str = "reference",
                   max_block: int = 512,
                   sampling: Optional[SamplingPolicy] = None,
                   pool=None, mesh=None, tracker=None,
                   device: DeviceLike = None) -> Dict:
    per_task = max(batch_per_round // tasks_per_round, 1)
    return run_federated(
        init_params, task_dist, TransferStrategy(loss_fn),
        rounds=rounds, clients_per_round=tasks_per_round, alpha=0.0,
        beta=beta, support=per_task, anneal=False, seed=seed,
        eval_every=eval_every, eval_kwargs=eval_kwargs, prefetch=prefetch,
        sampler=sampler, max_block=max_block, sampling=sampling, pool=pool,
        mesh=mesh, tracker=tracker, device=device)
