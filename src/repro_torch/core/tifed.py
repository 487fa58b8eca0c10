"""TIFeD integer-only federated training [arXiv 2307.03102]: the
compute half of int8 federation (the transport half is
``CommChannel("int8")``).

Clients train in integer arithmetic: int8 weights on per-tensor
power-of-two grids, int32 accumulators, direct-feedback-alignment
updates with bit-shift learning rates and stochastic-rounding
requantization (``core.strategies.TifedStrategy``; each epoch of the
whole cohort is one ``dfa_epoch_int8`` launch). The uplink is the native
int8 result tree, billed at 1 byte a parameter; the server dequantizes,
aggregates, and snaps phi back onto the integer grid. The loop is the
shared round engine, so TIFeD composes with pools, FedBuff,
availability processes and schedules like the fp32 strategies.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.engine import CommChannel, run_federated
from repro_torch.core.pipeline import SamplingPolicy
from repro_torch.core.pool import BufferedAggregation, ClientPool
from repro_torch.core.strategies import TifedStrategy
from repro_torch.data.tasks import TaskDistribution
from repro_torch.device import DeviceLike
from repro_torch.models.paper_nets import relu_mlp_loss


def tifed_train(init_params, task_dist: TaskDistribution, *,
                rounds: int = 1000, alpha: float = 1.0,
                support: int = 32, epochs: int = 8, lr_shift: int = 6,
                feedback_seed: int = 0, clients_per_round: int = 1,
                anneal: bool = True, seed: int = 0, eval_every: int = 0,
                eval_kwargs: Optional[dict] = None,
                channel: Optional[CommChannel] = None,
                prefetch: int = 2, sampler: str = "reference",
                max_block: int = 512,
                sampling: Optional[SamplingPolicy] = None,
                pool: Optional[ClientPool] = None,
                buffered: Optional[BufferedAggregation] = None,
                mesh=None, loss_fn: Optional[Callable] = None,
                use_pallas: Optional[bool] = None, tracker=None,
                device: DeviceLike = None) -> Dict:
    """Integer-only federated training on the paper's sine MLP shapes.

    No ``beta``: the client learning rate is the bit-shift ``lr_shift``
    (effective rate 2^-(lr_shift + log2(support))). ``channel`` defaults
    to the non-simulating int8 channel, which bills the int8 payload
    without quantizing it again; an fp32 or simulating channel is
    rejected by the engine. ``loss_fn`` (default ``relu_mlp_loss``) only
    serves the fp32 eval finetune; keep its eval lr <= 0.01.
    ``use_pallas`` is accepted and ignored (see ``TifedStrategy``)."""
    if channel is None:
        channel = CommChannel("int8", quantize=False)
    strategy = TifedStrategy(
        relu_mlp_loss if loss_fn is None else loss_fn, epochs=epochs,
        lr_shift=lr_shift, feedback_seed=feedback_seed,
        use_pallas=use_pallas)
    return run_federated(
        init_params, task_dist, strategy,
        rounds=rounds, clients_per_round=clients_per_round, alpha=alpha,
        beta=0.0, support=support, anneal=anneal, seed=seed,
        eval_every=eval_every, eval_kwargs=eval_kwargs, channel=channel,
        prefetch=prefetch, sampler=sampler, max_block=max_block,
        sampling=sampling, pool=pool, buffered=buffered, mesh=mesh,
        tracker=tracker, device=device)
