"""The federated round engine: one loop for every training algorithm.

  run_federated(init_params, task_dist, strategy, ...)

The port's counterpart of the JAX package's ``core/engine.py`` on its
plain route: one device, anonymous cohorts resampled every round, no
round-state checkpoints. (``pool=``, ``buffered=``, ``mesh=`` and
``ckpt_dir=`` are accepted and raise NotImplementedError until their
slices are ported.)

* A ``FedStrategy`` (``core/strategies.py``) supplies the two
  algorithm-specific hooks: ``client_update`` (what the round's cohort
  does with the broadcast phi and its local data) and
  ``server_aggregate`` (how the server folds the results back).
* phi lives in one flat ``(P,)`` buffer (``bridge.FlatLayout``, leaves
  in sorted-name order) and a round's cohort in one ``(C, P)`` buffer,
  so each inner SGD step of every client is one ``online_sgd`` launch
  and each Reptile interpolation one ``meta_update`` launch.
* Rounds run in blocks between evals, each padded on the host to one
  per-run length with a validity mask (``pipeline.plan_blocks``); this
  eager loop simply skips the pad rounds. The host plans each block's
  ``ClientSchedule`` and samples its data (``SamplingPolicy``) on a
  background thread (``prefetch``) in strict block order, so pipelined
  and synchronous runs are bit-for-bit identical. On the GPU the staged
  block is copied from pinned memory on a side stream; the round loop
  waits on its event, not on the host.
* No round reads anything back to the host. The per-round losses are
  fetched once per block, and only when an eval or a tracker needs
  them.
* ``CommChannel`` does the paper's Table-II byte accounting for
  fp32/fp16/int8 payloads and can simulate the quantized transport.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import FlatLayout
from repro_torch.core.meta import evaluate_init
from repro_torch.core.pipeline import (ClientSchedule, SamplingPolicy,
                                       UniformSampling, plan_blocks,
                                       prefetch_items)
from repro_torch.data.tasks import TaskDistribution
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops

#: bytes per parameter for each transport payload dtype (paper Table II
#: generalized: the paper ships fp32; fp16/int8 model compressed uplinks).
PAYLOAD_ITEMSIZE = {"float32": 4, "float16": 2, "int8": 1}


def meta_interpolate(phi, phi_hat, alpha):
    """Reptile server update phi <- phi + alpha (phi_hat - phi) on flat
    buffers, fp32 math, stored in phi's dtype: one ``meta_update``
    launch. ``alpha`` is a one-element fp32 tensor on phi's device (or a
    float)."""
    return kops.meta_update(phi, phi_hat.to(phi.dtype), alpha)


@dataclasses.dataclass(frozen=True)
class CommChannel:
    """Server<->client transport: byte accounting + optional quantization.

    dtype: payload dtype on the wire ("float32" | "float16" | "int8").
      Accounting scales the tree's bytes by the itemsize ratio — the
      paper's Table II generalized beyond fp32.
    quantize: simulate the lossy payload in-round (cast round-trip for
      fp16, per-leaf symmetric affine quantization for int8). Default:
      quantize iff dtype != float32; quantize=True on an fp32 wire is
      rejected (an exact wire has nothing to simulate).
    """
    dtype: str = "float32"
    quantize: Optional[bool] = None

    def __post_init__(self):
        if self.dtype not in PAYLOAD_ITEMSIZE:
            raise ValueError(f"unknown payload dtype {self.dtype!r}; "
                             f"expected one of {sorted(PAYLOAD_ITEMSIZE)}")
        if self.quantize and self.dtype == "float32":
            raise ValueError("quantize=True with an fp32 wire: the payload "
                             "is exact, there is no quantization to "
                             "simulate (drop quantize or pick fp16/int8)")

    @property
    def simulates_quantization(self) -> bool:
        if self.quantize is None:
            return self.dtype != "float32"
        return self.quantize

    def payload_bytes(self, tree) -> int:
        """One direction, one client: every leaf at the wire itemsize."""
        itemsize = PAYLOAD_ITEMSIZE[self.dtype]
        return sum(math.prod(x.shape) * itemsize for x in tree.values())

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """Simulated dtype round-trip (encode + decode) of one leaf. The
        int8 scale is the leaf's max |x| (over every client, when the
        leaf carries the cohort axis, as in the JAX package)."""
        if self.dtype == "float16":
            return x.to(torch.float16).to(x.dtype)
        if self.dtype == "int8":
            scale = torch.clamp(x.abs().max(), min=1e-8) / 127.0
            q = torch.round(x / scale).to(torch.int8)   # half to even
            return (q.to(x.dtype) * scale).to(x.dtype)
        return x

    def transmit(self, tree: Dict) -> Dict:
        """Simulated wire round-trip of a ``{leaf: tensor}`` tree."""
        if not self.simulates_quantization:
            return tree
        return {k: self._wire(v) for k, v in tree.items()}

    def transmit_flat(self, layout: FlatLayout, flat: torch.Tensor):
        """``transmit`` of a flat ``(..., P)`` buffer, leaf by leaf."""
        if not self.simulates_quantization:
            return flat
        return layout.pack(self.transmit(layout.views(flat)),
                           batch_dims=flat.dim() - 1)


def _stage(arrays, dev: torch.device):
    """NumPy arrays -> tensors on ``dev``. On the GPU the copies run from
    pinned memory on a side stream (this runs on the prefetch thread);
    the returned event marks their end, and the consumer's stream waits
    on it before touching them."""
    if dev.type == "cpu":
        return [torch.from_numpy(np.ascontiguousarray(a))
                for a in arrays], None
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            out = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                   .to(dev, non_blocking=True) for a in arrays]
            done = torch.cuda.Event()
            done.record(side)
    return out, done


def _consume(tensors, event):
    """Make the current stream wait for a staged block, and tell the
    caching allocator the tensors are used here (they were allocated on
    the side stream)."""
    if event is None:
        return
    stream = torch.cuda.current_stream(tensors[0].device)
    stream.wait_event(event)
    for t in tensors:
        t.record_stream(stream)


def _weighted_round_loss(losses, local_steps, weights):
    """A scheduled round's loss: the weighted mean of each client's
    per-live-step mean loss (zero-weight clients inert)."""
    k = torch.clamp(local_steps, min=1).float()
    per_client = losses.reshape(losses.shape[0], -1).sum(dim=1) / k
    return torch.sum(weights * torch.where(weights > 0, per_client, 0.0))


def run_federated(init_params, task_dist: TaskDistribution, strategy, *,
                  rounds: int, clients_per_round: int = 1,
                  alpha: float = 1.0, beta: float = 0.01, support: int = 32,
                  anneal: bool = True, seed: int = 0, eval_every: int = 0,
                  eval_kwargs: Optional[dict] = None,
                  channel: Optional[CommChannel] = None,
                  max_block: int = 512, prefetch: int = 2,
                  sampler: str = "reference",
                  sampling: Optional[SamplingPolicy] = None,
                  pool=None, buffered=None, mesh=None,
                  ckpt_dir: Optional[str] = None, tracker=None,
                  device: DeviceLike = None) -> Dict:
    """Run ``rounds`` federated rounds of ``strategy`` on ``device``
    (default ``cuda``; the CPU only when asked).

    ``init_params`` is one model's ``{leaf: array}`` tree (NumPy arrays,
    e.g. the JAX package's init, or tensors). Returns ``{"params",
    "history"}`` (+ ``"comm_bytes"`` and ``"per_client_bytes"`` for
    strategies that meter communication; ``per_client_bytes[c]`` is the
    transport paid by cohort slot c, billed only in rounds it
    participates in). ``params`` is a ``{leaf: tensor}`` dict on
    ``device``; history rows are per-eval dicts: ``evaluate_init``
    fields + round [+ comm_bytes, inner_loss].

    The host RNG is ``np.random.default_rng(seed)``; each block draws its
    schedule (``sampling.plan_schedule``) and then its data
    (``sampling.sample_block``), strictly in block order; evals use
    ``default_rng(10_000 + round - 1)``. Same seed and init, same
    trajectory as the JAX package's ``run_federated`` up to float
    rounding.

    ``tracker`` attaches a ``metering.MetricsTracker`` (per-round inner
    losses, transport bytes, eval rows, wall clock); it only observes.
    """
    for name, value in (("pool", pool), ("buffered", buffered),
                        ("mesh", mesh), ("ckpt_dir", ckpt_dir)):
        if value is not None:
            raise NotImplementedError(
                f"run_federated({name}=...) is not ported yet: the port "
                f"runs the plain single-device route")
    dev = resolve_device(device)
    if channel is None:
        channel = CommChannel()
    if sampling is None:
        sampling = UniformSampling(sampler)
    elif sampler != "reference":
        raise ValueError(
            f"pass the sampler on the sampling policy (e.g. "
            f"{type(sampling).__name__}(..., sampler={sampler!r})), not "
            f"as run_federated(sampler=...) alongside sampling=")
    layout = FlatLayout.of(init_params)
    # a private copy: the caller's init stays usable across runs
    phi = layout.pack({k: torch.as_tensor(
        v if isinstance(v, torch.Tensor) else np.array(v), device=dev)
        for k, v in init_params.items()})
    rng = np.random.default_rng(seed)
    history: List[Dict] = []
    comm_bytes = 0
    per_client_bytes = np.zeros(clients_per_round, np.int64)
    scheduled = getattr(sampling, "schedule_kind", "scheduled") != "uniform"
    budget = int(strategy.local_step_budget(support))
    simulate = channel.simulates_quantization
    beta = float(beta)
    blocks, pad = plan_blocks(rounds, eval_every, max_block)
    if strategy.meters_comm:
        payload = channel.payload_bytes(init_params)

    def stage(i):
        """Plan the schedule, sample, pad and stage block i. Called
        strictly in block order (inline, or from the one prefetch
        thread): plan_schedule draws first, then the data."""
        start, end = blocks[i]
        blk = end - start
        plan = sampling.plan_schedule(rng, start, end, clients_per_round,
                                      budget)
        part = np.asarray(plan["participation"], bool)
        batch = sampling.sample_block(task_dist, rng, blk, clients_per_round,
                                      support, strategy.data_mode,
                                      participation=part)
        r = np.arange(start, end)
        alphas = np.zeros(pad, np.float32)
        alphas[:blk] = alpha * (1 - r / rounds) if anneal else alpha
        valid = np.zeros(pad, bool)
        valid[:blk] = True
        round_index = np.zeros(pad, np.int32)
        round_index[:blk] = r

        def pad_rows(a, dtype):
            out = np.zeros((pad, clients_per_round), dtype)
            out[:blk] = a
            return out

        sched = ClientSchedule(
            valid=valid, alpha=alphas, round_index=round_index,
            participation=pad_rows(part, bool),
            local_steps=pad_rows(plan["local_steps"], np.int32),
            weights=pad_rows(plan["weights"], np.float32))
        names = sorted(batch)
        data = [np.asarray(batch[k]) for k in names]
        if blk < pad:
            data = [np.concatenate([v, np.zeros((pad - blk,) + v.shape[1:],
                                                v.dtype)]) for v in data]
        fields = [f.name for f in dataclasses.fields(ClientSchedule)]
        staged, event = _stage([getattr(sched, f) for f in fields] + data,
                               dev)
        sched_d = ClientSchedule(*staged[:len(fields)])
        batch_d = dict(zip(names, staged[len(fields):]))
        return part, sched_d, batch_d, (staged, event)

    staged_iter = prefetch_items(stage, len(blocks), depth=prefetch)
    if tracker is not None:
        tracker.on_run_start()
    try:
        for (start, end), (part, sched, batch, sync) in zip(blocks,
                                                            staged_iter):
            _consume(*sync)
            blk = end - start
            round_losses = []
            for j in range(blk):          # the pad rounds are skipped
                client_batch = {k: v[j] for k, v in batch.items()}
                phi_down = channel.transmit_flat(layout, phi)
                steps, weights = sched.local_steps[j], sched.weights[j]
                if scheduled:
                    results, losses = strategy.client_update_steps(
                        layout, phi_down, client_batch, beta, steps)
                else:
                    results, losses = strategy.client_update(
                        layout, phi_down, client_batch, beta)
                if simulate:
                    results = (channel.transmit(results)
                               if isinstance(results, dict)
                               else channel.transmit_flat(layout, results))
                alpha_t = sched.alpha[j:j + 1]     # stays on the device
                if scheduled:
                    phi = strategy.server_aggregate_weighted(
                        layout, phi, results, alpha_t, beta, weights)
                    loss = _weighted_round_loss(losses, steps, weights)
                else:
                    phi = strategy.server_aggregate(layout, phi, results,
                                                    alpha_t, beta)
                    loss = losses.float().mean()
                round_losses.append(loss)
            needs_eval = bool(eval_every) and end % eval_every == 0
            if tracker is not None or (needs_eval
                                       and strategy.tracks_inner_loss):
                # the one device->host read of the block's losses
                host_losses = torch.stack(round_losses).cpu().numpy()
            if tracker is not None:
                tracker.on_block(start, end, host_losses)
            if strategy.meters_comm:
                # bill downlink + uplink per participating client
                per_client_bytes += (2 * payload * part).sum(axis=0)
                block_bytes = int(2 * payload * part.sum())
                comm_bytes += block_bytes
                if tracker is not None:
                    tracker.on_transport(end, block_bytes, comm_bytes)
            if needs_eval:
                ev = evaluate_init(strategy.loss_fn, layout.views(phi),
                                   task_dist,
                                   np.random.default_rng(10_000 + end - 1),
                                   **(eval_kwargs or {}))
                ev["round"] = end
                if strategy.meters_comm:
                    ev["comm_bytes"] = comm_bytes
                if strategy.tracks_inner_loss:
                    ev["inner_loss"] = float(host_losses[blk - 1])
                history.append(ev)
                if tracker is not None:
                    tracker.on_eval(ev)
    finally:
        staged_iter.close()
        if tracker is not None:
            tracker.stop_profile()

    out = {"params": layout.views(phi), "history": history}
    if strategy.meters_comm:
        out["comm_bytes"] = comm_bytes
        out["per_client_bytes"] = per_client_bytes.tolist()
    if tracker is not None:
        tracker.on_run_end()
    return out
