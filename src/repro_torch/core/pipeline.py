"""Host side of the federated round engine: block planning, background
prefetch, and pluggable client-scheduling policies.

The port's counterpart of the JAX package's ``core/pipeline.py``, less
its mesh helpers and the persistent-pool seating (those come with the
pool and mesh slices):

- ``plan_blocks``: split a run into blocks at eval boundaries and
  ``max_block``, and pick ONE padded length for every block of the run.
  The eager engine skips the pad rounds; the fixed shape is what a
  block captured as a CUDA graph will need.
- ``BlockPrefetcher`` / ``prefetch_items``: a background thread samples
  and stages block N+1 while the device runs block N. The producer runs
  strictly in block order, so a seeded host RNG consumed inside
  ``produce`` sees exactly the synchronous draw order: pipelined and
  synchronous runs are bit-for-bit identical.
- ``ClientSchedule``: per padded round the validity bit, the annealed
  server rate and the absolute round index; per cohort slot the
  participation mask, the local step budget and the aggregation weight.
- ``SamplingPolicy``: which client tasks feed each round and what the
  round's schedule is. ``UniformSampling`` is the paper's schema;
  ``PartialParticipation`` and ``StragglerSampling`` are the
  deployment-scenario plugins.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

SAMPLERS = ("reference", "vectorized")


def plan_blocks(rounds: int, eval_every: int,
                max_block: int) -> Tuple[List[Tuple[int, int]], int]:
    """Split ``rounds`` into blocks; return ``(blocks, pad)``.

    ``blocks`` is a list of ``(start, end)`` half-open round ranges that
    cover ``[0, rounds)``, cut at every eval boundary (multiples of
    ``eval_every``) and at most ``max_block`` rounds long. ``pad`` is
    the one length every block is padded to on the host,
    ``min(max_block, stride, rounds)`` where ``stride`` is the eval
    cadence.
    """
    if max_block <= 0:
        raise ValueError(f"max_block must be positive, got {max_block!r}")
    if rounds <= 0:
        return [], 0
    stride = eval_every if eval_every else rounds
    blocks: List[Tuple[int, int]] = []
    rnd = 0
    while rnd < rounds:
        end = min(rounds, (rnd // stride + 1) * stride, rnd + max_block)
        blocks.append((rnd, end))
        rnd = end
    return blocks, min(max_block, stride, rounds)


class BlockPrefetcher:
    """Run ``produce(i)`` for ``i in range(n)`` on a daemon thread, keeping
    at most ``depth`` staged results ahead of the consumer.

    Items are produced strictly in order. Producer exceptions are
    re-raised from :meth:`get`, which raises ``StopIteration`` once all
    ``n`` items were consumed; :meth:`close` (idempotent) stops early
    without deadlocking the bounded queue.
    """

    _DONE = object()

    def __init__(self, produce: Callable[[int], object], n: int,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._run, args=(produce, n),
                                        name="block-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _run(self, produce, n) -> None:
        try:
            for i in range(n):
                if self._stop.is_set():
                    return
                self._put((None, produce(i)))
            self._put((None, self._DONE))
        except BaseException as exc:  # propagated to the consumer
            self._put((exc, None))

    def get(self):
        """Next staged item, blocking; re-raises producer exceptions and
        raises StopIteration once the stream is exhausted or closed."""
        if self._done:
            raise StopIteration("prefetcher exhausted")
        exc, item = self._q.get()
        if exc is not None:
            self._done = True
            self._stop.set()
            raise exc
        if item is self._DONE:
            self._done = True
            raise StopIteration("prefetcher exhausted")
        return item

    def close(self) -> None:
        """Stop the producer and drain the queue (safe to call twice)."""
        self._done = True
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)


def prefetch_items(produce: Callable[[int], object], n: int,
                   depth: int = 2) -> Iterator[object]:
    """Yield ``produce(i)`` for ``i in range(n)``, staged up to ``depth``
    ahead by a :class:`BlockPrefetcher` thread. ``depth=0`` (or a single
    item) calls ``produce`` inline — same order, same numbers. The
    producer is shut down when the generator is exhausted or closed."""
    if depth <= 0 or n <= 1:
        for i in range(n):
            yield produce(i)
        return
    pf = BlockPrefetcher(produce, n, depth=depth)
    try:
        for _ in range(n):
            yield pf.get()
    finally:
        pf.close()


@dataclasses.dataclass(frozen=True)
class ClientSchedule:
    """Per-round, per-client round state of one padded block.

    valid:          (R,)    bool — False on padded rounds.
    alpha:          (R,)    f32  — annealed server rate for the round.
    round_index:    (R,)    i32  — absolute round number.
    participation:  (R, C)  bool — which cohort slots train (and pay
                    transport) this round.
    local_steps:    (R, C)  i32  — per-client local step budget k_i, in
                    the strategy's own units (stream samples / epochs).
    weights:        (R, C)  f32  — aggregation weights, normalized per
                    round (0 for non-participants).

    Fields are NumPy arrays when planned and tensors on the run's device
    once staged.
    """
    valid: object
    alpha: object
    round_index: object
    participation: object
    local_steps: object
    weights: object


class SamplingPolicy:
    """Decides which client tasks feed each round of a block AND what the
    round's heterogeneity schedule is (who shows up, how many local steps
    each client runs, how the server weights their results).

    Both hooks must consume ``rng`` deterministically (the prefetch
    pipeline replays them strictly in block order): the engine calls
    ``plan_schedule`` first, then ``sample_block`` with the resulting
    participation mask.

    ``schedule_kind`` "uniform" keeps the engine's unweighted round
    body; anything else selects the schedule-aware body (weighted
    aggregation + per-client step masking).
    """

    schedule_kind = "scheduled"
    sampler = "reference"        # subclasses usually expose this as a field

    def plan_schedule(self, rng, start: int, end: int, clients: int,
                      budget: int) -> Dict[str, np.ndarray]:
        """Schedule rows for rounds [start, end): a dict of NumPy arrays
        ``participation`` (blk, clients) bool, ``local_steps`` (blk,
        clients) int32, and per-round-normalized ``weights`` (blk,
        clients) float32. ``budget`` is the strategy's full per-client
        workload (``FedStrategy.local_step_budget``). The default is the
        homogeneous fleet and consumes NO rng."""
        blk = end - start
        return {
            "participation": np.ones((blk, clients), bool),
            "local_steps": np.full((blk, clients), budget, np.int32),
            "weights": np.full((blk, clients), 1.0 / clients, np.float32),
        }

    def sample_block(self, task_dist, rng, rounds: int, clients: int,
                     support: int, data_mode: str,
                     participation: Optional[np.ndarray] = None) -> Dict:
        """Dispatch to the distribution's ``sampler`` flavour
        ("reference" replays the per-task RNG order; "vectorized" is the
        one-allocation block order), driven by the participation mask."""
        if self.sampler == "vectorized":
            return task_dist.sample_support_block(
                rng, rounds, clients, support, data_mode,
                participation=participation)
        return task_dist.sample_support_block_reference(
            rng, rounds, clients, support, data_mode,
            participation=participation)

    def _validate_sampler(self):
        if self.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {self.sampler!r}; "
                             f"expected one of {SAMPLERS}")


@dataclasses.dataclass(frozen=True)
class UniformSampling(SamplingPolicy):
    """Every round draws ``clients`` fresh tasks i.i.d. — the paper's
    serial (C=1) and batched schema, on the engine's unweighted body.
    ``sampler="reference"`` replays the JAX package's per-task RNG order
    bit-for-bit; "vectorized" uses the distribution's batched
    ``sample_support_block``."""
    sampler: str = "reference"

    schedule_kind = "uniform"

    def __post_init__(self):
        self._validate_sampler()


@dataclasses.dataclass(frozen=True)
class PartialParticipation(SamplingPolicy):
    """TinyMetaFed-style partial participation: each round only
    ``max(1, round(fraction * clients))`` cohort slots check in, train,
    and pay transport; the server averages over exactly the participants
    (weights 1/m on participants, 0 elsewhere). Scheduled-out slots draw
    no task data under the "reference" sampler (their batch stays
    zero)."""
    fraction: float = 0.5
    sampler: str = "reference"

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got "
                             f"{self.fraction!r}")
        self._validate_sampler()

    def cohort(self, clients: int) -> int:
        """Participants per round."""
        return max(1, int(round(self.fraction * clients)))

    def plan_schedule(self, rng, start, end, clients, budget):
        blk, m = end - start, self.cohort(clients)
        part = np.zeros((blk, clients), bool)
        for r in range(blk):                 # one small choice per round
            part[r, rng.choice(clients, size=m, replace=False)] = True
        return {
            "participation": part,
            "local_steps": np.where(part, budget, 0).astype(np.int32),
            "weights": (part.astype(np.float32) / m),
        }


@dataclasses.dataclass(frozen=True)
class StragglerSampling(SamplingPolicy):
    """Heterogeneous-device stragglers: every client shows up, but each
    draws an i.i.d. local step budget k_i uniformly from
    ``[ceil(min_steps_frac * budget), budget]``. Aggregation is
    arrival-weighted, w_i = k_i / sum_j k_j."""
    min_steps_frac: float = 0.25
    sampler: str = "reference"

    def __post_init__(self):
        if not 0.0 < self.min_steps_frac <= 1.0:
            raise ValueError(f"min_steps_frac must be in (0, 1], got "
                             f"{self.min_steps_frac!r}")
        self._validate_sampler()

    def plan_schedule(self, rng, start, end, clients, budget):
        blk = end - start
        lo = max(1, int(np.ceil(self.min_steps_frac * budget)))
        steps = rng.integers(lo, budget + 1,
                             size=(blk, clients)).astype(np.int32)
        weights = steps / steps.sum(axis=1, keepdims=True)
        return {
            "participation": np.ones((blk, clients), bool),
            "local_steps": steps,
            "weights": weights.astype(np.float32),
        }
