"""Host side of the federated round engine: block planning, background
prefetch, and pluggable client-scheduling policies.

The port's counterpart of the JAX package's ``core/pipeline.py``:

- ``plan_blocks``: split a run into blocks at eval and checkpoint
  boundaries and ``max_block``, from round 0 or from a resumed round,
  and pick ONE padded length for every block of the run. The engine
  skips the pad rounds; the fixed shape keeps one built round a run.
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
  deployment-scenario plugins. Over a persistent ``ClientPool``
  (``core/pool.py``) a policy also seats each round's cohort
  (``plan_pool_schedule``, ``seat_cohorts``), drawing the host RNG in
  the JAX package's order, so cohorts are equal seat for seat.
- ``block_shardings``: a mesh run's rank takes its part of each padded
  block's cohort axis; ``single_device_of``: the one device a tree's
  tensors live on.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

SAMPLERS = ("reference", "vectorized")


def plan_blocks(rounds: int, eval_every: int, max_block: int, *,
                start: int = 0,
                ckpt_every: int = 0) -> Tuple[List[Tuple[int, int]], int]:
    """Split ``[start, rounds)`` into blocks; return ``(blocks, pad)``.

    ``blocks`` is a list of ``(start, end)`` half-open round ranges that
    cover ``[start, rounds)``, cut at every eval boundary (multiples of
    ``eval_every``), at every checkpoint boundary (multiples of
    ``ckpt_every``, when > 0: snapshots land on block ends) and at most
    ``max_block`` rounds long. ``pad`` is the one length every block is
    padded to on the host, ``min(max_block, stride, ckpt_every,
    rounds)`` where ``stride`` is the eval cadence; it does not depend
    on ``start``, so a resumed run has the same block shape (and the
    same built round) as the run it continues.

    ``start`` > 0 is the resume path: cuts are at absolute rounds, so a
    resume from a block boundary replays exactly the uninterrupted run's
    remaining blocks.
    """
    if max_block <= 0:
        raise ValueError(f"max_block must be positive, got {max_block!r}")
    if start < 0:
        raise ValueError(f"start must be >= 0, got {start!r}")
    if rounds <= start:
        return [], 0
    stride = eval_every if eval_every else rounds
    blocks: List[Tuple[int, int]] = []
    rnd = start
    while rnd < rounds:
        end = min(rounds, (rnd // stride + 1) * stride, rnd + max_block)
        if ckpt_every:
            end = min(end, (rnd // ckpt_every + 1) * ckpt_every)
        blocks.append((rnd, end))
        rnd = end
    pad = min(max_block, stride, rounds)
    if ckpt_every:
        pad = min(pad, ckpt_every)
    return blocks, pad


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


def block_shardings(mesh, axis: str, arrays):
    """This rank's part of one padded block on a client mesh: every array
    with a client axis (schedule rows and batch arrays, all shaped
    (padded rounds, clients, ...)) cut to this rank's contiguous share
    of dim 1, the per-round vectors (validity, alpha, round index) kept
    whole. The engine pads the cohort axis to a multiple of the shard
    count first, and stages the parts to the rank's own device."""
    shards = mesh.shape[axis]
    index = mesh.coordinate(axis)

    def part(a):
        if np.ndim(a) < 2:
            return a
        n = a.shape[1] // shards
        return a[:, index * n:(index + 1) * n]

    return [part(a) for a in arrays]


def single_device_of(tree):
    """The one device every tensor leaf of ``tree`` (a tensor, a tuple,
    list or dict of them, nested) lives on, or None (no tensor, or
    tensors on several devices)."""
    devices = set()

    def visit(x):
        if isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)
        elif hasattr(x, "device") and hasattr(x, "dtype"):
            devices.add(x.device)

    visit(tree)
    return devices.pop() if len(devices) == 1 else None


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


def seat_cohorts(rng, pool_size: int, clients: int,
                 rows: int) -> np.ndarray:
    """Uniform without-replacement cohort seating in O(rows * clients)
    host work, independent of ``pool_size`` (the ``sampler="vectorized"``
    stream contract of the JAX package's ``seat_cohorts``, draw for
    draw). Sparse rows (8 * clients < pool_size) reject repeats among
    ``rng.integers`` draws; near-dense rows keep ``rng.choice``'s
    permutation draw."""
    out = np.empty((rows, clients), np.int32)
    if clients * 8 >= pool_size:
        for r in range(rows):
            out[r] = rng.choice(pool_size, size=clients, replace=False)
        return out
    for r in range(rows):
        seen = set()
        seats = []
        while len(seats) < clients:
            draw = rng.integers(pool_size,
                                size=clients - len(seats)).tolist()
            for cand in draw:
                if cand not in seen:
                    seen.add(cand)
                    seats.append(cand)
        out[r] = seats
    return out


@dataclasses.dataclass(frozen=True)
class ClientSchedule:
    """Per-round, per-client round state of one padded block.

    valid:          (R,)    bool — False on padded rounds, and on pooled
                    rounds where nobody checked in (the round then
                    passes phi and the pool state through).
    alpha:          (R,)    f32  — annealed server rate for the round.
    round_index:    (R,)    i32  — absolute round number (rotating
                    partial-comm masks and the pool's last-seen and
                    FedBuff staleness tags read it on the device).
    participation:  (R, C)  bool — which cohort slots train (and pay
                    transport) this round.
    local_steps:    (R, C)  i32  — per-client local step budget k_i, in
                    the strategy's own units (stream samples / epochs).
    weights:        (R, C)  f32  — aggregation weights, normalized per
                    round (0 for non-participants).
    cohort:         (R, C)  i32 or None — which persistent pool client
                    sits in each slot (unique within a round); None on
                    runs without a pool.

    Fields are NumPy arrays when planned and tensors on the run's device
    once staged.
    """
    valid: object
    alpha: object
    round_index: object
    participation: object
    local_steps: object
    weights: object
    cohort: object = None

    def present(self) -> List[str]:
        """The names of the fields that are set, in field order."""
        return [f.name for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]


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

    def plan_pool_schedule(self, rng, start: int, end: int, clients: int,
                           budget: int,
                           pool_size: int) -> Dict[str, np.ndarray]:
        """Pooled-run schedule: ``plan_schedule``'s rows plus ``cohort``
        ((blk, clients) int32), which of the ``pool_size`` persistent
        clients sits in each slot (unique within a round). The default
        seats a uniform without-replacement draw each round, then
        delegates the heterogeneity rows to ``plan_schedule``. RNG
        order: the cohort draws first, then ``plan_schedule``'s.
        Availability processes (``core/pool.py``) override this."""
        blk = end - start
        if pool_size < clients:
            raise ValueError(f"pool_size={pool_size} is smaller than the "
                             f"cohort ({clients} slots): persistent "
                             f"clients cannot repeat within a round")
        if not blk:
            cohort = np.zeros((0, clients), np.int64)
        elif self.sampler == "vectorized":
            cohort = seat_cohorts(rng, pool_size, clients, blk)
        else:
            cohort = np.stack([
                rng.choice(pool_size, size=clients, replace=False)
                for _ in range(blk)])
        plan = self.plan_schedule(rng, start, end, clients, budget)
        plan["cohort"] = cohort.astype(np.int32)
        return plan

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

    def state_dict(self) -> Dict:
        """JSON-able host state carried from block to block, which
        round-state checkpoints capture so a resumed run continues the
        policy where the interrupted one stopped. Stateless policies
        (all but ``core.pool.MarkovAvailability``) return {}."""
        return {}

    def load_state_dict(self, state: Dict, rng=None) -> None:
        """Restore a ``state_dict`` snapshot at resume; ``rng`` is the
        run's restored host generator, for policies whose state is keyed
        by the stream driving it."""

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
