"""Persistent client identities: the client pool, FedBuff and availability.

The port's counterpart of the JAX package's ``core/pool.py``:

- ``ClientPool``: N persistent clients. Client ``i``'s task is
  materialized once from ``(seed, i)`` (``TaskDistribution.
  materialize_client``), and each client draws its data from a private
  stream that advances only at its own check-ins, so what client ``i``
  sees depends only on how often it has checked in.
- ``PoolState``: the cross-round per-client state (last-seen round,
  staleness, check-in count) and the FedBuff buffer, as tensors on the
  run's device. The engine's round reads and writes it in place, by the
  round's cohort indices, inside the captured round.
- ``BufferedAggregation``: FedBuff-style async aggregation [Nguyen et
  al. 2022]: check-ins append their updates to a server buffer that
  flushes every ``buffer_size`` arrivals (or at a staleness deadline)
  through the strategy's ``server_aggregate_weighted`` with
  staleness-discounted weights.
- ``AvailabilityProcess``: check-in schedules over the pool,
  ``DiurnalAvailability`` and ``MarkovAvailability``. Rounds where
  nobody checks in are no-ops: the server idles, nobody trains, nobody
  pays transport.
- ``pool_state_specs``: which fields of a mesh run's ``PoolState`` are
  split over the client axis (``ClientPool.init_state(shards=)``'s
  layout) and which are replicated.

The host side is NumPy and draws its RNG streams exactly as the JAX
package does, so a pooled run seats the same cohorts with the same data.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.pipeline import SAMPLERS, SamplingPolicy
from repro_torch.data.tasks import TaskDistribution
from repro_torch.device import DeviceLike, resolve_device

#: stream-key constants, as in the JAX package: a pool's task seeds
#: (the ``materialize_client`` derivation), per-client data streams and
#: shape probes each draw from their own stream.
_DATA_STREAM = 0x5EED
_PROBE_STREAM = 0x9
_TASK_STREAM = 0x9E37

#: bound on the (support, data_mode) shape-template cache.
_MAX_TEMPLATES = 16

#: residency of the per-client identity arrays (see ClientPool).
RESIDENCIES = ("device", "host")


def default_staleness_weight(tau):
    """FedBuff's polynomial staleness discount s(tau) = 1/sqrt(1+tau), on
    a float tensor of "rounds since this update was computed": fresh
    updates weigh 1, a 3-round-stale update half that."""
    return 1.0 / torch.sqrt(1.0 + tau)


@dataclasses.dataclass(frozen=True)
class PoolState:
    """Cross-round per-client state, as tensors on the run's device.

    last_seen:   (N,) i32 — the absolute round of the client's latest
                 check-in; -1 for clients that never checked in.
    staleness:   (N,) i32 — the gap in rounds between the client's two
                 latest check-ins, stamped at check-in (first check-ins
                 count from round -1).
    checkins:    (N,) i32 — rounds the client took part in.
    buf_updates: the pending FedBuff updates: the strategy's uplink
                 template (a tensor, or a dict of tensors) with a leading
                 capacity axis of buffer_size + cohort - 1. None when
                 unbuffered.
    buf_round:   (capacity,) i32 — the round each buffered update was
                 computed at. None when unbuffered.
    buf_count:   () i32 — arrivals since the last flush. None when
                 unbuffered.
    flushes:     () i32 — flushes so far. None when unbuffered.

    Mesh runs (``run_federated(mesh=...)`` over more than one rank) use
    the layout of ``ClientPool.init_state(shards=...)``: per-client
    arrays padded to a multiple of the shard count, rank r holding the
    r-th contiguous part; the buffer as one slab a rank; ``buf_count`` a
    (shards,) array of each slab's fill level. ``pool_state_specs``
    names each field's split.
    """
    last_seen: object
    staleness: object
    checkins: object
    buf_updates: object = None
    buf_round: object = None
    buf_count: object = None
    flushes: object = None


def tree_map(fn, *trees):
    """``fn`` over the leaves of tensors or nested dicts of tensors, or
    tuples of them (the engine's dtype groups)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


@dataclasses.dataclass(frozen=True)
class BufferedAggregation:
    """FedBuff-style buffered async aggregation [Nguyen et al. 2022].

    Every check-in appends its update to a server-side buffer; once
    ``buffer_size`` updates have arrived the whole buffer flushes through
    the strategy's ``server_aggregate_weighted`` in one step, weighted by
    ``staleness_fn(tau)`` (tau: the flush round minus the round each
    update was computed at) and normalized. Between flushes phi does not
    move. A round that pushes the count to ``buffer_size`` or beyond
    flushes the whole buffer (up to buffer_size + cohort - 1 updates).

    ``flush_staleness`` (rounds, >= 1) also flushes whenever holding the
    buffer one more round would let its oldest update reach that
    staleness; a deadline of 1 flushes every round that has arrivals.

    On the engine's round the flush is computed every round and kept or
    dropped on the device, so a buffered run launches ``meta_update``
    every round, flushed or not.

    staleness_fn: tau (a float tensor) -> weight; default 1/sqrt(1+tau).
    Must be hashable (a module function or a frozen partial) for the
    runner cache.
    """
    buffer_size: int = 4
    staleness_fn: Callable = default_staleness_weight
    flush_staleness: Optional[int] = None

    def __post_init__(self):
        if not (isinstance(self.buffer_size, int) and self.buffer_size >= 1):
            raise ValueError(f"buffer_size must be an int >= 1, got "
                             f"{self.buffer_size!r}")
        if self.flush_staleness is not None and not (
                isinstance(self.flush_staleness, int)
                and self.flush_staleness >= 1):
            raise ValueError(f"flush_staleness must be None or an int >= 1, "
                             f"got {self.flush_staleness!r}")


class ClientPool:
    """A population of ``size`` persistent clients over a task
    distribution.

    Each client's stable task derives from ``(seed, i)`` through
    ``task_dist.materialize_client``, and each client's data stream
    advances only at its own check-ins. ``sample_cohort_block`` draws a
    block's data in strict block order.

    - ``sampler="reference"`` (default): one cached task and one live
      ``np.random.Generator`` per client that ever checked in (the JAX
      package's legacy streams, bit for bit).
    - ``sampler="vectorized"``: no per-client host objects; one ``(N,)``
      int32 check-in counter array, client ``i``'s k-th check-in drawing
      from ``default_rng([seed, _TASK_STREAM, i])`` and
      ``default_rng([seed, _DATA_STREAM, i, k])`` through
      ``TaskDistribution.sample_client_support``.

    ``residency="host"`` keeps the per-client identity arrays in host
    slabs: the engine stages only each block's cohort rows to the device
    and scatters them back after (``init_slabs``, ``gather_rows``,
    ``scatter_rows``).
    ``init_state`` builds the device-side ``PoolState``.
    """

    #: host-slab field names, mirroring PoolState's per-client arrays.
    SLAB_FIELDS = ("last_seen", "staleness", "checkins")

    def __init__(self, task_dist: TaskDistribution, size: int,
                 seed: int = 0, *, sampler: str = "reference",
                 residency: str = "device", max_cached_tasks: int = 4096):
        if size < 1:
            raise ValueError(f"pool size must be >= 1, got {size!r}")
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; expected "
                             f"one of {SAMPLERS}")
        if residency not in RESIDENCIES:
            raise ValueError(f"unknown residency {residency!r}; "
                             f"expected one of {RESIDENCIES}")
        if not (isinstance(max_cached_tasks, int)
                and max_cached_tasks >= 1):
            raise ValueError(f"max_cached_tasks must be an int >= 1, "
                             f"got {max_cached_tasks!r}")
        self.task_dist = task_dist
        self.size = int(size)
        self.seed = int(seed)
        self.sampler = sampler
        self.residency = residency
        self.max_cached_tasks = int(max_cached_tasks)
        self._tasks: "collections.OrderedDict[int, object]" = \
            collections.OrderedDict()
        self._rngs: Dict[int, np.random.Generator] = {}
        self._templates: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        #: vectorized-sampler identity: client i's next check-in index.
        self._checkins = (np.zeros(self.size, np.int32)
                          if sampler == "vectorized" else None)
        self._slabs: Optional[Dict[str, np.ndarray]] = None

    def __repr__(self):
        return (f"ClientPool({type(self.task_dist).__name__}, "
                f"size={self.size}, seed={self.seed}, "
                f"sampler={self.sampler!r}, residency={self.residency!r})")

    def client_task(self, i: int):
        """Pool client ``i``'s stable task, from a bounded LRU cache
        (tasks are pure functions of ``(seed, i)``)."""
        if not 0 <= i < self.size:
            raise IndexError(f"client {i} out of range for pool of "
                             f"{self.size}")
        t = self._tasks.get(i)
        if t is None:
            t = self.task_dist.materialize_client(i, seed=self.seed)
            self._tasks[i] = t
            while len(self._tasks) > self.max_cached_tasks:
                self._tasks.popitem(last=False)
        else:
            self._tasks.move_to_end(i)
        return t

    def _client_rng(self, i: int) -> np.random.Generator:
        if i not in self._rngs:
            self._rngs[i] = np.random.default_rng(
                [self.seed, _DATA_STREAM, i])
        return self._rngs[i]

    def host_state(self) -> Dict:
        """JSON-able snapshot of the pool's mutable host state, paired
        with ``load_host_state``: the reference sampler's per-client
        generator states (``{"rngs": ...}``), or the vectorized
        sampler's nonzero check-in counters (``{"checkins": ...}``)."""
        if self.sampler == "vectorized":
            nz = np.flatnonzero(self._checkins)
            return {"checkins": {str(int(i)): int(self._checkins[i])
                                 for i in nz}}
        return {"rngs": {str(i): copy.deepcopy(g.bit_generator.state)
                         for i, g in self._rngs.items()}}

    def load_host_state(self, state: Dict) -> None:
        """Restore a ``host_state`` snapshot. A snapshot of the other
        sampler's form raises rather than replaying different data."""
        state = state or {}
        if self.sampler == "vectorized":
            if state.get("rngs"):
                raise ValueError(
                    "the snapshot holds per-client rng states ('rngs'), "
                    "but this pool uses sampler='vectorized' (counter-"
                    "based streams); resume with ClientPool(..., "
                    "sampler='reference') or restart the run")
            self._checkins = np.zeros(self.size, np.int32)
            for key, k in (state.get("checkins") or {}).items():
                i = int(key)
                if not 0 <= i < self.size:
                    raise ValueError(f"snapshot counter for client {i} "
                                     f"out of range for pool of "
                                     f"{self.size}")
                self._checkins[i] = int(k)
            return
        if state.get("checkins"):
            raise ValueError(
                "the snapshot holds check-in counters ('checkins'), but "
                "this pool uses sampler='reference' (per-client rng "
                "streams); resume with ClientPool(..., sampler="
                "'vectorized') or restart the run")
        self._rngs = {}
        for key, st in state.get("rngs", {}).items():
            g = np.random.default_rng()
            g.bit_generator.state = st
            self._rngs[int(key)] = g

    def _template(self, support: int, data_mode: str):
        """Shape probe: one throwaway draw from client 0's task on its
        own rng stream, cached per (support, data_mode)."""
        key = (support, data_mode)
        if key not in self._templates:
            rng = np.random.default_rng([self.seed, _PROBE_STREAM])
            x, y = self._draw(self.client_task(0), rng, support, data_mode)
            self._templates[key] = (np.zeros_like(x), np.zeros_like(y))
            while len(self._templates) > _MAX_TEMPLATES:
                self._templates.popitem(last=False)
        else:
            self._templates.move_to_end(key)
        return self._templates[key]

    @staticmethod
    def _draw(task, rng, support: int, data_mode: str):
        if data_mode == "stream":
            sx, sy = zip(*task.support_stream(rng, support))
            return np.stack(sx), np.stack(sy)
        b = task.support_batch(rng, support)
        return np.asarray(b["x"]), np.asarray(b["y"])

    def sample_cohort_block(self, cohort, participation, support: int,
                            data_mode: str = "batch") -> Dict:
        """Support data for a planned block: every participating (round,
        slot) draws ``support`` samples from that pool client's task on
        its own stream; scheduled-out slots and no-show rounds stay zero.
        Called strictly in block order."""
        cohort = np.asarray(cohort)
        part = np.asarray(participation, bool)
        rounds, clients = part.shape
        zx, zy = self._template(support, data_mode)
        x = np.zeros((rounds, clients) + zx.shape, zx.dtype)
        y = np.zeros((rounds, clients) + zy.shape, zy.dtype)
        if self.sampler == "vectorized":
            counters = self._checkins
            rs, cs = np.nonzero(part)
            for r, c in zip(rs.tolist(), cs.tolist()):
                m = int(cohort[r, c])
                k = int(counters[m])
                x[r, c], y[r, c] = self.task_dist.sample_client_support(
                    np.random.default_rng([self.seed, _TASK_STREAM, m]),
                    np.random.default_rng([self.seed, _DATA_STREAM, m, k]),
                    support, data_mode)
                counters[m] = k + 1
        else:
            for r in range(rounds):
                for c in range(clients):
                    if part[r, c]:
                        m = int(cohort[r, c])
                        x[r, c], y[r, c] = self._draw(
                            self.client_task(m), self._client_rng(m),
                            support, data_mode)
        return {"x": x, "y": y}

    def init_slabs(self, shards: int = 1) -> Dict[str, np.ndarray]:
        """Fresh host-resident ``(n,)`` int32 identity slabs of a
        ``residency="host"`` pool (a run starts from them): n is the pool
        size rounded up to a multiple of ``shards`` (padded rows are never
        seated)."""
        if self.residency != "host":
            raise ValueError("init_slabs requires "
                             "ClientPool(residency='host')")
        shards = max(int(shards), 1)
        n = -(-self.size // shards) * shards
        fill = {"last_seen": -1, "staleness": 0, "checkins": 0}
        self._slabs = {name: np.full((n,), fill[name], np.int32)
                       for name in self.SLAB_FIELDS}
        return self._slabs

    def gather_rows(self, idx) -> Dict[str, np.ndarray]:
        """Rows ``idx`` of the host slabs, as fresh int32 arrays."""
        if self._slabs is None:
            raise ValueError("no host slabs: call init_slabs first")
        return {name: np.asarray(slab[idx])
                for name, slab in self._slabs.items()}

    def scatter_rows(self, idx, rows: Dict[str, np.ndarray]) -> None:
        """Write a block's updated identity rows back into the slabs."""
        if self._slabs is None:
            raise ValueError("no host slabs: call init_slabs first")
        for name, slab in self._slabs.items():
            slab[idx] = np.asarray(rows[name], np.int32)

    def init_state(self, phi, cohort_size: int,
                   buffered: Optional[BufferedAggregation] = None,
                   template=None, rows: Optional[int] = None,
                   device: DeviceLike = None, shards: int = 1) -> PoolState:
        """A fresh ``PoolState`` on ``device`` (default ``cuda``). The
        FedBuff buffer's capacity is ``buffer_size + cohort_size - 1``
        (a flush triggers at count >= buffer_size, and at most
        cohort_size arrivals land per round on a count of at most
        buffer_size - 1). ``template`` (default ``phi``) gives the
        shapes and dtypes of one buffer slot: the strategy's uplink (a
        tensor, a tuple of one a dtype group, or a dict of tensors), each
        slot in its own dtype. ``rows`` overrides the per-client
        axis (the ``residency="host"`` window of staged rows).

        ``shards`` > 1 builds a mesh run's layout (the whole of it; each
        rank takes its part): the per-client arrays padded to a multiple
        of ``shards``, one FedBuff slab of ``buffer_size + cohort_size //
        shards - 1`` a shard (any one shard can hold the count
        threshold's backlog plus its own round of arrivals, since the
        flush reads the count summed over the shards), and ``buf_count``
        a (shards,) array of the slabs' fill levels. ``shards == 1`` is
        the one-device layout."""
        if cohort_size % max(shards, 1):
            raise ValueError(f"cohort_size={cohort_size} must be a "
                             f"multiple of shards={shards} (the engine "
                             f"pads the cohort before building state)")
        dev = resolve_device(device)
        if rows is None:
            n = -(-self.size // shards) * shards
        else:
            if rows % max(shards, 1):
                raise ValueError(f"rows={rows} must be a multiple of "
                                 f"shards={shards}")
            n = int(rows)
        i32 = dict(dtype=torch.int32, device=dev)
        last_seen = torch.full((n,), -1, **i32)
        staleness = torch.zeros((n,), **i32)
        checkins = torch.zeros((n,), **i32)
        if buffered is None:
            return PoolState(last_seen, staleness, checkins)
        if shards == 1:
            cap = buffered.buffer_size + cohort_size - 1
            count = torch.zeros((), **i32)
        else:
            cap = shards * (buffered.buffer_size + cohort_size // shards - 1)
            count = torch.zeros((shards,), **i32)
        buf = tree_map(lambda p: torch.zeros((cap,) + tuple(p.shape),
                                             dtype=p.dtype, device=dev),
                       phi if template is None else template)
        return PoolState(last_seen, staleness, checkins, buf,
                         torch.zeros((cap,), **i32), count,
                         torch.zeros((), **i32))


def pool_state_specs(state: PoolState, axis: str) -> PoolState:
    """The split of each field of a mesh run's ``state`` as a spec tuple
    (the JAX package's ``PartitionSpec``): the per-client arrays, the
    FedBuff slabs and the slabs' (shards,) fill levels split over
    ``axis`` on their first dim, ``(axis,)``; the one-device layout's
    scalar fill level and the flush count replicated, ``()``."""
    sharded = (axis,)
    return PoolState(
        last_seen=sharded, staleness=sharded, checkins=sharded,
        buf_updates=(None if state.buf_updates is None else
                     tree_map(lambda _: sharded, state.buf_updates)),
        buf_round=None if state.buf_round is None else sharded,
        buf_count=(None if state.buf_count is None else
                   (sharded if np.ndim(state.buf_count) else ())),
        flushes=None if state.flushes is None else ())


@dataclasses.dataclass(frozen=True)
class AvailabilityProcess(SamplingPolicy):
    """A check-in process over a persistent pool: who is available each
    round is a stochastic process over the N pool clients, and the
    round's cohort is whoever showed up (capped at the cohort width by a
    uniform thinning draw).

    Subclasses implement ``availability``, a (blk, N) boolean matrix for
    rounds [start, end), drawing ``rng`` deterministically in block
    order. Rounds where nobody is available plan an all-False row; the
    engine marks them invalid and the server idles. ``plan_schedule``
    (the anonymous-cohort hook) raises.
    """
    sampler: str = "reference"

    schedule_kind = "scheduled"

    def availability(self, rng, start: int, end: int,
                     pool_size: int) -> np.ndarray:
        raise NotImplementedError

    def plan_schedule(self, rng, start, end, clients, budget):
        raise ValueError(
            f"{type(self).__name__} schedules PERSISTENT clients; pass "
            f"pool=ClientPool(...) to run_federated (anonymous cohort "
            f"slots have no identity to be available or not)")

    def plan_pool_schedule(self, rng, start, end, clients, budget,
                           pool_size):
        avail = np.asarray(
            self.availability(rng, start, end, pool_size), bool)
        blk = end - start
        assert avail.shape == (blk, pool_size)
        if self.sampler == "vectorized":
            cohort, part = self._seat_available_block(rng, avail, clients)
        else:
            cohort = np.zeros((blk, clients), np.int32)
            part = np.zeros((blk, clients), bool)
            for r in range(blk):
                idx = np.flatnonzero(avail[r])
                if len(idx) > clients:  # more volunteers than slots
                    idx = np.sort(
                        rng.choice(idx, size=clients, replace=False))
                m = len(idx)
                cohort[r, :m] = idx
                part[r, :m] = True
        m_per_round = part.sum(axis=1, keepdims=True)
        weights = np.where(
            m_per_round > 0, part / np.maximum(m_per_round, 1), 0.0)
        return {
            "participation": part,
            "local_steps": np.where(part, budget, 0).astype(np.int32),
            "weights": weights.astype(np.float32),
            "cohort": cohort,
        }

    @staticmethod
    def _seat_available_block(rng, avail, clients):
        """Loop-free seating for the whole block: every available client
        draws one uniform key, each round keeps the ``clients`` smallest
        keys, and a sort packs the winners ascending into the leading
        slots."""
        blk, pool_size = avail.shape
        k = min(clients, pool_size)
        keys = np.where(avail, rng.uniform(size=avail.shape), np.inf)
        cand = np.argpartition(keys, k - 1, axis=1)[:, :k]
        alive = np.isfinite(np.take_along_axis(keys, cand, axis=1))
        seats = np.sort(np.where(alive, cand, pool_size), axis=1)
        cohort = np.zeros((blk, clients), np.int32)
        part = np.zeros((blk, clients), bool)
        part[:, :k] = seats < pool_size
        cohort[:, :k] = np.where(part[:, :k], seats, 0)
        return cohort, part


@dataclasses.dataclass(frozen=True)
class DiurnalAvailability(AvailabilityProcess):
    """Fleet-wide diurnal check-ins: client ``i`` is available at round
    ``r`` with probability
    ``clip(base + amplitude * sin(2*pi*(r/period + phase_i)), 0, 1)``;
    ``phase_spread=0`` gives the whole fleet one sine (trough rounds may
    have nobody), ``phase_spread=1`` staggers phases evenly."""
    period: int = 24
    base: float = 0.5
    amplitude: float = 0.45
    phase_spread: float = 0.0

    def __post_init__(self):
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {self.period!r}")
        if not 0.0 <= self.base <= 1.0:
            raise ValueError(f"base must be in [0, 1] (a check-in "
                             f"probability), got {self.base!r}")
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0, 1], got "
                             f"{self.amplitude!r}")
        if not 0.0 <= self.phase_spread <= 1.0:
            raise ValueError(f"phase_spread must be in [0, 1] (fraction "
                             f"of the fleet's phase fan-out), got "
                             f"{self.phase_spread!r}")
        self._validate_sampler()

    def availability(self, rng, start, end, pool_size):
        r = np.arange(start, end, dtype=np.float64)[:, None]
        phase = (self.phase_spread
                 * np.arange(pool_size, dtype=np.float64)[None, :]
                 / max(pool_size, 1))
        p = np.clip(self.base + self.amplitude
                    * np.sin(2.0 * np.pi * (r / self.period + phase)),
                    0.0, 1.0)
        return rng.uniform(size=p.shape) < p


@dataclasses.dataclass(frozen=True)
class MarkovAvailability(AvailabilityProcess):
    """Two-state (on/off) Markov check-ins per client: an off client
    turns on with probability ``p_on`` each round, an on client turns
    off with ``p_off``; chains start from a stationary draw at round 0.
    The chain state survives across blocks in a one-slot stash keyed by
    the rng stream driving it, so blocks must come contiguous and in
    order from round 0 (as the engine's producer calls them)."""
    p_on: float = 0.3
    p_off: float = 0.15
    #: single-slot chain stash: (rng, pool_size, next_start, state)
    _chain: list = dataclasses.field(default_factory=list, repr=False,
                                     compare=False)

    def __post_init__(self):
        for name in ("p_on", "p_off"):
            v = getattr(self, name)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{name} must be in (0, 1], got {v!r}")
        self._validate_sampler()

    def availability(self, rng, start, end, pool_size):
        if start == 0:
            self._chain.clear()          # a fresh trajectory begins
            state = rng.uniform(size=pool_size) < (
                self.p_on / (self.p_on + self.p_off))
        elif (self._chain and self._chain[0] is rng
                and self._chain[1] == pool_size
                and self._chain[2] == start):
            state = self._chain[3]
        else:
            raise RuntimeError(
                f"MarkovAvailability needs contiguous in-order blocks "
                f"from one rng stream: got start={start} with no "
                f"matching chain state (blocks must begin at round 0 "
                f"and follow back-to-back)")
        rows = np.zeros((end - start, pool_size), bool)
        for r in range(end - start):
            u = rng.uniform(size=pool_size)
            state = np.where(state, u >= self.p_off, u < self.p_on)
            rows[r] = state
        self._chain[:] = [rng, pool_size, end, state.copy()]
        return rows

    def state_dict(self):
        """The in-flight chain (pool size, next block start, per-client
        on/off), or {} when no trajectory is in flight."""
        if not self._chain:
            return {}
        return {"pool_size": int(self._chain[1]),
                "next_start": int(self._chain[2]),
                "state": np.asarray(self._chain[3], bool).tolist()}

    def load_state_dict(self, state, rng=None):
        """Prime the chain stash from a ``state_dict`` snapshot; ``rng``
        must be the run's restored host generator."""
        if not state:
            self._chain.clear()
            return
        self._chain[:] = [rng, int(state["pool_size"]),
                          int(state["next_start"]),
                          np.asarray(state["state"], bool)]
