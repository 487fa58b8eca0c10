"""The federated round engine: one loop for every training algorithm.

  run_federated(init_params, task_dist, strategy, ...)

The port's counterpart of the JAX package's ``core/engine.py`` on one
device: anonymous cohorts resampled every round, or a persistent
``ClientPool`` (``core/pool.py``) with FedBuff buffering and
availability processes; every strategy, TIFeD's int8 one included; the
fp32/fp16/int8 wire and TinyMetaFed's partial one; round-state
checkpoints and resume (``ckpt_dir=``, ``resume=``). (``mesh=`` is
accepted and raises NotImplementedError until its slice is ported.)

* A ``FedStrategy`` (``core/strategies.py``) supplies the two
  algorithm-specific hooks: ``client_update`` (what the round's cohort
  does with the broadcast phi and its local data) and
  ``server_aggregate`` (how the server folds the results back).
* phi lives in one flat ``(P,)`` buffer (``bridge.FlatLayout``, leaves
  in sorted-name order) and a round's cohort in one ``(C, P)`` buffer,
  so each inner SGD step of every client is one ``online_sgd`` launch
  and each Reptile interpolation one ``meta_update`` launch.
* One round is one function, ``_BlockRunner._round``, built once per
  config and shape (``graphs.GraphStep``): captured as a CUDA graph on
  the card and replayed, run as it is on the CPU. It reads round j of
  the staged block through a device cursor and writes phi and the
  round's loss in place, so a block of rounds is that many replays and
  one host call each. Runners are cached by config as the JAX
  package's are (``runner_cache_stats``, ``clear_runner_cache``);
  ``_BlockRunner.trace_count`` counts the builds.
* Rounds run in blocks between evals, each padded on the host to one
  per-run length with a validity mask (``pipeline.plan_blocks``), so the
  runner's block buffers keep one shape; the pad rounds are never run.
  The host plans each block's ``ClientSchedule`` and samples its data
  (``SamplingPolicy``) on a background thread (``prefetch``) in strict
  block order, so pipelined and synchronous runs are bit-for-bit
  identical. On the GPU the staged block is copied from pinned memory on
  a side stream; the round loop waits on its event, not on the host,
  and copies the block into the runner's buffers.
* No round reads anything back to the host. The per-round losses are
  fetched once per block, and only when an eval or a tracker needs
  them.
* ``CommChannel`` does the paper's Table-II byte accounting for
  fp32/fp16/int8 payloads and can simulate the quantized transport;
  ``PartialCommChannel`` sends a fixed or rotating fraction of the
  entries, its masks built once a run and kept on the device.
* Pooled runs keep the ``PoolState`` in the runner's buffers and update
  it inside the round by the cohort's indices; a FedBuff flush and a
  round where nobody checked in are selected on the device, so they too
  are one captured round.
* ``ckpt_dir=`` snapshots the whole carry every ``ckpt_every`` rounds
  (``checkpoint.RoundState``, in the JAX package's file format, so a
  snapshot of either package resumes in the other): the host RNG, pool
  and policy state captured on the prefetch producer, and device clones
  of phi and the pool state made on the training stream right after the
  block, which a background writer copies to the host once an event
  recorded after them has passed. ``resume=True`` continues from the
  newest valid snapshot bit for bit.

The LM launcher's round (``runtime/steps.py``) is built from two more
pieces here: ``streaming_sgd``, K streaming SGD steps over a nested
params tree kept as one flat buffer per leaf dtype (one ``online_sgd``
launch per dtype group per step); the Reptile update over such a tree
is ``kernels/ops.py::tree_meta_update`` (one ``meta_update`` launch per
group).
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import (FlatLayout, flatten_tree, tree_leaves,
                                unflatten_tree)
from repro_torch.checkpoint.ckpt import (AsyncCheckpointWriter, RoundState,
                                         map_leaves, restore_round_state,
                                         save_round_state)
from repro_torch.core.meta import evaluate_init
from repro_torch.core.pipeline import (ClientSchedule, SamplingPolicy,
                                       UniformSampling, plan_blocks,
                                       prefetch_items)
from repro_torch.core.pool import (BufferedAggregation, ClientPool,
                                   PoolState, tree_map)
from repro_torch.core.threefry import leaf_permutations
from repro_torch.data.tasks import TaskDistribution
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import GraphStep
from repro_torch.kernels import ops as kops

logger = logging.getLogger(__name__)

#: bytes per parameter for each transport payload dtype (paper Table II
#: generalized: the paper ships fp32; fp16/int8 model compressed uplinks).
PAYLOAD_ITEMSIZE = {"float32": 4, "float16": 2, "int8": 1}


def meta_interpolate(phi, phi_hat, alpha):
    """Reptile server update phi <- phi + alpha (phi_hat - phi) on flat
    buffers, fp32 math, stored in phi's dtype: one ``meta_update``
    launch. ``alpha`` is a one-element fp32 tensor on phi's device (or a
    float)."""
    return kops.meta_update(phi, phi_hat.to(phi.dtype), alpha)


def streaming_sgd(loss_fn, phi, batch, beta):
    """The LM inner loop: one SGD step per microbatch of ``batch`` (the
    paper's online learning), fp32 update math, each leaf stored back in
    its own dtype. ``phi`` is a nested tree; ``batch`` a dict of
    ``(K, ...)`` tensors. Each leaf dtype's params live in one flat
    buffer, so a step is one backward and one ``online_sgd`` launch per
    dtype group over the concatenated gradients. Returns ``(phi_hat,
    losses)``: the tree as views of the final buffers, and the K losses
    as one fp32 tensor on phi's device (nothing is read to the host)."""
    layouts = list(FlatLayout.per_dtype(phi).values())
    leaves = flatten_tree(phi)
    flats = [lay.pack(leaves) for lay in layouts]
    steps = next(iter(batch.values())).shape[0]
    losses = []
    for i in range(steps):
        micro = {k: v[i] for k, v in batch.items()}
        params = {}
        for lay, flat in zip(layouts, flats):
            params.update({k: v.detach().requires_grad_()
                           for k, v in lay.views(flat).items()})
        names = list(params)
        loss = loss_fn(unflatten_tree(params), micro)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        flats = [kops.online_sgd(flat, lay.pack(grads), beta)
                 for lay, flat in zip(layouts, flats)]
        losses.append(loss.detach().float())
    out = {}
    for lay, flat in zip(layouts, flats):
        out.update(lay.views(flat))
    return unflatten_tree(out), torch.stack(losses)


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

    #: set on channels whose uplink needs the server's reference tree
    #: (``PartialCommChannel``: untransmitted entries fall back to it).
    needs_uplink_ref = False

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

    @property
    def _base_wire(self) -> bool:
        """Whether the dtype round-trip is simulated (the base decision,
        whatever a subclass adds)."""
        return CommChannel.simulates_quantization.fget(self)

    def payload_bytes(self, tree) -> int:
        """One direction, one client: every leaf at the wire itemsize."""
        itemsize = PAYLOAD_ITEMSIZE[self.dtype]
        return sum(math.prod(x.shape) * itemsize
                   for _, x in tree_leaves(tree))

    def payload_bytes_at(self, tree, round_index: int) -> int:
        """The exact payload of round ``round_index``: ``payload_bytes``
        for every channel but a rotating partial one."""
        del round_index
        return self.payload_bytes(tree)

    def round_bytes(self, tree, clients: int) -> int:
        """Downlink (phi out) + uplink (result back) for every client."""
        return 2 * clients * self.payload_bytes(tree)

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

    def _wire_flat(self, layout: FlatLayout, flat: torch.Tensor):
        return layout.pack({k: self._wire(v)
                            for k, v in layout.views(flat).items()},
                           batch_dims=flat.dim() - 1)

    def transmit(self, tree: Dict, ref=None, masks=None,
                 round_index=None) -> Dict:
        """Simulated wire round-trip of a ``{leaf: tensor}`` tree. ``ref``,
        ``masks`` and ``round_index`` serve partial channels; the base
        channel ignores them."""
        del ref, masks, round_index
        if not self.simulates_quantization:
            return tree
        return {k: self._wire(v) for k, v in tree.items()}

    def transmit_flat(self, layout: FlatLayout, flat: torch.Tensor,
                      ref=None, masks=None):
        """``transmit`` of a flat ``(..., P)`` buffer, leaf by leaf."""
        del ref, masks
        if not self.simulates_quantization:
            return flat
        return self._wire_flat(layout, flat)


@dataclasses.dataclass(frozen=True)
class PartialCommChannel(CommChannel):
    """TinyMetaFed-style partial communication: each round only a
    FRACTION of the parameter vector crosses the wire.

    Accounting: per leaf, ``kept_entries(n) = max(1, round(fraction*n))``
    entries at the wire itemsize, both directions. The kept set derives
    from ``mask_seed`` (both ends know it), so no index side channel is
    metered: leaf ``i``'s entries are ordered by
    ``jax.random.permutation(fold_in(PRNGKey(mask_seed), i), n)``, which
    ``core/threefry.py`` draws exactly as the JAX package does.

    Simulation: on the uplink, kept entries carry the client result
    (after any base dtype quantization) and dropped entries fall back to
    the server's reference (phi for model-returning strategies, zeros
    for gradients; ``FedStrategy.uplink_ref``). On the downlink, kept
    entries ride the dtype wire and dropped ones keep the exact server
    value. Both converge to the base channel as fraction -> 1.

    rotate=False: ONE fixed keep mask for the run. rotate=True: each
    leaf's entries split, in the permutation's order, into
    ``rotation_period = ceil(1/fraction)`` near-equal chunks, and round
    r transmits chunk ``r % rotation_period``, so every entry crosses
    the wire once a period (``payload_bytes_at`` is the per-round exact
    meter). The engine keeps the chunk ids on the device and compares
    them with the round index read there, so the captured round takes
    no mask from the host.
    """
    fraction: float = 0.5
    mask_seed: int = 0
    rotate: bool = False

    needs_uplink_ref = True

    def __post_init__(self):
        super().__post_init__()
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got "
                             f"{self.fraction!r}")

    def kept_entries(self, n: int) -> int:
        """Entries of an n-entry leaf transmitted per round: max(1,
        round(fraction * n)) for fixed masks; for rotating ones round
        0's (largest) chunk, ``kept_entries_at`` being per round."""
        if self.rotate:
            return self.kept_entries_at(n, 0)
        return max(1, int(round(self.fraction * n)))

    @property
    def rotation_period(self) -> int:
        """Rounds until a rotating mask has covered every entry:
        ceil(1/fraction), guarded against float noise."""
        return max(1, math.ceil(1.0 / self.fraction - 1e-9))

    def kept_entries_at(self, n: int, round_index: int) -> int:
        """The size of chunk (round_index % period) in the balanced split
        of n entries (the first n % period chunks get one more)."""
        period = self.rotation_period
        j = round_index % period
        return n // period + (1 if j < n % period else 0)

    def payload_bytes(self, tree) -> int:
        itemsize = PAYLOAD_ITEMSIZE[self.dtype]
        return sum(self.kept_entries(math.prod(x.shape)) * itemsize
                   for _, x in tree_leaves(tree))

    def payload_bytes_at(self, tree, round_index: int) -> int:
        if not self.rotate:
            return self.payload_bytes(tree)
        itemsize = PAYLOAD_ITEMSIZE[self.dtype]
        return sum(self.kept_entries_at(math.prod(x.shape), round_index)
                   * itemsize for _, x in tree_leaves(tree))

    @property
    def simulates_quantization(self) -> bool:
        if self.fraction < 1.0:
            return True
        return self._base_wire

    def _perms(self, shapes):
        return leaf_permutations(self.mask_seed,
                                 [math.prod(s) for s in shapes])

    def _chunk_ids_np(self, shapes):
        period = self.rotation_period
        out = []
        for shape, perm in zip(shapes, self._perms(shapes)):
            n = len(perm)
            sizes = np.full(period, n // period, np.int32)
            sizes[: n % period] += 1
            ids = np.zeros(n, np.int32)
            ids[perm] = np.repeat(np.arange(period, dtype=np.int32), sizes)
            out.append(ids.reshape(shape))
        return out

    def _fixed_masks_np(self, shapes):
        out = []
        for shape, perm in zip(shapes, self._perms(shapes)):
            m = np.zeros(len(perm), bool)
            m[perm[:self.kept_entries(len(perm))]] = True
            out.append(m.reshape(shape))
        return out

    @staticmethod
    def _leaf_shapes(tree):
        names = sorted(tree)
        return names, [tuple(tree[k].shape) for k in names]

    def chunk_id_tree(self, tree, device: DeviceLike = "cpu"):
        """Per leaf (sorted names, as the JAX package flattens a dict),
        an int32 tensor assigning each entry to one of
        ``rotation_period`` balanced chunks in the permutation's order."""
        names, shapes = self._leaf_shapes(tree)
        return {k: torch.from_numpy(v).to(device)
                for k, v in zip(names, self._chunk_ids_np(shapes))}

    def masks_for_round(self, chunk_ids, round_index):
        """Round ``round_index``'s keep masks from chunk ids (a tensor or
        a ``{leaf: tensor}`` tree); ``round_index`` may be a tensor on
        the device."""
        phase = round_index % self.rotation_period
        if isinstance(chunk_ids, dict):
            return {k: ids == phase for k, ids in chunk_ids.items()}
        return chunk_ids == phase

    def mask_tree(self, tree, round_index=None, device: DeviceLike = None):
        """Boolean keep masks, one per leaf, on ``device`` (default: the
        first leaf's). Fixed masks hold exactly ``kept_entries(n)`` True
        entries; rotating ones select round ``round_index``'s chunk
        (default round 0)."""
        if device is None:
            device = next(iter(tree.values())).device
        if self.rotate:
            return self.masks_for_round(
                self.chunk_id_tree(tree, device),
                0 if round_index is None else round_index)
        names, shapes = self._leaf_shapes(tree)
        return {k: torch.from_numpy(m).to(device)
                for k, m in zip(names, self._fixed_masks_np(shapes))}

    def flat_mask_state(self, layout: FlatLayout, device):
        """The run's mask state over a flat buffer, built once: ``(masks,
        None)`` with a ``(P,)`` bool keep mask for fixed masks, or
        ``(None, chunk_ids)`` with ``(P,)`` int32 chunk ids for rotating
        ones."""
        shapes = list(layout.shapes)
        if self.rotate:
            ids = np.concatenate([a.ravel() for a in
                                  self._chunk_ids_np(shapes)])
            return None, torch.from_numpy(ids).to(device)
        m = np.concatenate([a.ravel() for a in self._fixed_masks_np(shapes)])
        return torch.from_numpy(m).to(device), None

    def transmit(self, tree, ref=None, masks=None, round_index=None):
        base_wire = self._base_wire
        if self.fraction >= 1.0:                 # degenerate: base channel
            return ({k: self._wire(v) for k, v in tree.items()}
                    if base_wire else tree)
        if ref is None and not base_wire:        # exact wire, nothing sent
            return tree                          # differs from the fallback
        if masks is None:
            masks = self.mask_tree(tree if ref is None else ref,
                                   round_index)
        sent = ({k: self._wire(v) for k, v in tree.items()}
                if base_wire else tree)
        back = tree if ref is None else ref
        return {k: torch.where(masks[k], sent[k], back[k]) for k in tree}

    def transmit_flat(self, layout, flat, ref=None, masks=None):
        """``transmit`` of a flat ``(..., P)`` buffer; ``masks`` is the
        round's ``(P,)`` keep mask (default: round 0's, built here)."""
        base_wire = self._base_wire
        if self.fraction >= 1.0:
            return self._wire_flat(layout, flat) if base_wire else flat
        if ref is None and not base_wire:
            return flat
        if masks is None:
            fixed, ids = self.flat_mask_state(layout, flat.device)
            masks = fixed if ids is None else ids == 0
        sent = self._wire_flat(layout, flat) if base_wire else flat
        return torch.where(masks, sent, flat if ref is None else ref)


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


_NEVER = 2 ** 30          # "no buffered update" round tag


def _pool_leaves(ps: PoolState):
    return [t for f in dataclasses.fields(ps)
            for t in _tree_tensors(getattr(ps, f.name))]


def _tree_tensors(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_tensors(tree[k])]
    return [tree]


class _Program:
    """A runner's fixed-address state for one shape of run: phi, the
    staged block (schedule fields, then the batch), the block's per-round
    losses, the round cursor, the partial channel's mask state and, on
    pooled runs, the pool state; the round is a ``GraphStep``.

    The pool state is the run's ``PoolState`` with one more row on every
    per-client array and on the FedBuff buffer: a sink. Scheduled-out
    slots write their rows there (torch has no scatter that drops
    out-of-range indices), and nothing reads it."""

    def __init__(self, runner, layout: FlatLayout, phi: torch.Tensor,
                 staged, names, fields, pool_state: Optional[PoolState]):
        dev = phi.device
        self.layout = layout
        self.phi = torch.empty_like(phi)
        self.block = [torch.empty_like(t) for t in staged]
        nf = len(fields)
        self.sched = ClientSchedule(**dict(zip(fields, self.block[:nf])))
        self.batch = dict(zip(names, self.block[nf:]))
        self.losses = torch.zeros(len(staged[0]), dtype=torch.float32,
                                  device=dev)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        self.masks, self.chunk_ids = runner.mask_state(layout, dev)
        self.pool = None
        if pool_state is not None:
            def sunk(t):
                return torch.zeros((t.shape[0] + 1,) + tuple(t.shape[1:]),
                                   dtype=t.dtype, device=dev)
            ps = pool_state
            buffered = ps.buf_updates is not None
            self.pool = PoolState(
                sunk(ps.last_seen), sunk(ps.staleness), sunk(ps.checkins),
                tree_map(sunk, ps.buf_updates) if buffered else None,
                sunk(ps.buf_round) if buffered else None,
                torch.zeros(1, dtype=torch.int32, device=dev)
                if buffered else None,
                torch.zeros(1, dtype=torch.int32, device=dev)
                if buffered else None)
        self.step = GraphStep(lambda: runner._round(self), dev)

    def load_pool(self, ps: PoolState) -> None:
        """Copy a run's ``PoolState`` in (the sink rows are cleared)."""
        mine = self.pool
        for f in ClientPool.SLAB_FIELDS:
            dst = getattr(mine, f)
            dst[:-1].copy_(getattr(ps, f))
            dst[-1:].zero_()
        if ps.buf_updates is not None:
            tree_map(lambda d, s: d[:-1].copy_(s), mine.buf_updates,
                     ps.buf_updates)
            mine.buf_round[:-1].copy_(ps.buf_round)
            mine.buf_count.copy_(ps.buf_count.reshape(1))
            mine.flushes.copy_(ps.flushes.reshape(1))

    def pool_state(self) -> PoolState:
        """The pool state without the sink rows (views)."""
        mine = self.pool
        buffered = mine.buf_updates is not None
        return PoolState(
            mine.last_seen[:-1], mine.staleness[:-1], mine.checkins[:-1],
            tree_map(lambda t: t[:-1], mine.buf_updates)
            if buffered else None,
            mine.buf_round[:-1] if buffered else None,
            mine.buf_count[0] if buffered else None,
            mine.flushes[0] if buffered else None)


class _BlockRunner:
    """One round of ``strategy`` built once and replayed: the port's
    counterpart of the JAX package's compiled block executor.

    ``_round`` reads round j of the block buffers through the device
    cursor (``index_select``, never a host index), sends phi down the
    channel, runs the client hook on the cohort (``client_update_steps``
    with the round's step budgets when ``masked``), sends the results up
    (partial channels fall back to the server's reference where they
    send nothing), aggregates (``server_aggregate_weighted`` with the
    round's weights when ``scheduled``, and the weighted round loss),
    writes phi back in place and the round's loss at the cursor, and
    advances the cursor. ``beta`` rides the ``online_sgd`` launches by
    value, so it is part of the cache key; alpha is read on the device.

    ``pooled`` runs keep the pool's ``PoolState`` in the program and
    update it inside the round, by the round's cohort indices: last
    seen, staleness and check-ins of the clients who took part (the
    others write the sink row). With ``buffered`` the results go into
    the FedBuff buffer instead, and the flush (its staleness weights and
    its aggregation, ``meta_update`` included) is computed every round
    and kept only where the flush predicate holds, a ``torch.where`` on
    the device, so the captured round has no host branch. A pooled round
    where nobody checked in (``valid`` False) passes phi and the pool
    state through, also by ``torch.where``.

    A block is ``blk`` calls of the round's ``GraphStep``: CUDA-graph
    replays on the card, the same function run eagerly on the CPU. The
    pad rounds are never called. One program (buffers and graph) is
    kept per shape of run (layout, padded block, pool state, device),
    and ``trace_count`` counts their builds: with the engine's fixed
    per-run block shape it stays at 1 per config, as the JAX runner's
    trace count does."""

    def __init__(self, strategy, beta, channel: CommChannel,
                 scheduled: bool = False, pooled: bool = False,
                 buffered: Optional[BufferedAggregation] = None,
                 masked: Optional[bool] = None):
        self.strategy = strategy
        self.beta = float(beta)
        self.channel = channel
        self.scheduled = bool(scheduled)
        self.pooled = bool(pooled)
        self.buffered = buffered
        self.masked = self.scheduled if masked is None else bool(masked)
        self.simulate = channel.simulates_quantization
        self.partial = getattr(channel, "fraction", 1.0) < 1.0
        self.trace_count = 0
        self._programs: Dict = {}

    def mask_state(self, layout: FlatLayout, dev):
        """The partial channel's run-constant masks: ``(masks, None)`` or
        ``(None, chunk_ids)`` on the device, else ``(None, None)``."""
        if not (self.simulate and self.partial):
            return None, None
        return self.channel.flat_mask_state(layout, dev)

    def program(self, layout: FlatLayout, phi: torch.Tensor, staged,
                names, fields, pool_state: Optional[PoolState] = None
                ) -> _Program:
        """The buffers for this shape of run, made on first use."""
        pool_sig = (None if pool_state is None else tuple(
            (tuple(t.shape), t.dtype) for t in _pool_leaves(pool_state)))
        key = (str(phi.device), layout, phi.dtype, tuple(names),
               tuple(fields), pool_sig,
               tuple((tuple(t.shape), t.dtype) for t in staged))
        prog = self._programs.get(key)
        if prog is None:
            prog = _Program(self, layout, phi, staged, names, fields,
                            pool_state)
            self._programs[key] = prog
        return prog

    def run_block(self, prog: _Program, staged, rounds: int) -> None:
        """Copy a staged block into the program's buffers and run its
        first ``rounds`` rounds."""
        for dst, src in zip(prog.block, staged):
            dst.copy_(src)
        prog.cursor.zero_()
        if rounds and not prog.step.ready:
            self.trace_count += 1          # this block's first round builds
        for _ in range(rounds):
            prog.step()

    def _uplink(self, layout, phi, results, masks):
        """The results through the channel's uplink; a partial channel's
        dropped entries fall back to the strategy's reference."""
        channel = self.channel
        if isinstance(results, dict):
            return channel.transmit(results)
        ref = None
        if channel.needs_uplink_ref:
            kind = getattr(self.strategy, "uplink_ref", "params")
            if kind == "params":
                ref = phi
            elif kind == "zeros":
                ref = torch.zeros_like(phi)
        return channel.transmit_flat(layout, results, ref=ref,
                                     masks=masks if ref is not None
                                     else None)

    def _round(self, prog: _Program) -> None:
        strategy, channel, beta = self.strategy, self.channel, self.beta
        layout, phi, j = prog.layout, prog.phi, prog.cursor
        sched = prog.sched

        def row(t):
            return t.index_select(0, j)[0]

        batch = {k: row(v) for k, v in prog.batch.items()}
        masks = prog.masks
        if prog.chunk_ids is not None:
            masks = channel.masks_for_round(
                prog.chunk_ids, sched.round_index.index_select(0, j))
        phi_down = (channel.transmit_flat(layout, phi, masks=masks)
                    if self.simulate else phi)
        if self.masked:
            results, losses = strategy.client_update_steps(
                layout, phi_down, batch, beta, row(sched.local_steps))
        else:
            results, losses = strategy.client_update(layout, phi_down,
                                                     batch, beta)
        if self.simulate:
            results = self._uplink(layout, phi, results, masks)
        alpha_t = sched.alpha.index_select(0, j)        # on the device
        if self.pooled:
            new, loss = self._pooled_aggregate(prog, results, losses,
                                               alpha_t)
        elif self.scheduled:
            weights = row(sched.weights)
            new = strategy.server_aggregate_weighted(
                layout, phi, results, alpha_t, beta, weights)
            loss = _weighted_round_loss(losses, row(sched.local_steps),
                                        weights)
        else:
            new = strategy.server_aggregate(layout, phi, results, alpha_t,
                                            beta)
            loss = losses.float().mean()
        phi.copy_(new)
        prog.losses.index_copy_(0, j, loss.reshape(1))
        j.add_(1)

    def _pooled_aggregate(self, prog: _Program, results, losses, alpha_t):
        """A pooled round's server side: aggregate (or buffer and maybe
        flush), update the cohort's identity rows; returns (phi, loss)."""
        strategy, layout, phi, beta = (self.strategy, prog.layout, prog.phi,
                                       self.beta)
        sched, ps, j, buffered = prog.sched, prog.pool, prog.cursor, \
            self.buffered

        def row(t):
            return t.index_select(0, j)[0]

        part = row(sched.participation)
        weights = row(sched.weights)
        steps = row(sched.local_steps)
        rnd = sched.round_index.index_select(0, j)            # (1,) i32
        valid = sched.valid.index_select(0, j)                # (1,) bool
        clients = part.shape[0]
        i32 = torch.int32
        if buffered is None:
            new = torch.where(valid, strategy.server_aggregate_weighted(
                layout, phi, results, alpha_t, beta, weights), phi)
        else:
            # this round's arrivals go to the buffer's next free slots
            # (a prefix sum of the participation row); the rest to the
            # sink slot
            cap = ps.buf_round.shape[0] - 1
            arrive = part.to(i32)
            slot = torch.where(
                part, ps.buf_count + torch.cumsum(arrive, 0, dtype=i32) - 1,
                cap).long()
            tree_map(lambda b, q: b.index_copy_(0, slot, q.to(b.dtype)),
                     ps.buf_updates, results)
            ps.buf_round.index_copy_(0, slot, rnd.expand(clients))
            count = ps.buf_count + arrive.sum(dtype=i32)
            tags = ps.buf_round[:cap]
            held = torch.arange(cap, device=phi.device) < count
            w = buffered.staleness_fn((rnd - tags).float()) * held
            w = (w / torch.clamp(w.sum(), min=1e-8)).float()
            flushed = strategy.server_aggregate_weighted(
                layout, phi, tree_map(lambda b: b[:cap], ps.buf_updates),
                alpha_t, beta, w)
            do_flush = count >= buffered.buffer_size
            if buffered.flush_staleness is not None:
                oldest = torch.where(held, tags, _NEVER).min()
                do_flush = do_flush | ((count > 0) & (
                    rnd - oldest + 1 >= buffered.flush_staleness))
            do_flush = do_flush & valid
            new = torch.where(do_flush, flushed, phi)
            ps.buf_count.copy_(torch.where(do_flush, 0, count))
            ps.flushes.add_(do_flush.to(i32))
        # the cohort's identity rows; scheduled-out slots write the sink
        # (cohorts are unique within a round: no two writes collide)
        cohort = row(sched.cohort).long()
        idx = torch.where(part, cohort, ps.last_seen.shape[0] - 1)
        gap = rnd - ps.last_seen.index_select(0, cohort)
        ps.staleness.index_copy_(0, idx, gap)
        ps.last_seen.index_copy_(0, idx, rnd.expand(clients))
        ps.checkins.index_add_(0, idx, torch.ones_like(idx, dtype=i32))
        loss = torch.where(valid, _weighted_round_loss(losses, steps,
                                                       weights), 0.0)
        return new, loss


class _RunnerLRU:
    """The block runners by config, least recently used out first, with
    hit and miss counters (raises TypeError on an unhashable key)."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key, build):
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            return self._entries[key]
        self.misses += 1
        runner = build()
        self._entries[key] = runner
        if len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
        return runner

    def keys(self):
        return list(self._entries.keys())

    def clear(self):
        self._entries.clear()
        self.hits = 0
        self.misses = 0


_RUNNER_CACHE = _RunnerLRU(maxsize=64)
_UNHASHABLE_MISSES = {"count": 0}


def _block_runner(strategy, beta, channel: CommChannel,
                  scheduled: bool = False, pooled: bool = False,
                  buffered: Optional[BufferedAggregation] = None,
                  masked: Optional[bool] = None) -> _BlockRunner:
    """The cached runner of this config. Strategies and channels are
    frozen dataclasses, so identically configured runs share one runner
    and its built rounds, keyed as the JAX package keys its runners
    (``(strategy, beta, channel, scheduled, pooled, buffered, masked)``;
    its partitioner and mesh parts are not ported). An unhashable
    strategy gets an uncached runner, a fresh build per run, counted and
    logged."""
    masked = bool(scheduled) if masked is None else bool(masked)
    key = (strategy, float(beta), channel, bool(scheduled), bool(pooled),
           buffered, masked)

    def build():
        return _BlockRunner(strategy, beta, channel, scheduled, pooled,
                            buffered, masked)

    try:
        return _RUNNER_CACHE.get(key, build)
    except TypeError:
        _UNHASHABLE_MISSES["count"] += 1
        logger.warning(
            "block-runner cache miss #%d: strategy %s (channel %s) is "
            "unhashable; building an uncached runner (a fresh build per "
            "run). Make custom strategies frozen dataclasses to cache "
            "them.", _UNHASHABLE_MISSES["count"], type(strategy).__name__,
            type(channel).__name__)
        return build()


def runner_cache_stats() -> Dict[str, int]:
    """Block-runner cache counters: hits, misses, size and bound, how
    many times an unhashable strategy forced an uncached runner, and how
    many cached runners are pooled and buffered."""
    keys = _RUNNER_CACHE.keys()
    return {"hits": _RUNNER_CACHE.hits, "misses": _RUNNER_CACHE.misses,
            "currsize": len(keys), "maxsize": _RUNNER_CACHE.maxsize,
            "unhashable_misses": _UNHASHABLE_MISSES["count"],
            "pooled_entries": sum(1 for k in keys if k[4]),
            "buffered_entries": sum(1 for k in keys if k[5] is not None)}


def clear_runner_cache() -> None:
    """Drop every cached runner (with its buffers and graphs) and reset
    the counters."""
    _RUNNER_CACHE.clear()
    _UNHASHABLE_MISSES["count"] = 0


#: the slices that port run_federated's remaining arguments
_NOT_PORTED = {
    "mesh": "the multi-device slice (torch.distributed) ports it",
}


def _pool_named(ps: PoolState, layout: FlatLayout) -> PoolState:
    """The pool state as checkpoints hold it: a flat ``(capacity, P)``
    FedBuff buffer as named ``(capacity, *leaf)`` views, the JAX
    package's phi-shaped buffer leaves."""
    if isinstance(ps.buf_updates, torch.Tensor):
        ps = dataclasses.replace(ps, buf_updates=layout.views(
            ps.buf_updates))
    return ps


def _pool_from_saved(saved: PoolState, layout: FlatLayout, flat: bool,
                     dev) -> PoolState:
    """A restored (NumPy) pool state as tensors on ``dev``, the buffer
    packed back into one flat buffer where the run keeps it so."""
    ps = map_leaves(lambda a: torch.as_tensor(a, device=dev), saved)
    if flat and ps.buf_updates is not None:
        ps = dataclasses.replace(ps, buf_updates=layout.pack(
            ps.buf_updates, batch_dims=1))
    return ps


def _snapshot_copy(leaf):
    """A snapshot's own copy of a leaf (on its device, or on the host),
    so the next block cannot overwrite what the writer reads."""
    return leaf.clone() if isinstance(leaf, torch.Tensor) else np.array(leaf)


def run_federated(init_params, task_dist: TaskDistribution, strategy, *,
                  rounds: int, clients_per_round: int = 1,
                  alpha: float = 1.0, beta: float = 0.01, support: int = 32,
                  anneal: bool = True, seed: int = 0, eval_every: int = 0,
                  eval_kwargs: Optional[dict] = None,
                  channel: Optional[CommChannel] = None,
                  max_block: int = 512, prefetch: int = 2,
                  sampler: str = "reference",
                  sampling: Optional[SamplingPolicy] = None,
                  pool: Optional[ClientPool] = None,
                  buffered: Optional[BufferedAggregation] = None,
                  mesh=None, ckpt_dir: Optional[str] = None,
                  ckpt_every: int = 10, ckpt_keep: int = 3,
                  ckpt_async: bool = True, resume: bool = False,
                  tracker=None, device: DeviceLike = None) -> Dict:
    """Run ``rounds`` federated rounds of ``strategy`` on ``device``
    (default ``cuda``; the CPU only when asked).

    ``init_params`` is one model's ``{leaf: array}`` tree (NumPy arrays,
    e.g. the JAX package's init, or tensors). Returns ``{"params",
    "history"}`` (+ ``"comm_bytes"`` and ``"per_client_bytes"`` for
    strategies that meter communication; ``per_client_bytes[c]`` is the
    transport paid by cohort slot c, or by pool client c on pooled runs,
    billed only in rounds it takes part in). ``params`` is a ``{leaf:
    tensor}`` dict on ``device``; history rows are per-eval dicts:
    ``evaluate_init`` fields + round [+ comm_bytes, inner_loss].

    The host RNG is ``np.random.default_rng(seed)``; each block draws its
    schedule (``sampling.plan_schedule``, or ``plan_pool_schedule`` over
    a pool) and then its data, strictly in block order, on the prefetch
    thread; evals use ``default_rng(10_000 + round - 1)``. Same seed and
    init, same trajectory as the JAX package's ``run_federated`` up to
    float rounding.

    ``pool`` (a ``ClientPool`` over ``task_dist``) runs on persistent
    client identities: each round the policy seats a cohort of pool
    clients, their own data feeds the round, and the pool's state (last
    seen, staleness, check-ins) updates inside the round. ``buffered``
    (needs ``pool``) makes aggregation FedBuff-style async. Pooled runs
    bill per pool client and return ``"pool_state"``: ``last_seen``,
    ``staleness``, ``checkins`` (NumPy, one entry per pool client) [+
    ``flushes``, ``buffered_pending``]. A ``residency="host"`` pool
    keeps those arrays in host slabs: before each block the consumer
    stages the block's rows (after the previous block's write-back, so
    the prefetch thread never reads a slab a running block will write)
    and scatters them back after it.

    ``ckpt_dir`` makes the run preemption-safe: every ``ckpt_every``
    rounds and at the end (blocks are cut there) the whole carry is
    written as a ``checkpoint.RoundState`` (phi, the pool state with its
    FedBuff buffer, the bills, the history, the host RNG, the pool's and
    the policy's host state), keeping the newest ``ckpt_keep``; by a
    background writer (``ckpt_async``) or inline. ``resume=True``
    restores the newest valid snapshot in ``ckpt_dir`` (a fresh start,
    logged, when there is none; a snapshot of another config or past
    ``rounds`` is rejected) and continues bit for bit, also past the
    horizon the snapshot was written under. The files are the JAX
    package's, so either package resumes the other's snapshots.

    ``tracker`` attaches a ``metering.MetricsTracker`` (per-round inner
    losses, transport bytes, eval rows, wall clock, the final staleness
    of pooled runs, and each snapshot's milliseconds on the training
    thread, ``ckpt.snapshot_ms``, and on the writer's, ``ckpt.write_ms``);
    it only observes. ``mesh`` is not ported yet and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            f"run_federated(mesh=...) is not ported yet: "
            f"{_NOT_PORTED['mesh']}; the port runs one device")
    dev = resolve_device(device)
    if channel is None:
        channel = CommChannel()
    if sampling is None:
        # a pooled run's host path follows the pool's sampler
        sampling = UniformSampling(pool.sampler if pool is not None
                                   and sampler == "reference" else sampler)
    elif sampler != "reference":
        raise ValueError(
            f"pass the sampler on the sampling policy (e.g. "
            f"{type(sampling).__name__}(..., sampler={sampler!r})), not "
            f"as run_federated(sampler=...) alongside sampling=")
    pooled = pool is not None
    uplink_ref = getattr(strategy, "uplink_ref", "params")
    if buffered is not None:
        if not pooled:
            raise ValueError("buffered aggregation needs persistent "
                             "clients to be stale against: pass "
                             "pool=ClientPool(...) alongside buffered=")
        if uplink_ref == "none":
            raise ValueError(
                f"{type(strategy).__name__} uplinks raw data "
                f"(uplink_ref='none'); the FedBuff buffer holds "
                f"phi-shaped updates and cannot stage it")
    if pooled and pool.size < clients_per_round:
        raise ValueError(f"pool of {pool.size} clients cannot seat a "
                         f"cohort of {clients_per_round} (identities are "
                         f"unique within a round)")
    payload_dtype = getattr(strategy, "payload_dtype", "float32")
    if payload_dtype != "float32" and (channel.simulates_quantization
                                       or channel.dtype != payload_dtype):
        raise ValueError(
            f"{type(strategy).__name__} uplinks NATIVE {payload_dtype} "
            f"result trees (payload_dtype={payload_dtype!r}): the channel "
            f"must bill at that wire rate and must not re-simulate "
            f"quantization on already-quantized payloads — pass "
            f"CommChannel({payload_dtype!r}, quantize=False), got "
            f"{type(channel).__name__}(dtype={channel.dtype!r}, "
            f"simulates_quantization={channel.simulates_quantization})")
    if (uplink_ref == "none" and getattr(channel, "fraction", 1.0) < 1.0
            and channel._base_wire):
        raise NotImplementedError(
            f"{type(strategy).__name__} uplinks raw data; a partial "
            f"channel that also quantizes would mask that data by its "
            f"own tree, which the port does not do: use fraction=1.0 or "
            f"quantize=False")
    layout = FlatLayout.of(init_params)
    # a private copy: the caller's init stays usable across runs
    phi = layout.pack({k: torch.as_tensor(
        v if isinstance(v, torch.Tensor) else np.array(v), device=dev)
        for k, v in init_params.items()})
    rng = np.random.default_rng(seed)
    history: List[Dict] = []
    comm_bytes = 0
    per_client_bytes = np.zeros(pool.size if pooled else clients_per_round,
                                np.int64)
    uniform = getattr(sampling, "schedule_kind", "scheduled") == "uniform"
    scheduled = pooled or not uniform
    # uniform schedules run every client at the full budget: no per-step
    # masking (the masked hooks equal the plain ones at k == budget)
    masked = scheduled and not uniform
    budget = int(strategy.local_step_budget(support))
    beta = float(beta)
    host_resident = pooled and pool.residency == "host"
    uplink = strategy.uplink_template(layout, phi) if pooled else None
    start_round, saved, fingerprint = 0, None, None
    if ckpt_dir is not None:
        if not (isinstance(ckpt_every, int) and ckpt_every >= 1):
            raise ValueError(f"ckpt_every must be an int >= 1, got "
                             f"{ckpt_every!r}")
        if not (isinstance(ckpt_keep, int) and ckpt_keep >= 1):
            raise ValueError(f"ckpt_keep must be an int >= 1, got "
                             f"{ckpt_keep!r}")
        # the run's identity, stamped into every snapshot, with the JAX
        # package's keys and values: a resume under another config would
        # replay a different run from this one's carry
        fingerprint = {
            "seed": int(seed), "clients_per_round": int(clients_per_round),
            "support": int(support), "shards": 1, "mesh": "",
            "partitioner": "", "strategy": type(strategy).__name__,
            "pool_size": int(pool.size) if pooled else 0,
            "pool_sampler": pool.sampler if pooled else "",
            "policy_sampler": getattr(sampling, "sampler", "reference"),
            "buffered": buffered is not None}
    elif resume:
        raise ValueError("resume=True needs ckpt_dir= to restore from")
    if resume:
        # the full (N,) layout, whatever the residency, with the buffer
        # as named leaves: the templates of the checkpoint's arrays
        template = (_pool_named(pool.init_state(
            phi, clients_per_round, buffered, template=uplink,
            device="cpu"), layout) if pooled else None)
        try:
            saved = restore_round_state(
                ckpt_dir, phi=layout.views(phi), pool_state=template,
                per_client_bytes=per_client_bytes)
        except FileNotFoundError:
            logger.info("resume: no snapshot in %s yet; starting fresh",
                        ckpt_dir)
        if saved is not None:
            diff = {k: (saved.fingerprint.get(k), v)
                    for k, v in fingerprint.items()
                    if saved.fingerprint and saved.fingerprint.get(k) != v}
            if diff:
                raise ValueError(
                    f"checkpoint in {ckpt_dir} was written by a different "
                    f"run config (saved != current): {diff}")
            if saved.round > rounds:
                raise ValueError(
                    f"checkpoint in {ckpt_dir} is at round {saved.round}, "
                    f"past rounds={rounds}; raise the horizon to continue")
            start_round = int(saved.round)
            phi = layout.pack({k: torch.as_tensor(v, device=dev)
                               for k, v in saved.phi.items()})
            if pooled:
                pool.load_host_state(saved.host.get("pool", {}))
            per_client_bytes = np.asarray(saved.per_client_bytes,
                                          np.int64).copy()
            comm_bytes = int(saved.comm_bytes)
            history = list(saved.history)
            # the host rng continues exactly where the interrupted run's
            # producer stopped drawing
            rng.bit_generator.state = saved.host["rng"]
            sampling.load_state_dict(saved.host.get("sampling", {}),
                                     rng=rng)
            logger.info("resumed %s from round %d", ckpt_dir, start_round)
    # pad depends on ckpt_every but not on the start: a resumed run
    # builds (or finds) the same round as the run it continues
    blocks, pad = plan_blocks(rounds, eval_every, max_block,
                              start=start_round,
                              ckpt_every=ckpt_every if ckpt_dir else 0)
    slabs = slab_rows = None
    if host_resident:
        slabs = pool.init_slabs()
        # the device holds one row per distinct client a block can seat
        slab_rows = min(pool.size, pad * clients_per_round)
    pool_state = (pool.init_state(
        phi, clients_per_round, buffered, template=uplink, rows=slab_rows,
        device=dev) if pooled else None)
    if saved is not None and pooled:
        restored = _pool_from_saved(saved.pool_state, layout,
                                    isinstance(uplink, torch.Tensor), dev)
        if host_resident:
            # the identity goes to the slabs before the first block's
            # gather; the device keeps its window and the FedBuff buffer
            for f in ClientPool.SLAB_FIELDS:
                slabs[f][:] = getattr(saved.pool_state, f)
            restored = dataclasses.replace(restored, **{
                f: getattr(pool_state, f) for f in ClientPool.SLAB_FIELDS})
        pool_state = restored
    if strategy.meters_comm:
        # per-round payloads repeat with a rotating channel's period
        period = (channel.rotation_period
                  if getattr(channel, "rotate", False) else 1)
        payload_by_phase = np.array(
            [channel.payload_bytes_at(init_params, j) for j in range(period)],
            np.int64)

    def stage(i):
        """Plan the schedule, sample, pad and stage block i. Called
        strictly in block order (inline, or from the one prefetch
        thread): the schedule draws first, then the data."""
        start, end = blocks[i]
        blk = end - start
        if pooled:
            plan = sampling.plan_pool_schedule(rng, start, end,
                                               clients_per_round, budget,
                                               pool.size)
            part = np.asarray(plan["participation"], bool)
            cohort = np.asarray(plan["cohort"], np.int32)
            batch = pool.sample_cohort_block(cohort, part, support,
                                             strategy.data_mode)
            uniq, sched_cohort = None, cohort
            if host_resident:
                # global ids -> rows of the block's window: the sorted
                # distinct participants, inverted by searchsorted; slots
                # of non-participants clamp into range (they write the
                # sink); billing keeps the global ids
                uniq = np.unique(cohort[part]).astype(np.int64)
                if uniq.size:
                    sched_cohort = np.searchsorted(uniq, cohort).astype(
                        np.int32)
                    np.clip(sched_cohort, 0, uniq.size - 1, out=sched_cohort)
                else:
                    sched_cohort = np.zeros_like(cohort)
        else:
            plan = sampling.plan_schedule(rng, start, end, clients_per_round,
                                          budget)
            part = np.asarray(plan["participation"], bool)
            cohort = uniq = sched_cohort = None
            batch = sampling.sample_block(task_dist, rng, blk,
                                          clients_per_round, support,
                                          strategy.data_mode,
                                          participation=part)
        r = np.arange(start, end)
        alphas = np.zeros(pad, np.float32)
        alphas[:blk] = alpha * (1 - r / rounds) if anneal else alpha
        valid = np.zeros(pad, bool)
        # pooled rounds where nobody checked in are no-ops on the device
        valid[:blk] = part.any(axis=1) if pooled else True
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
            weights=pad_rows(plan["weights"], np.float32),
            cohort=pad_rows(sched_cohort, np.int32) if pooled else None)
        fields = sched.present()
        names = sorted(batch)
        data = [np.asarray(batch[k]) for k in names]
        if blk < pad:
            data = [np.concatenate([v, np.zeros((pad - blk,) + v.shape[1:],
                                                v.dtype)]) for v in data]
        staged, event = _stage([getattr(sched, f) for f in fields] + data,
                               dev)
        if ckpt_at(end):
            host_snaps[end] = snapshot_host()
        return part, cohort, uniq, staged, names, fields, event

    def ckpt_at(end):
        """Whether a snapshot is taken after the block ending at ``end``
        (``plan_blocks`` cuts blocks there): the same predicate on the
        producer, for the host state, and on the consumer."""
        return ckpt_dir is not None and (end == rounds
                                         or end % ckpt_every == 0)

    def snapshot_host():
        """The host carry once block i's draws are done, taken on the
        prefetch producer inside ``stage(i)``: the RNG, the pool's and
        the policy's streams resume exactly where the uninterrupted
        run's producer continues."""
        snap = {"rng": copy.deepcopy(rng.bit_generator.state)}
        if pooled:
            snap["pool"] = pool.host_state()
        policy_state = sampling.state_dict()
        if policy_state:
            snap["sampling"] = policy_state
        return snap

    def snapshot(end):
        """The carry after the block ending at ``end``: clones of phi and
        of the pool state made on the training stream (the next block's
        replays overwrite the runner's buffers), the identity of a
        host-resident pool from its slabs after the write-back, and an
        event recorded after the clones for the writer to wait on."""
        pool_snap = None
        if pooled:
            ps = _pool_named(prog.pool_state(), layout)
            if host_resident:
                ps = dataclasses.replace(ps, **{
                    f: slabs[f] for f in ClientPool.SLAB_FIELDS})
            pool_snap = map_leaves(_snapshot_copy, ps)
        state = RoundState(
            round=end, phi=layout.views(prog.phi.clone()),
            pool_state=pool_snap, per_client_bytes=per_client_bytes.copy(),
            comm_bytes=comm_bytes, history=list(history),
            host=host_snaps.pop(end), fingerprint=fingerprint)
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return state, ready

    host_snaps: Dict[int, dict] = {}
    writer = (AsyncCheckpointWriter(ckpt_dir, keep=ckpt_keep,
                                    tracker=tracker)
              if ckpt_dir is not None and ckpt_async and blocks else None)

    runner = _block_runner(strategy, beta, channel, scheduled,
                           pooled=pooled, buffered=buffered, masked=masked)
    prog = None
    staged_iter = prefetch_items(stage, len(blocks), depth=prefetch)
    if tracker is not None:
        tracker.on_run_start()
    try:
        for (start, end), (part, cohort, uniq, staged, names, fields,
                           event) in zip(blocks, staged_iter):
            _consume(staged, event)
            if prog is None:
                prog = runner.program(layout, phi, staged, names, fields,
                                      pool_state)
                prog.phi.copy_(phi)
                if pooled:
                    prog.load_pool(pool_state)
            if host_resident:
                # the block's identity rows, from the slabs as the last
                # block left them (window tail rows: client 0's, unused)
                window = np.zeros(slab_rows, np.int64)
                window[:uniq.size] = uniq
                rows = pool.gather_rows(window)
                for f in ClientPool.SLAB_FIELDS:
                    getattr(prog.pool, f)[:-1].copy_(
                        torch.from_numpy(rows[f]))
            blk = end - start
            runner.run_block(prog, staged, blk)   # the pad rounds: never
            if host_resident and uniq.size:
                pool.scatter_rows(uniq, {
                    f: getattr(prog.pool, f)[:uniq.size].cpu().numpy()
                    for f in ClientPool.SLAB_FIELDS})
            needs_eval = bool(eval_every) and end % eval_every == 0
            if tracker is not None or (needs_eval
                                       and strategy.tracks_inner_loss):
                # the one device->host read of the block's losses
                host_losses = prog.losses[:blk].cpu().numpy()
            if tracker is not None:
                tracker.on_block(start, end, host_losses)
            if strategy.meters_comm:
                # bill downlink + uplink per participating client, at the
                # round's exact (possibly rotating) payload
                payloads = payload_by_phase[
                    np.arange(start, end) % len(payload_by_phase)]
                bills = 2 * payloads[:, None] * part
                if pooled:
                    # the pool client seated in each participating slot
                    np.add.at(per_client_bytes, cohort[part], bills[part])
                else:
                    per_client_bytes += bills.sum(axis=0)
                block_bytes = int(bills.sum())
                comm_bytes += block_bytes
                if tracker is not None:
                    tracker.on_transport(end, block_bytes, comm_bytes)
            if needs_eval:
                ev = evaluate_init(strategy.loss_fn, layout.views(prog.phi),
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
            if ckpt_at(end):
                t_snap = time.perf_counter()
                state, ready = snapshot(end)
                if writer is not None:
                    writer.submit_state(state, ready)
                else:
                    save_round_state(ckpt_dir, state, keep=ckpt_keep)
                if tracker is not None:
                    # the training thread's share: the device copies and
                    # the submit (the whole write when not async)
                    tracker.observe("ckpt.snapshot_ms",
                                    1e3 * (time.perf_counter() - t_snap))
        if writer is not None:
            writer.close()        # drain the snapshots; raise their errors
    finally:
        staged_iter.close()
        if writer is not None:
            writer.close(raise_errors=False)
        if tracker is not None:
            tracker.stop_profile()

    if prog is not None:
        phi = prog.phi.clone()     # the runner's buffer serves later runs
    out = {"params": layout.views(phi), "history": history}
    if strategy.meters_comm:
        out["comm_bytes"] = comm_bytes
        out["per_client_bytes"] = per_client_bytes.tolist()
    if pooled:
        ps = prog.pool_state() if prog is not None else pool_state
        ident = (slabs if host_resident else
                 {f: getattr(ps, f).cpu().numpy()
                  for f in ClientPool.SLAB_FIELDS})
        out["pool_state"] = {f: np.array(ident[f][:pool.size])
                             for f in ClientPool.SLAB_FIELDS}
        if buffered is not None:
            out["pool_state"]["flushes"] = int(ps.flushes)
            out["pool_state"]["buffered_pending"] = int(ps.buf_count)
    if tracker is not None:
        tracker.on_run_end(
            runner_cache_stats(),
            staleness=out["pool_state"]["staleness"] if pooled else None)
    return out
