"""Continuous-batching adaptation server over a meta-learned init.

The paper's deployment story: a new device checks in with a few support
samples, fine-tunes the broadcast phi for k steps, and is scored on its
own query data. The server keeps B padded SLOTS on the device and
advances all of them a few steps per TICK. Each unit step is one kernel
launch over all slots (``online_sgd`` for fp32, ``dfa_epoch_int8`` for
TIFeD).

No shape ever changes, so the tick is built once per server, as the JAX
server's is traced once (``AdaptationServer.trace_count``): a
``graphs.GraphStep``, captured as a CUDA graph on the card and replayed,
run as it is on the CPU. Every tick reads a refill of B rows, row b for
slot b, from one fixed device buffer: the host writes the admitted
requests into a pinned buffer of the same layout and makes one copy, and
the tick takes row b only where the refill's mask is set (a
``torch.where``, so no index ever points past the state). It writes the
state in place and its one output, (finished, query loss, steps) per
slot, to one buffer that the host reads once per tick.

Numerics: ``offline_adapt`` runs the same unit steps on a request set
held in memory, in FIFO groups at the same slot width; a served request
equals it exactly on the same device.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import GraphStep, weak_method


@dataclasses.dataclass
class AdaptResult:
    """One retired request: its id, adapted-params query loss, the steps
    it ran, and submit->retire wall latency. ``params`` is the adapted
    fp32 tree (NumPy) when the server runs with ``return_params=True``
    (off by default: it copies the slot's params to the host)."""
    rid: int
    query_loss: float
    steps: int
    latency_s: float
    params: Optional[Dict] = None


class _Pending:
    __slots__ = ("rid", "sx", "sy", "qx", "qy", "k", "t_submit")

    def __init__(self, rid, sx, sy, qx, qy, k, t_submit):
        self.rid, self.sx, self.sy = rid, sx, sy
        self.qx, self.qy, self.k = qx, qy, k
        self.t_submit = t_submit


def _bcast(mask, like):
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _advance(adapter, pack, slots, step, k, active, n_steps):
    """``n_steps`` masked unit steps: live slots (active, step < k) take
    the new state, the others keep theirs. A mask and not lr = 0, so a
    non-finite value in a retired slot cannot leak (0 * inf = NaN)."""
    for _ in range(n_steps):
        live = active & (step < k)
        new, _ = adapter.unit_step(pack, slots, step)
        slots = {key: torch.where(_bcast(live, new[key]), new[key], old)
                 for key, old in slots.items()}
        step = step + live.to(step.dtype)
    return slots, step


def _to_phi(phi, device):
    if all(isinstance(v, torch.Tensor) for v in phi.values()):
        return {k: v.to(device) for k, v in phi.items()}
    return params_from_numpy(phi, device)


def _leaves(tree):
    """The leaves of a pack (nested dicts, tuples and lists), in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _same_program(old, new) -> bool:
    """Whether a tick built on pack ``old`` serves pack ``new`` once
    ``new``'s tensors are copied into ``old``'s: the same tensor shapes,
    dtypes and devices, and equal host values (which a capture bakes
    in)."""
    a, b = list(_leaves(old)), list(_leaves(new))
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.shape == y.shape
                    and x.dtype == y.dtype and x.device == y.device):
                return False
        elif isinstance(y, torch.Tensor) or x != y:
            return False
    return True


# the refill's fields, one after another in one fp32 buffer: the four
# request arrays per row, then k and the row's refill mask
_REFILL = ("sx", "sy", "qx", "qy", "k", "fill")


class AdaptationServer:
    """Serve a ragged stream of client-adaptation requests against one
    meta-learned init.

    - ``phi``: the init, a ``{w0, b0, ...}`` dict of tensors or arrays;
    - ``adapter``: ``Fp32Adapter`` or ``TifedAdapter``;
    - ``slots``: continuous-batching width B;
    - ``k_max``: bound on a request's steps (1 <= k <= k_max);
    - ``steps_per_tick``: unit steps advanced per tick;
    - ``metrics``: optional ``metering.MetricsTracker``;
    - ``device``: ``"cuda"`` (default) or ``"cpu"``.

    Request shapes are fixed by the first submitted request.
    ``trace_count`` counts the builds of the tick: 1 after the first
    tick, on either device.
    """

    def __init__(self, phi, adapter, *, slots: int, k_max: int,
                 steps_per_tick: int = 4, metrics=None,
                 return_params: bool = False, device: DeviceLike = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        if steps_per_tick < 1:
            raise ValueError(
                f"steps_per_tick must be >= 1, got {steps_per_tick}")
        self.device = resolve_device(device)
        self.adapter = adapter
        self.B = int(slots)
        self.k_max = int(k_max)
        self.steps_per_tick = int(steps_per_tick)
        self.metrics = metrics
        self.return_params = bool(return_params)
        self.trace_count = 0
        self.ticks = 0
        self._pack = adapter.pack_phi(_to_phi(phi, self.device))
        self._queue: collections.deque = collections.deque()
        self._inflight: Dict[int, _Pending] = {}
        self._free = list(range(self.B))      # ascending slot ids
        self._next_rid = 0
        self._state = None                    # allocated on first submit
        self._shapes = None
        self._tick_step = None

    # -- device state ------------------------------------------------------
    def _alloc_state(self, req: _Pending):
        self._shapes = {"sx": req.sx.shape, "sy": req.sy.shape,
                        "qx": req.qx.shape, "qy": req.qy.shape}
        B, dev = self.B, self.device
        f32 = torch.float32
        proto = self.adapter.prepare(
            self._pack, torch.zeros((1,) + req.sx.shape, dtype=f32,
                                    device=dev),
            torch.zeros((1,) + req.sy.shape, dtype=f32, device=dev))
        self._state = {
            "slots": {k: torch.zeros((B,) + v.shape[1:], dtype=v.dtype,
                                     device=dev) for k, v in proto.items()},
            "qx": torch.zeros((B,) + req.qx.shape, dtype=f32, device=dev),
            "qy": torch.zeros((B,) + req.qy.shape, dtype=f32, device=dev),
            "k": torch.zeros((B,), dtype=torch.int32, device=dev),
            "step": torch.zeros((B,), dtype=torch.int32, device=dev),
            "active": torch.zeros((B,), dtype=torch.bool, device=dev),
            "qloss": torch.zeros((B,), dtype=f32, device=dev),
        }
        shapes = [self._shapes[f] for f in _REFILL[:4]] + [(), ()]
        sizes = [B * math.prod(sh) for sh in shapes]
        host = torch.zeros(sum(sizes), dtype=f32,
                           pin_memory=dev.type == "cuda")
        self._refill_host = host
        self._refill_dev = torch.zeros_like(host, device=dev)
        self._refill, self._refill_np, at = {}, {}, 0
        for name, sh, n in zip(_REFILL, shapes, sizes):
            self._refill[name] = self._refill_dev[at:at + n].view((B,) + sh)
            self._refill_np[name] = host[at:at + n].view((B,) + sh).numpy()
            at += n
        # finished, query loss and steps per slot, read once per tick
        self._out = torch.zeros((3, B), dtype=f32, device=dev)
        self._tick_step = GraphStep(weak_method(self._tick), dev)

    @torch.no_grad()
    def _tick(self):
        """One tick on the fixed buffers: the masked refill, then
        ``steps_per_tick`` masked unit steps, the query loss of the slots
        that finish, and the retire mask."""
        st, ad, pack, rf = self._state, self.adapter, self._pack, self._refill
        fill = rf["fill"] > 0
        fresh = ad.prepare(pack, rf["sx"], rf["sy"])
        slots = {key: torch.where(_bcast(fill, fresh[key]), fresh[key], old)
                 for key, old in st["slots"].items()}
        qx = torch.where(_bcast(fill, rf["qx"]), rf["qx"], st["qx"])
        qy = torch.where(_bcast(fill, rf["qy"]), rf["qy"], st["qy"])
        k = torch.where(fill, rf["k"].to(torch.int32), st["k"])
        step = torch.where(fill, 0, st["step"])
        active = st["active"] | fill
        slots, step = _advance(ad, pack, slots, step, k, active,
                               self.steps_per_tick)
        finished = active & (step >= k)
        ql = ad.query_loss(pack, slots, qx, qy)
        qloss = torch.where(finished, ql,
                            torch.where(fill, 0.0, st["qloss"]))
        for key, t in st["slots"].items():
            t.copy_(slots[key])
        for key, t in (("qx", qx), ("qy", qy), ("k", k), ("step", step),
                       ("active", active & ~finished), ("qloss", qloss)):
            st[key].copy_(t)
        self._out[0].copy_(finished)
        self._out[1].copy_(qloss)
        self._out[2].copy_(step)

    # -- host control loop -------------------------------------------------
    def submit(self, sx, sy, qx, qy, k: int) -> int:
        """Enqueue one adaptation request (FIFO). Returns its id."""
        sx = np.asarray(sx, np.float32)
        sy = np.asarray(sy, np.float32)
        qx = np.asarray(qx, np.float32)
        qy = np.asarray(qy, np.float32)
        k = int(k)
        if not 1 <= k <= self.k_max:
            raise ValueError(f"k={k} outside [1, {self.k_max}]")
        if k > sx.shape[0] and self.adapter.name == "fp32":
            raise ValueError(f"k={k} online steps need >= k support "
                             f"samples, got {sx.shape[0]}")
        if self._shapes is not None:
            for name, arr in (("sx", sx), ("sy", sy), ("qx", qx),
                              ("qy", qy)):
                if arr.shape != self._shapes[name]:
                    raise ValueError(
                        f"{name} shape {arr.shape} != server shape "
                        f"{self._shapes[name]} (fixed by first request)")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Pending(rid, sx, sy, qx, qy, k,
                                    time.monotonic()))
        if self.metrics is not None:
            self.metrics.on_admit(
                sx.nbytes + sy.nbytes + qx.nbytes + qy.nbytes)
        return rid

    def _build_refill(self):
        """Admit waiting requests into free slots: request rows into the
        pinned refill at their slots' rows, the mask set there, then one
        copy to the device. (The host writes the pinned buffer again only
        after the tick's read, which follows the copy.)"""
        h = self._refill_np
        h["fill"][:] = 0
        while self._queue and self._free:
            req = self._queue.popleft()
            slot = self._free.pop(0)          # lowest free slot first
            for name in _REFILL[:4]:
                h[name][slot] = getattr(req, name)
            h["k"][slot] = req.k
            h["fill"][slot] = 1
            self._inflight[slot] = req
        self._refill_dev.copy_(self._refill_host, non_blocking=True)

    def step(self) -> List[AdaptResult]:
        """Admit waiting requests into free slots, run ONE tick, retire
        finished slots. Returns this tick's retired results."""
        if not self._queue and not self._inflight:
            return []
        if self._state is None:
            self._alloc_state(self._queue[0])
        self._build_refill()
        if not self._tick_step.ready:
            self.trace_count += 1             # this tick builds
        self._tick_step()
        self.ticks += 1
        if self.metrics is not None:
            self.metrics.on_tick()
        fin, ql, steps = self._out.cpu().numpy()   # the tick's one read
        results: List[AdaptResult] = []
        if fin.any():
            params = None
            if self.return_params:
                params = params_to_numpy(
                    self.adapter.finish(self._pack, self._state["slots"]))
            now = time.monotonic()
            for slot in np.nonzero(fin)[0]:
                slot = int(slot)
                req = self._inflight.pop(slot)
                self._free.append(slot)
                p = ({k: v[slot].copy() for k, v in params.items()}
                     if params is not None else None)
                res = AdaptResult(rid=req.rid, query_loss=float(ql[slot]),
                                  steps=int(steps[slot]),
                                  latency_s=now - req.t_submit, params=p)
                results.append(res)
                if self.metrics is not None:
                    self.metrics.on_retire(res.latency_s, res.steps)
            self._free.sort()
        return results

    def drain(self) -> List[AdaptResult]:
        """Tick until the queue and every slot are empty."""
        results: List[AdaptResult] = []
        while self._queue or self._inflight:
            results.extend(self.step())
        return results

    @property
    def idle(self) -> bool:
        return not self._queue and not self._inflight

    def set_params(self, phi) -> None:
        """Swap the served init. Requires an idle server: in-flight
        requests finish against their phi. Where the new pack has the
        old one's shapes and host values, its tensors are copied into
        the old ones and the built tick serves on; otherwise the tick is
        built again at the next tick (and counted)."""
        if not self.idle:
            raise RuntimeError("cannot swap phi with requests in flight")
        pack = self.adapter.pack_phi(_to_phi(phi, self.device))
        if _same_program(self._pack, pack):
            for old, new in zip(_leaves(self._pack), _leaves(pack)):
                if isinstance(old, torch.Tensor):
                    old.copy_(new)
            return
        self._pack = pack
        if self._state is not None:
            self._tick_step = GraphStep(weak_method(self._tick), self.device)

    def reset(self) -> None:
        """Drop all queued work and zero the slot state (phi and the
        built tick stay)."""
        self._queue.clear()
        self._inflight.clear()
        self._free = list(range(self.B))
        self.ticks = 0
        if self._state is not None:
            for key, val in self._state.items():
                if key == "slots":
                    for t in val.values():
                        t.zero_()
                else:
                    val.zero_()


@torch.no_grad()
def offline_adapt(phi, adapter, requests, *, slots: int, k_max: int,
                  device: DeviceLike = None) -> List[Dict]:
    """One-shot adaptation of a request set held in memory: pack
    ``requests`` (dicts with sx/sy/qx/qy/k) FIFO into width-``slots``
    groups and run each group's k_max masked unit steps. The parity
    reference for ``AdaptationServer``.

    Returns one {"params", "query_loss", "steps"} dict per request, in
    submission order (params as NumPy)."""
    if not requests:
        return []
    dev = resolve_device(device)
    pack = adapter.pack_phi(_to_phi(phi, dev))
    B = int(slots)
    out: List[Dict] = []
    for g0 in range(0, len(requests), B):
        group = requests[g0:g0 + B]
        pad = B - len(group)

        def stack(f):
            arr = np.stack([np.asarray(r[f], np.float32) for r in group]
                           + [np.zeros_like(np.asarray(group[0][f],
                                                       np.float32))] * pad)
            return torch.from_numpy(arr).to(dev)

        sx, sy, qx, qy = (stack(f) for f in ("sx", "sy", "qx", "qy"))
        k = torch.tensor([r["k"] for r in group] + [0] * pad,
                         dtype=torch.int32, device=dev)
        active = torch.tensor([True] * len(group) + [False] * pad,
                              device=dev)
        step = torch.zeros((B,), dtype=torch.int32, device=dev)
        slots_, step = _advance(adapter, pack, adapter.prepare(pack, sx, sy),
                                step, k, active, k_max)
        ql = adapter.query_loss(pack, slots_, qx, qy).cpu().numpy()
        params = params_to_numpy(adapter.finish(pack, slots_))
        steps = step.cpu().numpy()
        for i in range(len(group)):
            out.append({"params": {k_: v[i].copy()
                                   for k_, v in params.items()},
                        "query_loss": float(ql[i]),
                        "steps": int(steps[i])})
    return out
