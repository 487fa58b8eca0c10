"""Sharding rules and the process meshes of the port, after the JAX
package's ``runtime/sharding.py``.

The rules are pure functions of a leaf's path and shape and of a mesh's
``axis_names`` and ``shape`` (a mapping of axis name to size), so any
object with those two attributes serves: a ``ProcessMesh`` of live
ranks, or a ``MeshShape`` that names a production mesh without starting
a process. A rule returns the JAX package's ``PartitionSpec`` as a plain
tuple, one entry per dim: None (replicated), an axis name, or a tuple of
names. Strategy, as there:

- tensor parallelism on the ``model`` axis: the FFN hidden dim,
  attention heads (falling back to head_dim, then the contraction dim),
  MoE experts (expert parallelism when E divides), vocab for embed and
  lm_head;
- FSDP on the ``data`` axis for a leaf whose per-model-shard footprint
  exceeds ``FSDP_THRESHOLD_BYTES``;
- batch on (``pod``, ``data``); long-context decode shards the KV cache's
  sequence dim instead.

Every rule respects divisibility: an axis that does not divide its dim
is dropped (replicated).

The port runs one process per rank, each with an explicit device.
``init_distributed`` joins the ranks into a ``torch.distributed`` process
group, the backend chosen by the topology: gloo for CPU ranks, NCCL
where each rank has a card of its own, and gloo over CUDA tensors where
ranks share one card (NCCL refuses two ranks on one device; gloo takes
CUDA tensors for ``all_reduce`` and ``broadcast``). A ``ProcessMesh``
lays the group's ranks out as a ``DeviceMesh`` with named axes and
gives each axis's process group. ``all_reduce`` and ``gather_rows`` are
the collectives the engine uses, built only on ``all_reduce`` so that
they run on every backend.

The 2-D ``("clients", "model")`` route holds each leaf of phi as this
rank's shard of it, a plain local tensor beside its spec
(``ModelShards``: ``shard_of``, ``gather``, ``local_shape``); DTensor's
redistribution is never run, since its all-gather and reduce-scatter
fail on a gloo group of CUDA tensors. A gather is a zero-padded
``all_reduce`` of the leaf's bytes, exact; a gathered leaf's gradient is
its slice (every rank of a model group computes the same one). The two
autograd functions of tensor parallelism (``copy_to_model``: identity
forward, an ``all_reduce`` backward; ``reduce_from_model``: an
``all_reduce`` forward, identity backward) bracket the column- and
row-parallel products of ``models/transformer.py``. The run's
``ModelShards`` is the calling thread's while the engine runs a round or
an eval (``model_shards_scope``, ``active_model_shards``).

On the production mesh (``("data", "model")``, ``("pod", "data",
"model")``) the same holder also splits a leaf on ``data`` (FSDP), with
each leaf's spec decided on the JAX package's layout (``layout_specs``,
``ModelShards.of_model``): a leaf's data parts are gathered where it is
used (``model_part``, the same zero-padded ``all_reduce``), and the
gather's backward sums the gradient over the data group and keeps this
rank's slice (``_GatherData``). ``BatchMean`` sums every other gradient
over the batch ranks once. ``DATA_CALLS`` counts the data group's
collectives.

A production decode step holds only this rank's part of the decode
cache (``CacheShards``, from ``cache_rule``: the JAX package's
``attn_cache_spec`` and ``mamba_cache_spec`` on the JAX layout's leaf):
a KV cache's batch over the batch axes where they divide it, its
sequence over the axes left (``SeqSlice``: the rank's offset and the
groups its attention is merged over); ``MERGE_CALLS`` counts the merges.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike

logger = logging.getLogger(__name__)

FSDP_THRESHOLD_BYTES = 32 * 1024 * 1024


# -- meshes -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its axes alone: what the rules read, without ranks."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


class ProcessMesh:
    """The ranks of a process group as a mesh with named axes: a
    ``torch.distributed.device_mesh.DeviceMesh`` and this rank's device.
    A one-rank mesh needs no process group (``device_mesh`` None): its
    collectives are the identity and are skipped.

    ``shape`` maps each axis to its size; ``group(axis)`` is the process
    group along an axis (None on a mesh without a group);
    ``coordinate(axis)`` this rank's index along it; ``backend`` the
    group's backend; ``devices`` every rank's device, in rank order;
    ``key`` what identifies the mesh in a cache of built rounds."""

    def __init__(self, axis_names, sizes, device: torch.device,
                 device_mesh=None, devices: Optional[Tuple[str, ...]] = None):
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.devices = devices if devices is not None else (str(self.device),)
        if device_mesh is None:
            self.backend = None
        else:
            import torch.distributed as dist
            self.backend = str(dist.get_backend())

    @classmethod
    def of(cls, device_mesh, device) -> "ProcessMesh":
        """A ``DeviceMesh`` with named axes, this rank on ``device``."""
        import torch.distributed as dist
        devices = [None] * dist.get_world_size()
        dist.all_gather_object(devices, str(torch.device(device)))
        return cls(device_mesh.mesh_dim_names, tuple(device_mesh.shape),
                   device, device_mesh, tuple(devices))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def group(self, axis: str):
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    @property
    def capturable(self) -> bool:
        """Whether a round that calls this mesh's collectives can be
        captured as a CUDA graph: NCCL's can, gloo's stage through the
        host and cannot, and a mesh without a group calls none."""
        return self.backend in (None, "nccl")

    def key(self):
        groups = (tuple(self.group(a) for a in self.axis_names)
                  if self.device_mesh is not None else None)
        return (self.axis_names, self.sizes, self.backend, self.devices,
                groups)

    def __repr__(self):
        return (f"ProcessMesh({dict(self.shape)}, backend={self.backend}, "
                f"devices={list(self.devices)})")


def make_mesh(sizes, axis_names, device: DeviceLike = None) -> ProcessMesh:
    """The process group's ranks laid out as a mesh of ``sizes`` over
    ``axis_names`` (rank-major), on this rank's ``device`` (default: the
    one ``init_distributed`` chose, else ``cuda``). The world size must
    equal the mesh's size; a one-rank mesh needs no process group."""
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    need = math.prod(sizes)
    dev = resolve_device(device if device is not None else _RANK["device"])
    if not dist.is_initialized():
        if need == 1:
            return ProcessMesh(axis_names, sizes, dev)
        raise ValueError(
            f"a mesh of {dict(zip(axis_names, sizes))} needs {need} ranks; "
            f"this process is not in a process group (start {need} ranks "
            f"and call repro_torch.runtime.sharding.init_distributed in "
            f"each, or use the launcher's --devices / --num-processes)")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"a mesh of {dict(zip(axis_names, sizes))} needs {need} ranks; "
            f"the process group has {world} (the port runs one process per "
            f"rank: the mesh spans the whole group)")
    from torch.distributed.device_mesh import DeviceMesh
    return ProcessMesh.of(DeviceMesh(
        dev.type, torch.arange(world).reshape(tuple(sizes)),
        mesh_dim_names=tuple(axis_names)), dev)


def client_model_mesh(clients: int, model: int,
                      device: DeviceLike = None) -> ProcessMesh:
    """The engine's 2-D ``("clients", "model")`` mesh over the process
    group: ``clients`` cohort shards times ``model`` tensor-parallel
    shards, rank-major (the ranks of one ``clients`` coordinate form a
    ``model`` group). The group must hold exactly ``clients * model``
    ranks (one process a rank; one rank needs no group)."""
    if clients < 1 or model < 1:
        raise ValueError(f"mesh extents must be >= 1, got "
                         f"clients={clients}, model={model}")
    import torch.distributed as dist
    need = clients * model
    have = dist.get_world_size() if dist.is_initialized() else 1
    if need > have:
        raise ValueError(
            f"client_model_mesh of {clients}x{model} needs {need} ranks, "
            f"have {have}; start {need} ranks (one process each) joined by "
            f"repro_torch.runtime.sharding.init_distributed")
    return make_mesh((clients, model), ("clients", "model"), device)


# -- joining the ranks ---------------------------------------------------------

#: the device init_distributed chose for this process (make_mesh's
#: default)
_RANK: Dict[str, Any] = {"device": None}


def place_ranks(ranks) -> Tuple[str, ...]:
    """Every rank's device, in rank order, from what each rank published:
    ``{"host": name, "device": asked, "cards": its host's card count}``.
    ``asked`` is "cpu", "cuda:<i>", or None or "cuda" for the rule: the
    next card of its host (card ``i % cards`` for the i-th such rank
    there, in rank order), or the CPU on a host without a card. Every
    rank computes the same placement from the same list."""
    placed, taken = [], {}
    for r in ranks:
        dev = r["device"]
        if dev in (None, "cuda"):
            if r["cards"]:
                i = taken.get(r["host"], 0)
                taken[r["host"]] = i + 1
                dev = f"cuda:{i % r['cards']}"
            else:
                dev = "cpu"
        placed.append(str(torch.device(dev)))
    return tuple(placed)


def choose_backend(hosts, devices) -> str:
    """The backend for ranks on ``devices`` (one per rank) of ``hosts``
    (each rank's host): gloo when a rank is on the CPU or when two ranks
    of one host share a card (NCCL refuses that; gloo stages CUDA
    tensors through the host), NCCL when each rank has a card of its
    own, however many hosts they span."""
    if any(torch.device(d).type != "cuda" for d in devices):
        return "gloo"
    cards = list(zip(hosts, devices))
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


def init_distributed(coordinator: Optional[str], num_processes: int,
                     process_id: int, device: DeviceLike = None,
                     store=None):
    """Join (or found) the run's process group as rank ``process_id`` of
    ``num_processes``; returns ``(backend, device)``.

    coordinator:   "host:port" of rank 0's TCP store (every rank passes
                   the same address); None only for a one-rank group.
    device:        this rank's device: "cpu", "cuda:<i>", or None or
                   "cuda" for ``place_ranks``'s rule (the next card of
                   this host, else the CPU; "cuda" raises without one).
    store:         a ``torch.distributed`` store to meet in instead of the
                   coordinator's (a ``FileStore`` on one host).

    The ranks first publish their host, the device asked for and their
    host's card count in the store; each places every rank
    (``place_ranks``) and takes the backend from that topology
    (``choose_backend``), so every rank picks the same one. The choice
    is logged; nothing retries another backend when one fails."""
    import datetime
    import json
    import socket

    import torch.distributed as dist

    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} out of range for "
                         f"num_processes={num_processes}")
    if device is not None and str(device) == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("init_distributed(device='cuda'): no CUDA "
                           "device is available")
    if store is None:
        if coordinator is not None:
            host, port = coordinator.rsplit(":", 1)
            store = dist.TCPStore(host, int(port), num_processes,
                                  process_id == 0,
                                  timeout=datetime.timedelta(minutes=30))
        elif num_processes == 1:
            store = dist.HashStore()
        else:
            raise ValueError("a group of more than one rank needs the "
                             "coordinator's host:port (or a store)")
    store.set(f"topology/{process_id}", json.dumps({
        "host": socket.gethostname(),
        "device": None if device is None else str(device),
        "cards": torch.cuda.device_count() if torch.cuda.is_available()
        else 0}))
    ranks = [json.loads(store.get(f"topology/{r}"))
             for r in range(num_processes)]
    devices = place_ranks(ranks)
    backend = choose_backend([r["host"] for r in ranks], devices)
    dev = torch.device(devices[process_id])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    logger.info("init_distributed: rank %d of %d on %s, backend %s",
                process_id, num_processes, dev, backend)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)
    _RANK["device"] = dev
    return backend, dev


# -- collectives ---------------------------------------------------------------

#: collective calls made, counted in Python, with their bytes (each
#: call's result, the JAX dry run's convention): a captured round makes
#: its calls once, while it is captured, and none at its replays
CALLS = {"all_reduce": 0, "all_reduce_bytes": 0}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place across ``group`` (SUM, MIN or MAX); no
    call without a group."""
    if group is None:
        return t
    import torch.distributed as dist
    CALLS["all_reduce"] += 1
    CALLS["all_reduce_bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "min": dist.ReduceOp.MIN,
                           "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def gather_rows(t: torch.Tensor, group, index: int, size: int):
    """Every rank's ``t`` stacked in rank order, ``(size, *t.shape)``:
    each rank writes its rows into zeros at its ``index`` and the buffer
    is summed, one ``all_reduce`` (gloo takes no all-gather of CUDA
    tensors). Exact for integers, and for floats (the other ranks add
    zeros)."""
    out = torch.zeros((size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    out[index].copy_(t)
    return all_reduce(out, group)


# -- shards of the model axis ---------------------------------------------------

#: the model group's collectives, counted in Python by kind: the
#: activations' all-reduces (``copy_to_model``'s backward,
#: ``reduce_from_model``'s forward, the vocab-parallel cross entropy's
#: sums and maxima), the leaves' gathers, and the gathers of a layer's
#: output rows (the ``seqpar`` attention's), each with its bytes
MODEL_CALLS = {"activation": 0, "activation_bytes": 0, "gather": 0,
               "gather_bytes": 0, "rows": 0, "rows_bytes": 0}
#: the batch groups' collectives, counted alike: FSDP's gathers of a
#: leaf's data parts, a MoE block's gathers of the batch's rows
#: (``BatchRows.all_rows``), the gradients' sums of both, and the
#: ``moe2d`` experts' activations (their partial products summed over
#: ``data``, forward and back, and their outputs gathered)
DATA_CALLS = {"gather": 0, "gather_bytes": 0, "grad": 0, "grad_bytes": 0,
              "rows": 0, "rows_bytes": 0, "activation": 0,
              "activation_bytes": 0}
#: the production decode step's merges of the attention partials over the
#: ranks that hold a cache's sequence (``models/attention.py::
#: merge_partials``): its maxima and its sums of weighted outputs
MERGE_CALLS = {"max": 0, "max_bytes": 0, "sum": 0, "sum_bytes": 0}


def _count(kind: str, t: torch.Tensor, calls=MODEL_CALLS) -> None:
    calls[kind] += 1
    calls[kind + "_bytes"] += t.numel() * t.element_size()


def split_dim(spec) -> Optional[int]:
    """The dim a leaf's spec splits over the ``model`` axis, or None (a
    replicated leaf). Another axis, or two split dims, raises: on the
    2-D route only ``model`` splits a leaf."""
    dims = [i for i, ax in enumerate(spec) if ax is not None]
    for i in dims:
        if spec[i] != "model" and spec[i] != ("model",):
            raise ValueError(f"spec {spec}: on the ('clients', 'model') "
                             f"route a leaf splits over 'model' only")
    if len(dims) > 1:
        raise ValueError(f"spec {spec} splits more than one dim")
    return dims[0] if dims else None


def local_shape(shape, spec, parts: int) -> Tuple[int, ...]:
    """The shape of one rank's shard of a leaf of ``shape``."""
    shape = list(shape)
    d = split_dim(spec)
    if d is not None:
        shape[d] //= parts
    return tuple(shape)


def shard_of(full, spec, parts: int, index: int, batch_dims: int = 0):
    """Rank ``index``'s shard of a whole leaf (a view, for a tensor or a
    NumPy array); ``batch_dims`` leading dims (a cohort's) come first."""
    d = split_dim(spec)
    if d is None:
        return full
    d += batch_dims
    n = full.shape[d] // parts
    at = [slice(None)] * len(full.shape)
    at[d] = slice(index * n, (index + 1) * n)
    return full[tuple(at)]


def gather(local: torch.Tensor, spec, group, parts: int, index: int,
           batch_dims: int = 0) -> torch.Tensor:
    """The whole leaf from every rank's shard of it, on every rank of
    ``group``: each rank writes its shard into zeros and the bytes are
    summed, one ``all_reduce`` of uint8 (exact: every byte but one of
    each sum is 0). Not differentiable (``ModelShards.gather`` is)."""
    d = split_dim(spec)
    if d is None or group is None:
        return local
    return _gather_along(local, d + batch_dims, group, parts, index,
                         MODEL_CALLS)


def _gather_along(local, d, group, parts, index, calls, kind="gather"):
    """``gather`` along dim ``d``, counted in ``calls[kind]``."""
    shape = list(local.shape)
    n = shape[d]
    shape[d] = n * parts
    out = torch.zeros(shape, dtype=local.dtype, device=local.device)
    out.narrow(d, index * n, n).copy_(local)
    calls[kind] += 1
    calls[kind + "_bytes"] += out.numel() * out.element_size()
    all_reduce(out.view(-1).view(torch.uint8), group)
    return out


class _Gather(torch.autograd.Function):
    """``gather`` forward; backward, the gradient's slice of this rank:
    every rank of the model group computes on the same data, so each
    holds the whole gradient already (summing would scale it by M).
    ``kind``: the ``MODEL_CALLS`` entry it counts in (a leaf's
    ``gather``, or a layer's output ``rows``)."""

    @staticmethod
    def forward(ctx, local, d, group, parts, index, kind="gather"):
        ctx.at = (d, index, local.shape[d])
        return _gather_along(local, d, group, parts, index, MODEL_CALLS,
                             kind)

    @staticmethod
    def backward(ctx, g):
        d, index, n = ctx.at
        return g.narrow(d, index * n, n), None, None, None, None, None


class _GatherData(torch.autograd.Function):
    """A gather over a batch group (``data``, or ``pod`` for
    ``BatchRows.all_rows``): forward, the whole from every rank's part
    (``_gather_along``: FSDP's model shard of a leaf, counted as a
    ``gather``; the batch's ``rows``; the ``moe2d`` experts' outputs, an
    ``activation``); backward, the gradient summed over the group in
    fp32 (each rank computed it from its own rows of the batch) and this
    rank's slice of the sum, in the gradient's dtype."""

    @staticmethod
    def forward(ctx, local, d, group, parts, index, kind="gather"):
        ctx.at = (d, group, index, local.shape[d])
        return _gather_along(local, d, group, parts, index, DATA_CALLS,
                             kind)

    @staticmethod
    def backward(ctx, g):
        d, group, index, n = ctx.at
        s = torch.empty(g.shape, dtype=torch.float32, device=g.device)
        s.copy_(g)
        DATA_CALLS["grad"] += 1
        DATA_CALLS["grad_bytes"] += s.numel() * s.element_size()
        all_reduce(s, group)
        return (s.narrow(d, index * n, n).to(g.dtype), None, None, None,
                None, None)


class _SumOverData(torch.autograd.Function):
    """Partial products summed over a data group in fp32 and cast to
    ``dtype``, forward and back: each data rank contracted its slice of
    a dim split on ``data``, and each uses the sum for its own rows of
    the batch, so the gradient that comes back is partial too (the
    ``moe2d`` experts' gate and up products). Counted as an
    ``activation`` of ``DATA_CALLS``."""

    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.group, ctx.dtype = group, x.dtype
        s = _wide(x)
        _count("activation", s, DATA_CALLS)
        return all_reduce(s, group).to(dtype)

    @staticmethod
    def backward(ctx, g):
        s = _wide(g)
        _count("activation", s, DATA_CALLS)
        return all_reduce(s, ctx.group).to(ctx.dtype), None, None


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A private fp32 copy of a 16-bit float tensor (a 32- or 64-bit one
    as it is, copied): what the model group sums, once rounded."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t.clone()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the model
    group (in fp32): the input feeds this rank's part of a
    column-parallel product, whose gradient is a partial sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = _wide(g)
        _count("activation", s)
        return all_reduce(s, ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward, the partial results summed over the model group in fp32
    and cast to ``dtype``; backward, the identity (every rank's
    downstream is the same)."""

    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.dtype = x.dtype
        s = _wide(x)
        _count("activation", s)
        return all_reduce(s, group).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the input of a column-parallel product (see
    ``_CopyToModel``); the identity without a group."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group, dtype=None) -> torch.Tensor:
    """The partial products ``x`` summed over the model group in fp32,
    then cast to ``dtype`` (default x's); see ``_ReduceFromModel``."""
    dtype = x.dtype if dtype is None else dtype
    if group is None:
        return x.to(dtype)
    return _ReduceFromModel.apply(x, group, dtype)


def max_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s elementwise maximum over the model group (no gradient)."""
    if group is None:
        return x
    s = x.detach().clone()
    _count("activation", s)
    return all_reduce(s, group, "max")


def axis_dim(spec, axis: str) -> Optional[int]:
    """The dim a spec splits over ``axis``, or None; two such dims
    raise."""
    dims = [i for i, ax in enumerate(spec) if ax in (axis, (axis,))]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} splits more than one dim over "
                         f"{axis!r}")
    return dims[0] if dims else None


class BatchRows:
    """A step's rows of the batch over a mesh's batch axes (``pod`` and
    ``data``), and the mesh levers in force for it
    (``runtime/flags.py::mesh_levers``). ``batch_axes`` are the axes of
    more than one rank that this step's batch is split over
    (``with_batch``); ``batch_ranks`` the ranks of every batch axis, the
    JAX package's ``moelocal`` group count.

    The ``--mesh data`` step installs one for the thread that computes
    (``shardctx.batch_rows_scope``); on a production mesh
    ``ModelShards`` is one. Where a layer mixes the rows (the MoE
    dispatch's capacity and aux loss), ``all_rows`` gives it every batch
    rank's rows and ``own_rows`` takes this rank's back."""

    def __init__(self, mesh):
        self._rows = {ax: (mesh.group(ax), mesh.shape[ax],
                           mesh.coordinate(ax)) for ax in ("pod", "data")
                      if mesh.shape.get(ax, 1) > 1}
        self.batch_ranks = math.prod(mesh.shape.get(ax, 1)
                                     for ax in ("pod", "data"))
        self.batch_axes: Tuple[str, ...] = ()
        self.levers: frozenset = frozenset()

    def with_batch(self, axes):
        """These rows for a step whose batch rows are split over ``axes``
        (``token_spec``'s batch axes, or None), under the mesh levers of
        the calling thread, read now."""
        from repro_torch.runtime.flags import mesh_levers
        out = copy.copy(self)
        out.batch_axes = tuple(ax for ax in (axes or ()) if ax in self._rows)
        out.levers = mesh_levers()
        return out

    def moe_groups(self, tokens: int) -> int:
        """The token groups a MoE block dispatches alone: under the
        ``moelocal`` lever the batch ranks, where they divide the
        whole batch's tokens (``tokens``, this rank's B S, times the
        ranks its rows split over); else 1."""
        g = self.batch_ranks
        for ax in self.batch_axes:
            tokens *= self._rows[ax][1]
        return g if "moelocal" in self.levers and g > 1 and \
            tokens % g == 0 else 1

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (this rank's rows of the batch, dim 0) with every batch
        rank's rows, in the batch's order, differentiably: where a layer
        mixes the rows (the MoE dispatch's capacity and aux loss), it
        sees the whole batch as the JAX package's step does. The backward
        sums each rank's gradient over the batch ranks (``_GatherData``):
        every rank then holds the whole batch's gradient of its rows, which
        the step's mean over the batch ranks divides as it does the
        others (so a term every rank computes whole, the aux loss, counts
        once)."""
        for ax in reversed(self.batch_axes):            # data, then pod
            group, parts, index = self._rows[ax]
            x = _GatherData.apply(x, 0, group, parts, index, "rows")
        return x

    def own_rows(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's ``n`` rows of a whole batch's ``y`` (dim 0)."""
        i = 0
        for ax in self.batch_axes:
            _, parts, index = self._rows[ax]
            i = i * parts + index
        return y[i * n:(i + 1) * n]


class ModelShards(BatchRows):
    """This rank's part of a params tree split over a mesh's ``model``
    axis and, on the production mesh, its ``data`` axis: for each leaf
    (by its name in a ``bridge`` layout: a path tuple of a nested tree, a
    key of a flat one) the dim its spec splits over each, if any, and the
    whole leaf's shape. ``group`` is the model group, ``parts`` its size,
    ``index`` this rank's coordinate on it; ``data_group``,
    ``data_parts`` and ``data_index`` the same for ``data`` (None, 1 and
    0 on a mesh without it, or of one data rank).

    ``local`` and ``gather`` map a whole leaf to this rank's shard and
    back; ``model_part`` gathers only a leaf's data parts (FSDP), giving
    this rank's shard of it on ``model``, where a tensor-parallel layer
    uses it; ``gathered(sub, prefix)`` gathers, at its use, every split
    leaf of a sub-tree (differentiably), where a layer has no
    tensor-parallel form. A gather's gradient is this rank's slice of it:
    over ``model`` as it comes (every rank of a model group computes on
    the same rows), over ``data`` summed across the data group first
    (``_GatherData``)."""

    def __init__(self, specs: Dict[Any, Tuple], shapes: Dict[Any, Tuple],
                 mesh):
        self.specs = dict(specs)
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        for s in self.specs.values():
            if any(ax not in (None, "model", "data", ("model",), ("data",))
                   for ax in s):
                raise ValueError(f"spec {s}: a leaf splits over 'model' "
                                 f"and 'data' only")
        self.dims = {k: axis_dim(s, "model") for k, s in self.specs.items()}
        self.data_dims = {k: axis_dim(s, "data")
                          for k, s in self.specs.items()}
        self.group = mesh.group("model")
        self.parts = mesh.shape["model"]
        self.index = mesh.coordinate("model")
        self.data_parts = mesh.shape.get("data", 1)
        many = self.data_parts > 1
        self.data_group = mesh.group("data") if many else None
        self.data_index = mesh.coordinate("data") if many else 0
        BatchRows.__init__(self, mesh)
        # the decode cache's shards (``with_cache``), for a decode step
        self.cache: Optional["CacheShards"] = None

    @classmethod
    def of(cls, partitioner: "ModelPartitioner", named_shapes, mesh):
        """The shards of a tree given as ``{name: whole shape}`` under
        ``partitioner``'s rules on ``mesh``."""
        specs = {k: partitioner.spec(k, shape, mesh)
                 for k, shape in named_shapes.items()}
        return cls(specs, named_shapes, mesh)

    @classmethod
    def of_model(cls, model, mesh):
        """An LM's shards on a production mesh, each leaf's spec decided
        on the JAX package's layout (``layout_specs``)."""
        from repro_torch.bridge import tree_leaves
        shapes = {path: tuple(shape) for path, (shape, _) in
                  tree_leaves(model.param_shapes())}
        return cls(layout_specs(shapes, model.jax_layout, mesh), shapes,
                   mesh)

    def dim(self, name) -> Optional[int]:
        return self.dims.get(name)

    def local_shape(self, name) -> Tuple[int, ...]:
        shape = list(self.shapes[name])
        for d, parts in ((self.dims.get(name), self.parts),
                         (self.data_dims.get(name), self.data_parts)):
            if d is not None:
                shape[d] //= parts
        return tuple(shape)

    def local(self, name, full, batch_dims: int = 0):
        """This rank's shard of the whole leaf ``full``."""
        out = full
        for d, parts, index in (
                (self.dims.get(name), self.parts, self.index),
                (self.data_dims.get(name), self.data_parts,
                 self.data_index)):
            if d is not None:
                d += batch_dims
                n = out.shape[d] // parts
                at = [slice(None)] * len(out.shape)
                at[d] = slice(index * n, (index + 1) * n)
                out = out[tuple(at)]
        return out

    def model_part(self, name, local: torch.Tensor, batch_dims: int = 0):
        """This rank's shard of the leaf on ``model`` (its data parts
        gathered), differentiably."""
        d = self.data_dims.get(name)
        if d is None or self.data_group is None:
            return local
        return _GatherData.apply(local, d + batch_dims, self.data_group,
                                 self.data_parts, self.data_index)

    def gather(self, name, local: torch.Tensor, batch_dims: int = 0):
        """The whole leaf from this rank's shard, differentiably (the
        gradient comes back as this rank's slice of it)."""
        part = self.model_part(name, local, batch_dims)
        d = self.dims.get(name)
        if d is None or self.group is None:
            return part
        return _Gather.apply(part, d + batch_dims, self.group, self.parts,
                             self.index)

    def gather_exact(self, name, local: torch.Tensor, batch_dims: int = 0):
        """``gather`` outside autograd (snapshots, results)."""
        d = self.data_dims.get(name)
        if d is not None and self.data_group is not None:
            local = _gather_along(local, d + batch_dims, self.data_group,
                                  self.data_parts, self.data_index,
                                  DATA_CALLS)
        d = self.dims.get(name)
        if d is None or self.group is None:
            return local
        return _gather_along(local, d + batch_dims, self.group, self.parts,
                             self.index, MODEL_CALLS)

    def gather_model(self, t: torch.Tensor, d: int) -> torch.Tensor:
        """An activation split over the model group along dim ``d`` (each
        rank's heads, or its vocab columns) made whole on every rank,
        exactly (a zero-padded ``all_reduce``), outside autograd."""
        if self.group is None:
            return t
        return _gather_along(t, d, self.group, self.parts, self.index,
                             MODEL_CALLS)

    def gathered(self, sub, prefix: Tuple = (), keep=(), local=()):
        """``sub`` (a dict or list sub-tree at path ``prefix``) with every
        split leaf gathered but those whose relative path is in ``keep``
        (tuples of keys), which get their ``model_part``, and those in
        ``local``, left as this rank's shards."""
        def under(paths, k):
            return [p[1:] for p in paths if p[:1] == (k,)]
        if isinstance(sub, dict):
            return {k: self.gathered(v, prefix + (k,), under(keep, k),
                                     under(local, k))
                    for k, v in sub.items()}
        if isinstance(sub, list):
            return [self.gathered(v, prefix + (i,), under(keep, i),
                                  under(local, i))
                    for i, v in enumerate(sub)]
        if () in local:
            return sub
        if () in keep:
            return self.model_part(prefix, sub)
        return self.gather(prefix, sub)

    def gather_summed(self, name, local: torch.Tensor) -> torch.Tensor:
        """``gather``, for a layer whose model ranks each compute a part
        of its work (their query rows, or their heads of K and V): the
        gradient is summed over the model group before this rank keeps
        its slice (``copy_to_model`` on the whole leaf)."""
        return copy_to_model(self.gather(name, local), self.group)

    def sum_over_data(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """``x``'s partial sums over the data group (``_SumOverData``),
        cast to ``dtype``; the cast alone without one."""
        if self.data_group is None:
            return x.to(dtype)
        return _SumOverData.apply(x, self.data_group, dtype)

    def gather_data(self, t: torch.Tensor, d: int) -> torch.Tensor:
        """An activation split over the data group along dim ``d`` made
        whole, differentiably (``_GatherData``: its gradient summed over
        the group), counted as an ``activation``."""
        if self.data_group is None:
            return t
        return _GatherData.apply(t, d, self.data_group, self.data_parts,
                                 self.data_index, "activation")

    def gather_rows(self, t: torch.Tensor, d: int) -> torch.Tensor:
        """A layer's output split over the model group along dim ``d``
        (each rank's query rows) made whole on every rank, differentiably
        (the gradient's slice comes back), counted as ``rows``."""
        if self.group is None:
            return t
        return _Gather.apply(t, d, self.group, self.parts, self.index,
                             "rows")

    def all_split(self, prefix: Tuple, dims: Dict[str, int]) -> bool:
        """Whether each leaf ``prefix + (name,)`` of ``dims`` is split on
        the dim given over ``model`` (the layout a tensor-parallel layer
        needs)."""
        return all(self.dims.get(prefix + (k,)) == d
                   for k, d in dims.items())

    def with_cache(self, cache: "CacheShards") -> "ModelShards":
        """These shards for a decode step on this rank's part of a cache
        split by ``cache`` (a ``CacheShards``)."""
        out = copy.copy(self)
        out.cache = cache
        return out

    def batch_mean(self, mesh, layout):
        """The production step's sums over the batch ranks for a
        ``bridge.GroupedLayout`` of this rank's shards whose groups list
        the leaves kept whole on ``data`` first (``fsdp_layout``)."""
        counts = tuple(sum(math.prod(s) for k, s in zip(g.names, g.shapes)
                           if self.data_dims.get(k) is None)
                       for g in layout.groups)
        return BatchMean(mesh, counts)

    def fsdp_layout(self, layout):
        """``layout`` (a ``bridge.GroupedLayout`` of this rank's shards)
        with each group's leaves kept whole on ``data`` first, then those
        split on it, each part in its order."""
        groups = []
        for g in layout.groups:
            order = sorted(range(len(g.names)), key=lambda i: (
                self.data_dims.get(g.names[i]) is not None, i))
            groups.append(dataclasses.replace(
                g, names=tuple(g.names[i] for i in order),
                shapes=tuple(g.shapes[i] for i in order)))
        return dataclasses.replace(layout, groups=tuple(groups))


class BatchMean:
    """The production step's mean over its batch ranks (the ranks of
    ``pod`` x ``data``, each with its rows of a microbatch): ``grads``
    turns each rank's gradient buffers (one a dtype group, the leaves
    kept whole on ``data`` first, ``whole`` elements of each) into the
    whole microbatch's mean in place. A leaf split on ``data`` has its
    data ranks' sum already, this rank's slice of it, from its gather's
    backward (``_GatherData``); so only the whole leaves are summed over
    ``data``, then every leaf over ``pod`` (which replicates phi), in
    fp32, and divided by the batch ranks. ``losses`` averages the
    losses alike."""

    def __init__(self, mesh, whole: Tuple[int, ...]):
        def group(ax):
            return mesh.group(ax) if mesh.shape.get(ax, 1) > 1 else None
        self.data, self.pod = group("data"), group("pod")
        self.ranks = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        self.whole = whole

    def grads(self, bufs) -> None:
        for g, n in zip(bufs, self.whole):
            s = g.float() if g.dtype != torch.float32 else g
            if n:
                all_reduce(s[:n], self.data)
            all_reduce(s, self.pod)
            s.div_(self.ranks)
            if s is not g:
                g.copy_(s)

    def losses(self, t: torch.Tensor) -> torch.Tensor:
        all_reduce(t, self.data)
        all_reduce(t, self.pod)
        return t.div_(self.ranks)


@dataclasses.dataclass(frozen=True)
class SeqSlice:
    """This rank's slice of a KV cache split on its sequence: its first
    global row ``offset``, the whole cache's ``rows``, and the process
    groups to merge the slices' attention over, one a mesh axis the
    sequence splits over (of more than one rank), in the spec's order."""
    offset: int
    rows: int
    groups: Tuple[Any, ...]


def _spec_axes(entry) -> Tuple[str, ...]:
    """A spec entry (None, an axis name, or a tuple of names) as a tuple
    of names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class CacheShards:
    """This rank's part of an LM's decode cache on a production mesh: for
    each leaf (by its port path) its spec, as the JAX package's
    ``attn_cache_spec`` and ``mamba_cache_spec`` split it, decided on the
    JAX layout's leaf (``jax_layout_specs``, as ``launch/specs.py``'s
    ``decode_batch_specs`` decides it), its whole shape and its dtype.

    An attention leaf (B, S, Kv, hd) splits its batch over (``pod``,
    ``data``) where they divide it and its sequence over the axes left
    (``model``, and the batch axes where they do not divide the batch); a
    Mamba2 ``ssm`` state (B, H, P, N) its batch alike and its heads over
    ``model``; a ``conv`` window its batch only. A dim split over several
    axes is cut as ``runtime/steps.py::batch_rows`` cuts rows: the index
    runs over the axes in order, the last fastest.

    ``init`` builds this rank's cache only (zeros, or ``meta``), never
    the whole; ``local`` cuts a whole leaf (a tensor or a NumPy array)
    into this rank's part, along some of its dims or all, and ``gather``
    makes a leaf whole along them (a collective every rank calls);
    ``seq`` gives an attention leaf's ``SeqSlice`` (None where its
    sequence is whole: it is attended whole and not merged)."""

    def __init__(self, specs: Dict[Any, Tuple], shapes: Dict[Any, Tuple],
                 dtypes: Dict[Any, torch.dtype], mesh):
        self.specs = dict(specs)
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.dtypes = dict(dtypes)
        self.mesh = mesh

    @classmethod
    def of_model(cls, model, mesh, batch_size: int, seq_len: int):
        """The cache of ``model.init_cache(batch_size, seq_len)`` (read
        under the calling thread's levers: ``ringkv`` sizes the rings) on
        ``mesh``."""
        from repro_torch.bridge import tree_leaves
        cache = model.init_cache(batch_size, seq_len, device="meta")
        leaves = dict(tree_leaves(cache))
        shapes = {k: tuple(v.shape) for k, v in leaves.items()}
        _, specs = jax_layout_specs(shapes, model.jax_layout,
                                    cache_rule(mesh, batch_size), cache=True)
        return cls(specs, shapes, {k: v.dtype for k, v in leaves.items()},
                   mesh)

    def _cut(self, axes) -> Tuple[int, int]:
        """(parts, this rank's index) of a dim split over ``axes``."""
        n, i = 1, 0
        for ax in axes:
            size = self.mesh.shape[ax]
            n, i = n * size, i * size + self.mesh.coordinate(ax)
        return n, i

    def local_shape(self, name) -> Tuple[int, ...]:
        return tuple(dim // self._cut(_spec_axes(ax))[0]
                     for dim, ax in zip(self.shapes[name], self.specs[name]))

    def local(self, name, whole, dims=None):
        """This rank's part of the whole leaf ``whole`` along ``dims``
        (default every split dim): a view, of a tensor or a NumPy
        array."""
        at = [slice(None)] * len(whole.shape)
        for d, ax in enumerate(self.specs[name]):
            if dims is not None and d not in dims:
                continue
            n, i = self._cut(_spec_axes(ax))
            rows = whole.shape[d] // n
            at[d] = slice(i * rows, (i + 1) * rows)
        return whole[tuple(at)]

    def gather(self, name, local: torch.Tensor, dims=None) -> torch.Tensor:
        """The leaf made whole along ``dims`` (default every split dim)
        from every rank's part: a zero-padded ``all_reduce`` of its bytes a
        mesh axis, the last axis of a dim first (exact)."""
        for d, ax in enumerate(self.specs[name]):
            if dims is not None and d not in dims:
                continue
            for a in reversed(_spec_axes(ax)):
                if self.mesh.shape[a] > 1:
                    local = _gather_along(
                        local, d, self.mesh.group(a), self.mesh.shape[a],
                        self.mesh.coordinate(a),
                        MODEL_CALLS if a == "model" else DATA_CALLS)
        return local

    def seq(self, name) -> Optional[SeqSlice]:
        """The ``SeqSlice`` of an attention leaf (B, S, Kv, hd), or None
        where its sequence is whole."""
        axes = _spec_axes(self.specs[name][1])
        if not axes:
            return None
        n, i = self._cut(axes)
        rows = self.shapes[name][1]
        return SeqSlice(i * (rows // n), rows, tuple(
            self.mesh.group(ax) for ax in axes if self.mesh.shape[ax] > 1))

    def init(self, device: DeviceLike = None):
        """This rank's cache, zeros, on ``device`` (``"meta"`` for its
        shapes alone), in the model's cache tree."""
        from repro_torch.bridge import unflatten_tree
        from repro_torch.device import resolve_device
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        return unflatten_tree({
            k: torch.zeros(self.local_shape(k), dtype=self.dtypes[k],
                           device=dev) for k in self.specs})



@dataclasses.dataclass(frozen=True)
class LocalShards:
    """An init that never exists whole on a rank: ``tree``, this rank's
    shard of every leaf (tensors, in the params tree's structure), and
    ``shapes``, each leaf's whole shape by its name in a ``bridge``
    layout (a path tuple of a nested tree). ``run_federated`` on a 2-D
    mesh takes it in place of the whole tree (the shards as its
    partitioner cuts them)."""
    tree: Any
    shapes: Dict[Any, Tuple[int, ...]]


def active_model_shards() -> Optional[ModelShards]:
    """The calling thread's ``ModelShards`` while a 2-D run computes, or
    None (no 2-D run, or a model extent of 1)."""
    from repro_torch.runtime import shardctx
    return shardctx.current_model_shards()


# -- partitioners ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelPartitioner:
    """Per-architecture rules for the model axis: ``rules(path, shape,
    mesh)`` maps one param leaf to its spec. Identity (equality, hash,
    the checkpoint fingerprint) is the ``name`` alone."""
    name: str
    # None -> the shared default rules (param_spec)
    rules: Callable[[str, Tuple[int, ...], Any], Tuple] = dataclasses.field(
        default=None, compare=False)

    def _rules(self):
        return param_spec if self.rules is None else self.rules

    def spec(self, path, shape: Tuple[int, ...], mesh) -> Tuple:
        """Spec of one leaf; ``path`` is an "a/b/c" string or a tuple of
        keys."""
        if not isinstance(path, str):
            path = "/".join(str(p) for p in path)
        return self._rules()(path, tuple(shape), mesh)

    def shardings(self, params, mesh):
        """The spec of every leaf of ``params``, in its structure."""
        from repro_torch.bridge import flatten_tree, unflatten_tree
        return unflatten_tree({
            path: self.spec(path, tuple(leaf.shape), mesh)
            for path, leaf in flatten_tree(params).items()})


_PARTITIONERS: Dict[str, ModelPartitioner] = {}


def register_partitioner(name: str, rules=None) -> ModelPartitioner:
    """Register (or fetch, when rules is None and it exists) a
    ``ModelPartitioner``; registering a name again with other rules
    raises."""
    if rules is None:
        rules = param_spec
    existing = _PARTITIONERS.get(name)
    if existing is not None:
        if existing.rules is not rules:
            raise ValueError(f"partitioner {name!r} already registered "
                             "with different rules")
        return existing
    p = ModelPartitioner(name=name, rules=rules)
    _PARTITIONERS[name] = p
    return p


def partitioner_for(arch: str) -> ModelPartitioner:
    """The registered partitioner of an architecture family name."""
    if arch in _PARTITIONERS:
        return _PARTITIONERS[arch]
    raise KeyError(f"no ModelPartitioner registered for {arch!r}; "
                   f"known: {sorted(_PARTITIONERS)} "
                   "(register_partitioner(name, rules) adds one)")


def per_device_param_bytes(params) -> int:
    """Parameter bytes on this rank: each leaf's local tensor (on the
    2-D route, this rank's shard; a DTensor's local shard; any other
    tensor whole)."""
    from repro_torch.bridge import tree_leaves
    total = 0
    for _, leaf in tree_leaves(params):
        local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        total += local.numel() * local.element_size()
    return total


# -- the rules ------------------------------------------------------------------

def _axes(mesh):
    names = mesh.axis_names
    batch = tuple(a for a in ("pod", "data") if a in names)
    return batch, ("model" if "model" in names else None)


def _size(mesh, ax):
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        s = 1
        for a in ax:
            s *= mesh.shape[a]
        return s
    return mesh.shape[ax]


def _fits(dim, mesh, ax):
    return ax is not None and dim % _size(mesh, ax) == 0


_BASE_RANK = {
    "embed": 2, "lm_head": 2, "vision_proj": 2, "final_norm": 1,
    "wq": 3, "wk": 3, "wv": 3, "wo": 3,
    "router": 2, "w_in": 2, "w_out": 2, "b_in": 1, "b_out": 1,
    "w_z": 2, "w_x": 2, "w_B": 2, "w_C": 2, "w_dt": 2,
    "dt_bias": 1, "A_log": 1, "D": 1, "conv_w": 2, "conv_b": 1,
    "gate_norm": 1, "norm1": 1, "norm2": 1, "norm_x": 1,
}


def _base_rank(path: str, leaf: str) -> int:
    if leaf in ("w_gate", "w_up", "w_down"):
        return 3 if "/moe/" in "/" + path + "/" and "shared" not in path else 2
    if leaf == "w_out" and "mamba" in path:
        return 2
    return _BASE_RANK.get(leaf, 2)


def param_spec(path: str, shape: Tuple[int, ...], mesh) -> Tuple:
    """The spec of one parameter leaf."""
    from repro_torch.runtime.flags import feature

    _, model_ax = _axes(mesh)
    data_ax = "data" if "data" in mesh.axis_names else None
    leaf = path.rsplit("/", 1)[-1]
    base = _base_rank(path, leaf)
    if len(shape) < base:              # malformed or unknown leaf
        return (None,) * len(shape)
    off = len(shape) - base            # scan stacks carry leading dims
    dims = list(shape[off:])
    spec = [None] * len(shape)

    def assign(rel, ax):
        spec[off + rel] = ax

    def first_fit(*cands):
        for rel, ax in cands:
            if _fits(dims[rel], mesh, ax):
                assign(rel, ax)
                return

    if len(dims) == 0 or model_ax is None:
        pass
    elif leaf == "embed":
        first_fit((0, model_ax))                        # vocab
    elif leaf == "lm_head":
        first_fit((1, model_ax))                        # vocab
    elif leaf in ("wq", "wk", "wv"):
        # (d, N, hd): heads -> head_dim -> the contraction
        first_fit((1, model_ax), (2, model_ax), (0, model_ax))
    elif leaf == "wo":                                  # (N, hd, d)
        first_fit((0, model_ax), (1, model_ax), (2, model_ax))
    elif leaf in ("w_gate", "w_up", "w_down") and len(dims) == 3:
        # MoE experts (E, d, f) / (E, f, d)
        up = leaf != "w_down"
        if feature("moe2d") and not _fits(dims[0], mesh, model_ax):
            # stationary 2-D sharding: d on data, f on model
            d_rel, f_rel = (1, 2) if up else (2, 1)
            if _fits(dims[d_rel], mesh, data_ax):
                assign(d_rel, data_ax)
            if _fits(dims[f_rel], mesh, model_ax):
                assign(f_rel, model_ax)
            return tuple(spec)
        first_fit((0, model_ax), (2 if up else 1, model_ax))
    elif leaf in ("w_gate", "w_up"):                    # dense (d, f)
        first_fit((1, model_ax))
    elif leaf == "w_down":                              # (f, d)
        first_fit((0, model_ax))
    elif leaf == "w_out":
        first_fit((0, model_ax))
    elif leaf in ("w_in", "w_z", "w_x", "w_B", "w_C", "w_dt", "conv_w",
                  "vision_proj"):
        first_fit((1, model_ax))
    # norms, biases, router, A_log, D, dt_bias, conv_b: replicated

    # FSDP: one more (unassigned, divisible) dim on data
    if data_ax is not None:
        itemsize = 2                   # bf16 dominant
        sharded = any(s is not None for s in spec)
        model_shards = _size(mesh, model_ax) if sharded else 1
        per_shard = int(np.prod(shape)) * itemsize // max(model_shards, 1)
        if per_shard > FSDP_THRESHOLD_BYTES:
            cands = [(dims[i], i) for i in range(len(dims))
                     if spec[off + i] is None
                     and _fits(dims[i], mesh, data_ax)]
            if cands:
                _, best = max(cands)
                assign(best, data_ax)
    return tuple(spec)


def jax_layout_specs(named_shapes, layout, rule, cache: bool = False):
    """A tree given as ``{port path: shape}`` (an LM's params, or with
    ``cache`` its decode cache) in the JAX package's ``layout``
    (``Model.jax_layout``; ``bridge.jax_layout_map``), each leaf's spec
    decided where the JAX package decides it: ``rule(JAX path, shape)``
    on the JAX leaf, whose scan stacks carry the layers along a leading
    dim (so the FSDP threshold reads the stacked leaf's bytes). Returns
    ``{"a/b/c": (shape, spec, a port path stacked into it)}`` and
    ``{port path: spec}``, each layer taking its stack's spec without
    the stack dim."""
    from repro_torch.bridge import jax_layout_map
    jax, port = {}, {}
    for jpath, (stacked, members) in jax_layout_map(
            list(named_shapes), layout, cache).items():
        shape = tuple(named_shapes[members[0]])
        if stacked:
            shape = (len(members),) + shape
        name = "/".join(map(str, jpath))
        spec = tuple(rule(name, shape))
        jax[name] = (shape, spec, members[0])
        for m in members:
            port[m] = spec[1:] if stacked else spec
    return jax, port


def layout_specs(named_shapes, layout, mesh):
    """``{port path: spec}`` of an LM's params given as ``{port path:
    shape}`` under ``param_spec`` on ``mesh``, decided on the JAX layout
    (``jax_layout_specs``)."""
    return jax_layout_specs(named_shapes, layout, lambda name, shape:
                            param_spec(name, shape, mesh))[1]


def param_shardings(params, mesh):
    """The spec of every leaf of ``params`` under the default rules."""
    return DEFAULT_PARTITIONER.shardings(params, mesh)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def token_spec(mesh, batch_size, extra_dims=1, leading=0) -> Tuple:
    """(batch, seq...) arrays: the batch on the batch axes when they
    divide it."""
    b_ax = batch_axes(mesh)
    ax = b_ax if b_ax and batch_size % _size(mesh, b_ax) == 0 else None
    return tuple([None] * leading + [ax] + [None] * extra_dims)


def attn_cache_spec(mesh, ndim, batch_size, seq_len) -> Tuple:
    """(..., B, S, Kv, hd): the batch on the batch axes when they divide
    it, the sequence on the axes left (context parallelism)."""
    b_ax = batch_axes(mesh)
    model_ax = "model" if "model" in mesh.axis_names else None
    spec = [None] * ndim
    b_i, s_i = ndim - 4, ndim - 3
    seq_axes = []
    if b_ax and batch_size % _size(mesh, b_ax) == 0:
        spec[b_i] = b_ax
    else:
        seq_axes.extend(b_ax)
    if model_ax:
        seq_axes.append(model_ax)
    seq_axes = tuple(seq_axes)
    if seq_axes and seq_len % _size(mesh, seq_axes) == 0:
        spec[s_i] = seq_axes
    return tuple(spec)


def cache_rule(mesh, batch_size):
    """The JAX package's spec of one decode-cache leaf, by its path and
    its (stacked) shape: ``rule(name, shape)``."""
    def rule(name, shape):
        leaf_name = name.rsplit("/", 1)[-1]
        if leaf_name in ("conv", "ssm"):
            base = 4 if leaf_name == "ssm" else 3
            off = len(shape) - base
            nh = shape[off + 1] if leaf_name == "ssm" else 0
            return mamba_cache_spec(mesh, leaf_name, len(shape), batch_size,
                                    nh)
        # attention k/v (self or cross): (..., B, S, Kv, hd)
        return attn_cache_spec(mesh, len(shape), batch_size,
                               shape[len(shape) - 3])
    return rule


def mamba_cache_spec(mesh, leaf_name, ndim, batch_size,
                     head_count) -> Tuple:
    """The SSM state (..., B, H, P, N) or the conv state (..., B, W, C)."""
    b_ax = batch_axes(mesh)
    model_ax = "model" if "model" in mesh.axis_names else None
    base = 4 if leaf_name == "ssm" else 3
    off = ndim - base
    spec = [None] * ndim
    if b_ax and batch_size % _size(mesh, b_ax) == 0:
        spec[off] = b_ax
    if (model_ax and leaf_name == "ssm"
            and head_count % _size(mesh, model_ax) == 0):
        spec[off + 1] = model_ax
    return tuple(spec)


DEFAULT_PARTITIONER = register_partitioner("default")
# the shipped families share one rule set (leaf names are the contract)
for _arch in ("transformer", "mamba2", "moe"):
    register_partitioner(_arch)
del _arch

