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
"""
from __future__ import annotations

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

#: collective calls made, counted in Python: a captured round makes its
#: calls once, while it is captured, and none at its replays
CALLS = {"all_reduce": 0}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place across ``group`` (SUM, MIN or MAX); no
    call without a group."""
    if group is None:
        return t
    import torch.distributed as dist
    CALLS["all_reduce"] += 1
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
#: sums and maxima) and the leaves' gathers, each with its bytes
MODEL_CALLS = {"activation": 0, "activation_bytes": 0, "gather": 0,
               "gather_bytes": 0}


def _count(kind: str, t: torch.Tensor) -> None:
    MODEL_CALLS[kind] += 1
    MODEL_CALLS[kind + "_bytes"] += t.numel() * t.element_size()


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
    d += batch_dims
    shape = list(local.shape)
    n = shape[d]
    shape[d] = n * parts
    out = torch.zeros(shape, dtype=local.dtype, device=local.device)
    out.narrow(d, index * n, n).copy_(local)
    _count("gather", out)
    all_reduce(out.view(-1).view(torch.uint8), group)
    return out


class _Gather(torch.autograd.Function):
    """``gather`` forward; backward, the gradient's slice of this rank:
    every rank of the model group computes on the same data, so each
    holds the whole gradient already (summing would scale it by M)."""

    @staticmethod
    def forward(ctx, local, spec, group, parts, index, batch_dims):
        ctx.at = (split_dim(spec) + batch_dims, index, local.shape)
        return gather(local, spec, group, parts, index, batch_dims)

    @staticmethod
    def backward(ctx, g):
        d, index, shape = ctx.at
        n = shape[d]
        return g.narrow(d, index * n, n), None, None, None, None, None


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


class ModelShards:
    """This rank's part of a params tree split over a mesh's ``model``
    axis: for each leaf (by its name in a ``bridge`` layout: a path tuple
    of a nested tree, a key of a flat one) the dim its spec splits, if
    any, and the whole leaf's shape. ``group`` is the model group,
    ``parts`` its size, ``index`` this rank's coordinate on it.

    ``local`` and ``gather`` map a whole leaf to this rank's shard and
    back; ``gathered(sub, prefix)`` gathers, at its use, every split
    leaf of a sub-tree (differentiably), where a layer has no
    tensor-parallel form."""

    def __init__(self, specs: Dict[Any, Tuple], shapes: Dict[Any, Tuple],
                 mesh):
        self.specs = dict(specs)
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.dims = {k: split_dim(s) for k, s in self.specs.items()}
        self.group = mesh.group("model")
        self.parts = mesh.shape["model"]
        self.index = mesh.coordinate("model")

    @classmethod
    def of(cls, partitioner: "ModelPartitioner", named_shapes, mesh):
        """The shards of a tree given as ``{name: whole shape}`` under
        ``partitioner``'s rules on ``mesh``."""
        specs = {k: partitioner.spec(k, shape, mesh)
                 for k, shape in named_shapes.items()}
        return cls(specs, named_shapes, mesh)

    def dim(self, name) -> Optional[int]:
        return self.dims.get(name)

    def local_shape(self, name) -> Tuple[int, ...]:
        return local_shape(self.shapes[name], self.specs[name], self.parts)

    def local(self, name, full, batch_dims: int = 0):
        """This rank's shard of the whole leaf ``full``."""
        return shard_of(full, self.specs[name], self.parts, self.index,
                        batch_dims)

    def gather(self, name, local: torch.Tensor, batch_dims: int = 0):
        """The whole leaf from this rank's shard, differentiably (the
        gradient comes back as this rank's slice of it)."""
        if self.dims.get(name) is None:
            return local
        return _Gather.apply(local, self.specs[name], self.group,
                             self.parts, self.index, batch_dims)

    def gather_exact(self, name, local: torch.Tensor, batch_dims: int = 0):
        """``gather`` outside autograd (snapshots, results)."""
        return gather(local, self.specs[name], self.group, self.parts,
                      self.index, batch_dims)

    def gathered(self, sub, prefix: Tuple = (), keep=()):
        """``sub`` (a dict or list sub-tree at path ``prefix``) with every
        split leaf gathered but those whose relative path is in ``keep``
        (tuples of keys)."""
        if isinstance(sub, dict):
            return {k: self.gathered(v, prefix + (k,),
                                     [p[1:] for p in keep if p[:1] == (k,)])
                    for k, v in sub.items()}
        if isinstance(sub, list):
            return [self.gathered(v, prefix + (i,),
                                  [p[1:] for p in keep if p[:1] == (i,)])
                    for i, v in enumerate(sub)]
        if () in keep:
            return sub
        return self.gather(prefix, sub)

    def all_split(self, prefix: Tuple, dims: Dict[str, int]) -> bool:
        """Whether each leaf ``prefix + (name,)`` of ``dims`` is split on
        the dim given (the layout a tensor-parallel layer needs)."""
        return all(self.dims.get(prefix + (k,)) == d
                   for k, d in dims.items())


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

