"""The ambient mesh, the port of the JAX package's ``runtime/shardctx.py``.

Models are mesh-agnostic; a step builder installs the active mesh here
(``mesh_context``) and a layer asks ``shard(x, *logical_axes)`` for its
placement. The logical axes are the JAX package's: "batch" -> every
data-parallel mesh axis of ("pod", "data"), "model" and "expert" -> the
tensor axis, "seq" and "fsdp" -> "data", None -> replicated.

The port runs one process per rank, each holding its own tensors: a
tensor sharded over a batch axis is already this rank's rows, and a
replicated one is the same on every rank. Under the 2-D ``("clients",
"model")`` route a tensor split over ``model`` is already this rank's
part too: its layers compute on their local heads and their local slice
of ``d_ff`` (``models/transformer.py``), with the model group's
all-reduces where the products need them. So ``shard`` returns its
input as it is on every mesh. ``spec`` returns the JAX package's
``PartitionSpec`` as a plain tuple, one entry per dim.

The engine's 2-D route also installs its ``runtime.sharding.ModelShards``
here for the thread that runs its rounds and evals
(``model_shards_scope``); the model code reads it with
``current_model_shards``.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def current_mesh():
    """The calling thread's mesh (any object with ``axis_names`` and a
    ``shape`` mapping), or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


@contextlib.contextmanager
def manual_axes(*axes):
    """Axes handled by hand (each rank computes its own part): left out
    of every resolution inside the scope."""
    prev = getattr(_state, "manual", ())
    _state.manual = tuple(set(prev) | set(axes))
    try:
        yield
    finally:
        _state.manual = prev


def _manual():
    return getattr(_state, "manual", ())


def resolve_axis(logical, mesh):
    names = tuple(a for a in mesh.axis_names if a not in _manual())
    if logical is None:
        return None
    if logical == "batch":
        ax = tuple(a for a in ("pod", "data") if a in names)
        return ax if ax else None
    if logical in ("model", "expert"):
        return "model" if "model" in names else None
    if logical in ("seq", "fsdp"):      # context-parallel / fsdp dim
        return "data" if "data" in names else None
    raise ValueError(f"unknown logical axis {logical!r}")


def spec(*logical):
    """The resolved axis (a name, a tuple of names, or None) of each dim
    under the current mesh, or None without one."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return tuple(resolve_axis(a, mesh) for a in logical)


def shard(x, *logical):
    """``x`` placed as the logical axes ask on the current mesh: each
    rank already holds its part (see the module's docstring), so ``x``
    itself. The axes are resolved all the same, so an unknown logical
    axis raises as in the JAX package."""
    mesh = current_mesh()
    if mesh is not None:
        for name in logical:
            resolve_axis(name, mesh)
    return x


def current_model_shards():
    """The calling thread's ``ModelShards`` (the 2-D route's), or None."""
    return getattr(_state, "model_shards", None)


@contextlib.contextmanager
def model_shards_scope(shards):
    """Install ``shards`` (a ``runtime.sharding.ModelShards``, or None)
    for the calling thread."""
    prev = current_model_shards()
    _state.model_shards = shards
    try:
        yield
    finally:
        _state.model_shards = prev
