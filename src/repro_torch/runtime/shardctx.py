"""The ambient mesh, the port of the JAX package's ``runtime/shardctx.py``.

Models are mesh-agnostic; a step builder installs the active mesh here
(``mesh_context``) and a layer asks ``shard(x, *logical_axes)`` for its
placement. The logical axes are the JAX package's: "batch" -> every
data-parallel mesh axis of ("pod", "data"), "model" and "expert" -> the
tensor axis, "seq" and "fsdp" -> "data", None -> replicated.

The port runs one process per rank, each holding its own tensors: a
tensor sharded over a batch axis is already this rank's rows, and a
replicated one is the same on every rank. So ``shard`` is the identity
wherever no model axis resolves: with no mesh, under ``manual_axes``
that cover the mesh, and on the 1-D ``clients`` mesh and the
``("pod", "data")`` mesh of this slice. A tensor split over a ``model``
axis needs DTensor, which the 2-D ``("clients", "model")`` slice
brings; until then ``shard`` raises there. ``spec`` returns the JAX
package's ``PartitionSpec`` as a plain tuple, one entry per dim.
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


def _axis_size(mesh, ax):
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        out = 1
        for a in ax:
            out *= mesh.shape[a]
        return out
    return mesh.shape[ax]


def shard(x, *logical):
    """``x`` placed as the logical axes ask on the current mesh. Axes
    that do not divide their dim are dropped (replicated), as in the
    JAX package. Every placement this slice meets is the identity (see
    the module's docstring); a dim split over ``model`` raises."""
    mesh = current_mesh()
    if mesh is None or set(_manual()) >= set(mesh.axis_names):
        return x
    for dim, name in zip(x.shape, logical):
        ax = resolve_axis(name, mesh)
        if ax == "model" and dim % _axis_size(mesh, ax) == 0 \
                and mesh.shape["model"] > 1:
            raise NotImplementedError(
                "shard: a dim split over the 'model' mesh axis is not "
                "ported yet (the 2-D ('clients', 'model') DTensor slice "
                "ports it)")
    return x
