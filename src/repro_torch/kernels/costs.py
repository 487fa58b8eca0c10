"""What a traced step costs: the kernels' shape-only route and their
cost records, and ``CostMode``, which counts a step's operations.

Shape-only tensors. A ``FakeTensor`` (``torch._subclasses.fake_tensor``,
what the dry run traces a step on) or a ``meta`` tensor carries a shape,
a dtype and a device but no data. Each kernel wrapper tests for one
first (``shape_only``) and then returns outputs of the right shapes and
dtypes without launching, reading or computing anything; a real CUDA
tensor never takes that route, and a real CPU tensor still gets the
plain version. The route leaves the wrappers' ``launches`` counters
alone.

Cost records. While a ``CostMode`` is active (``active()``), each
wrapper call on any route adds its kernel's analytic operations and
bytes (each input read once, each output written once) to the mode's
``kernels`` record, by name; on the CPU route the plain version's own
aten operations are not counted (``uncounted``), so a step's count is
the same on fake tensors, on the card and on the CPU. Outside a
``CostMode`` a wrapper pays one global read for all this.

``CostMode`` (a ``TorchDispatchMode``) counts every aten operation the
step dispatches: FLOPs by ``torch.utils.flop_counter``'s formulas
(FlopCounterMode's), bytes accessed as each operation's tensor inputs
and outputs (a view moves nothing), and the bytes of live storage (each
storage counted once, from its first tensor out of an operation until
its last one dies), whose peak the dry run reports.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

#: the active CostMode, which the kernel wrappers record their calls in
_ACTIVE: list = [None]


def shape_only(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no data: a fake tensor or a ``meta`` one."""
    return isinstance(t, FakeTensor) or t.is_meta


def active() -> Optional["CostMode"]:
    """The ``CostMode`` a wrapper records its kernel in, or None."""
    return _ACTIVE[0]


def uncounted():
    """A context in which the active ``CostMode`` (if any) counts no
    operation: the plain version of a kernel recorded by its analytic
    cost."""
    mode = _ACTIVE[0]
    return contextlib.nullcontext() if mode is None else mode.paused()


def same_device(name: str, *tensors) -> None:
    """Raise unless ``tensors`` share one device: the shape-only route's
    check (the wrappers' own compare device indices, which a ``meta``
    and a CPU tensor share)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: the operands lie on "
                         f"{sorted(map(str, devices))}; they must share one "
                         f"device")


def empty_like_shape(t: torch.Tensor, shape=None, dtype=None):
    """A new tensor beside ``t`` (its device and fake mode), uninitialised:
    the shape-only route's outputs."""
    return t.new_empty(tuple(t.shape) if shape is None else tuple(shape),
                       dtype=t.dtype if dtype is None else dtype)


# operations that read metadata only: not counted at all
_METADATA = {
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default, torch.ops.prim.layout.default,
    torch.ops.prim.device.default,
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors in an operation's arguments or results (tensors, and
    lists, tuples and dicts of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class CostMode(TorchDispatchMode):
    """Count a region's operations (see the module's docstring).

    ``flops`` and ``bytes`` are the aten operations' plus the kernels'
    (``kernels[name]`` holds each kernel's ``calls``, ``flops`` and
    ``bytes``); ``aten_flops`` and ``aten_bytes`` the aten operations'
    alone. ``live`` is the bytes of storage made in the region and alive
    now, ``peak`` its most: the storage of ``inputs`` (any tree of
    tensors the region starts with) never counts, even where an
    operation writes it in place and returns it."""

    def __init__(self, inputs=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.aten_flops = 0
        self.aten_bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}
        self._paused = 0
        # each operation's (metadata only, FLOP formula, is a view)
        self._how: Dict = {}
        self._inputs = {t.untyped_storage()._cdata
                        for t in _tensors(inputs)}

    @property
    def flops(self) -> int:
        return self.aten_flops + sum(k["flops"] for k in self.kernels.values())

    @property
    def bytes(self) -> int:
        return self.aten_bytes + sum(k["bytes"] for k in self.kernels.values())

    def record(self, name: str, flops: int, nbytes: int) -> None:
        """One call of kernel ``name``."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __enter__(self):
        self._outer = _ACTIVE[0]
        _ACTIVE[0] = self
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE[0] = self._outer
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        how = self._how.get(func)
        if how is None:
            how = self._how[func] = (
                func in _METADATA,
                self._formulas.get(func._overloadpacket), func.is_view)
        skip, formula, view = how
        if skip:
            return out
        if formula is not None:
            self.aten_flops += int(formula(*args, **kwargs, out_val=out))
        outs = list(_tensors(out))
        if not view:
            self.aten_bytes += (sum(map(_nbytes, _tensors(args)))
                                + sum(map(_nbytes, _tensors(kwargs)))
                                + sum(map(_nbytes, outs)))
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._inputs:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [storage.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]
