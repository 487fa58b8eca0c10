"""Build a step once, then replay it: the port's one trace per config.

The JAX package compiles a block of rounds and a serving tick once
(``jax.jit``) and counts the traces (``trace_count``). The port's
counterpart is ``GraphStep``: a function of no arguments that reads and
writes only tensors at fixed addresses (its owner's static buffers).

- On the card, the first call runs the function on a side stream, as a
  real step and as the warm-up that lazy setup needs (cuBLAS handles,
  the autograd engine, the kernels' builds), then captures it as one
  CUDA graph; every later call replays the graph on the current stream.
  Capture records the kernels without running them, so the static
  buffers hold exactly what the warm-up left there.
- On the CPU every call runs the function itself, the very code the
  card captures.

The kernel wrappers count their launches in Python, which a replay
never reaches. So the capture notes each counter's rise, puts the
counters back (a capture launches nothing), and every replay adds the
rise again: ``kernels.ops.launch_counts`` reads the same on both routes.

A step's owner (a decode runner, a serving tick, a round program) hands
``GraphStep`` its method through ``weak_method``: a bound method would
make the owner and its step refer to each other, and then dropping the
owner's last reference would free neither its device buffers nor the
graph until Python's cyclic collector ran.

A step whose function calls a collective that cannot be captured (gloo
stages through the host) is built with ``capture=False`` and runs
eagerly on the card too; its first call still counts as its build.

A capture or replay that fails raises; nothing falls back to running
the step eagerly. Python's cyclic garbage collector is off while a graph
is captured: a collection may free another, unreachable graph, and
destroying a graph is a call that invalidates a capture in progress.
"""
from __future__ import annotations

import ctypes
import gc
import time
import weakref
from typing import Callable, Optional

import torch

from repro_torch.kernels import ops as kops


def _graph_nodes(graph) -> Optional[int]:
    """Nodes of a captured graph, where this PyTorch keeps the graph
    (``CUDAGraph(keep_graph=True)``); else None."""
    try:
        handle = graph.raw_cuda_graph()
        count = ctypes.c_size_t(0)
        err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(handle), None, ctypes.byref(count))
    except (AttributeError, OSError, RuntimeError, TypeError):
        return None
    return int(count.value) if err == 0 else None


def _new_graph():
    """(graph, whether it keeps its cudaGraph_t and so must be
    instantiated by hand)."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:                  # a PyTorch without keep_graph
        return torch.cuda.CUDAGraph(), False


def weak_method(method) -> Callable[[], None]:
    """``method`` (bound to the step's owner) as a function of no
    arguments that reaches its owner through a weak reference, so the
    owner's ``GraphStep`` keeps no cycle with it."""
    ref = weakref.WeakMethod(method)
    return lambda: ref()()


class GraphStep:
    """``fn`` run on ``device``: eagerly on the CPU (and on the card with
    ``capture=False``), captured once and replayed on the card. ``ready``
    turns True at the first call, which builds the program (the capture
    on the card). ``capture_s`` (the capture and instantiation, host
    seconds) and ``nodes`` (the graph's node count, None where PyTorch
    does not keep the graph) describe the capture."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 capture: bool = True):
        self.fn = fn
        self.device = device
        self.capture = capture
        self.ready = False
        self.graph = None
        self.capture_s: Optional[float] = None
        self.nodes: Optional[int] = None
        self._rises = ()

    def __call__(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            for wrapper, rise in self._rises:
                wrapper.launches += rise
        elif self.device.type == "cuda" and self.capture:
            self._warm_up_and_capture()
        else:
            self.fn()
        self.ready = True

    def _warm_up_and_capture(self) -> None:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.fn()                                # the real first step
        before = kops.launch_counts()
        t0 = time.perf_counter()
        graph, kept = _new_graph()
        collecting = gc.isenabled()
        gc.disable()            # no graph is destroyed during the capture
        try:
            # thread_local: the engine's prefetch thread stages the next
            # block (pinned copies, a side stream) while this one captures
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.fn()
        finally:
            if collecting:
                gc.enable()
        if kept:
            graph.instantiate()
        self.capture_s = time.perf_counter() - t0
        after = kops.launch_counts()
        self._rises = tuple((kops.KERNELS[name], after[name] - before[name])
                            for name in after if after[name] != before[name])
        for wrapper, rise in self._rises:
            wrapper.launches -= rise                 # recorded, not launched
        self.nodes = _graph_nodes(graph) if kept else None
        current.wait_stream(side)
        self.graph = graph
