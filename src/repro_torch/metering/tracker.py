"""Pluggable run metrics: counters, gauges, series, and latency
distributions, plus the engine/serving hooks that feed them.

One `MetricsTracker` instance follows one run (a ``run_federated`` call
or an ``AdaptationServer`` lifetime). It is pure host-side bookkeeping:
every hook takes already-materialized Python/NumPy values, so attaching
a tracker never changes what the device computes — ``run_federated``
with ``tracker=None`` and with a tracker produce bit-for-bit identical
params/history (pinned in tests/test_metrics.py).

A copy of the JAX package's tracker; its profiler hook
(``profile_dir=``) brackets a region in ``torch.profiler`` and writes a
Chrome trace, ``<profile_dir>/trace.json``.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class MetricsTracker:
    """Counters + gauges + per-round series + observation distributions.

    Vocabulary (all names are free-form dotted strings):

    - ``inc(name, v)``        monotonic counter (transport bytes, retires)
    - ``gauge(name, v)``      last-value-wins (trace counts, cache sizes)
    - ``record(name, step, v)`` per-step series (round -> loss)
    - ``observe(name, v)``    distribution sample (latencies, steps)

    ``percentiles``/``histogram`` summarize observations; ``summary()``
    returns one JSON-able dict of everything. ``profile_dir=`` arms
    ``torch.profiler``: ``start_profile()``/``stop_profile()`` bracket a
    region (the engine calls them around the scan loop when the tracker
    is attached).
    """

    def __init__(self, profile_dir: Optional[str] = None):
        self.profile_dir = profile_dir
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.series: Dict[str, List[Tuple[int, float]]] = (
            collections.defaultdict(list))
        self.observations: Dict[str, List[float]] = (
            collections.defaultdict(list))
        self._profiling = False
        self._profiler = None

    # -- primitives --------------------------------------------------------
    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def record(self, name: str, step: int, value: float) -> None:
        self.series[name].append((int(step), float(value)))

    def observe(self, name: str, value: float) -> None:
        self.observations[name].append(float(value))

    # -- summaries ---------------------------------------------------------
    def percentiles(self, name: str,
                    qs: Sequence[float] = (50.0, 95.0, 99.0)) -> Dict:
        """{"p50": ..., "p95": ..., ...} over the observations of
        ``name`` (empty dict when nothing was observed)."""
        vals = self.observations.get(name)
        if not vals:
            return {}
        pct = np.percentile(np.asarray(vals, np.float64), qs)
        return {f"p{q:g}": float(p) for q, p in zip(qs, pct)}

    def histogram(self, name: str, bins: int = 10) -> Dict:
        vals = self.observations.get(name)
        if not vals:
            return {"counts": [], "edges": []}
        counts, edges = np.histogram(np.asarray(vals, np.float64),
                                     bins=bins)
        return {"counts": counts.tolist(), "edges": edges.tolist()}

    def series_values(self, name: str) -> List[float]:
        return [v for _, v in self.series.get(name, [])]

    def summary(self) -> Dict:
        out = {"counters": dict(self.counters), "gauges": dict(self.gauges),
               "series": {k: list(v) for k, v in self.series.items()},
               "distributions": {}}
        for name, vals in self.observations.items():
            out["distributions"][name] = {
                "count": len(vals),
                "mean": float(np.mean(vals)),
                **self.percentiles(name)}
        return out

    # -- profiler hook -----------------------------------------------------
    def start_profile(self) -> None:
        if self.profile_dir is None or self._profiling:
            return
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.__enter__()
        self._profiling = True

    def stop_profile(self) -> None:
        if not self._profiling:
            return
        import os
        self._profiler.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        self._profiler.export_chrome_trace(
            os.path.join(self.profile_dir, "trace.json"))
        self._profiler = None
        self._profiling = False

    # -- engine hooks (run_federated) --------------------------------------
    # All hooks receive host values the engine already has (or fetches
    # only when a tracker is attached); none of them feed anything back,
    # so the training trajectory is tracker-independent by construction.
    def on_run_start(self) -> None:
        self._run_t0 = time.perf_counter()
        self.start_profile()

    def on_block(self, start: int, end: int, losses) -> None:
        """Per-round inner losses of one executed scan block
        (``losses[i]`` is round ``start + i``'s cohort-weighted loss)."""
        losses = np.asarray(losses)
        for i, lo in enumerate(losses):
            self.record("round.inner_loss", start + i, float(lo))
        self.inc("engine.rounds", end - start)
        self.inc("engine.blocks")

    def on_transport(self, round_end: int, delta_bytes: int,
                     total_bytes: int) -> None:
        self.inc("transport.bytes", delta_bytes)
        self.record("transport.cum_bytes", round_end, float(total_bytes))

    def on_eval(self, ev: Dict) -> None:
        self.record("eval.query_loss", ev["round"],
                    float(ev["query_loss"]))
        self.inc("engine.evals")

    def on_run_end(self, runner_stats: Optional[Dict] = None,
                   staleness=None) -> None:
        self.stop_profile()
        self.gauge("engine.wall_s",
                   time.perf_counter() - getattr(self, "_run_t0",
                                                 time.perf_counter()))
        if runner_stats:
            for k, v in runner_stats.items():
                self.gauge(f"runner_cache.{k}", float(v))
        if staleness is not None:
            for s in np.asarray(staleness).ravel():
                self.observe("pool.staleness", float(s))

    # -- serving hooks (AdaptationServer) ----------------------------------
    def on_admit(self, request_bytes: int) -> None:
        self.inc("serve.admitted")
        self.inc("serve.request_bytes", request_bytes)

    def on_retire(self, latency_s: float, steps: int) -> None:
        self.inc("serve.retired")
        self.observe("serve.latency_ms", 1e3 * latency_s)
        self.observe("serve.steps", steps)

    def on_tick(self) -> None:
        self.inc("serve.ticks")
