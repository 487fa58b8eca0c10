"""Memory metering: the analytic MCU model of paper Table II
(``algorithm_memory_report``), and a live host and device meter
(``MemoryMeter``).

The analytic model simulates the MCU resource accounting of paper Table
II, for a model with P parameter bytes, per-sample activation footprint
A, per-sample data size D and support size S:

  Reptile (batched):  P (weights) + P (batch-accumulated grads)
                      + S*D (stored support set)
                      + S*A (batched activations for the update)
  TinyReptile (ours): P + 1*D + 1*A + delta-buffer
                      (stream: ONE sample alive; the gradient is applied
                       layer by layer during backprop, the TinyOL trick
                       [Ren et al. 2021], so no full gradient buffer)

The port's copy of the JAX package's model: the same formulas, the same
dict. At S = 32 it gives Reptile 17,928 / 1,020,064 / 3,274,024 bytes
against TinyReptile 5,140 / 141,172 / 625,324 for the sine MLP, KWS and
Omniglot (3.49x, 7.23x, 5.24x). The paper's KWS pipeline stores raw 1-s
waveforms per sample; this model accounts the preprocessed 49x10 MFCC
map.
"""
from __future__ import annotations

import os
import resource
import sys
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.paper_models import PaperModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.paper_nets import conv_shapes

BYTES_F32 = 4


def _per_sample_activation_elems(cfg: PaperModelConfig) -> int:
    if cfg.kind == "mlp":
        return int(np.prod(cfg.input_shape)) + sum(cfg.hidden) \
            + cfg.num_outputs
    return (int(np.prod(cfg.input_shape))
            + sum(h * w * c for h, w, c in conv_shapes(cfg))
            + cfg.num_outputs)


def _param_count(cfg: PaperModelConfig) -> int:
    if cfg.kind == "mlp":
        dims = (int(np.prod(cfg.input_shape)),) + cfg.hidden + (
            cfg.num_outputs,)
        return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    n, cin = 0, cfg.input_shape[-1]
    for h, w, cout in conv_shapes(cfg):
        n += 9 * cin * cout + cout
        cin = cout
    return n + h * w * cin * cfg.num_outputs + cfg.num_outputs


def _max_layer_width(cfg: PaperModelConfig) -> int:
    if cfg.kind == "mlp":
        return max(cfg.hidden + (cfg.num_outputs,))
    return max([h * w * c for h, w, c in conv_shapes(cfg)]
               + [cfg.num_outputs])


def algorithm_memory_report(cfg: PaperModelConfig,
                            support: int = 32) -> Dict[str, float]:
    """Table II's modelled bytes of one client's training, Reptile
    against TinyReptile, and whether each fits a 256 KB Arduino."""
    P = _param_count(cfg) * BYTES_F32
    A = _per_sample_activation_elems(cfg) * BYTES_F32
    D = (int(np.prod(cfg.input_shape)) + 1) * BYTES_F32
    reptile = 2 * P + support * (D + A)
    # TinyOL-style in-place update: backprop delta buffer, no grad copy
    tiny = P + (D + A) + 2 * _max_layer_width(cfg) * BYTES_F32
    return {
        "model": cfg.name,
        "params": _param_count(cfg),
        "param_bytes": P,
        "reptile_bytes": reptile,
        "tinyreptile_bytes": tiny,
        "reduction_factor": reptile / tiny,
        "fits_arduino_256kb_reptile": reptile <= 256 * 1024,
        "fits_arduino_256kb_tinyreptile": tiny <= 256 * 1024,
    }


def _statm_rss_bytes() -> int:
    """Current resident set size from /proc/self/statm (Linux; 0 where
    the proc filesystem is unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return 0
    return pages * os.sysconf("SC_PAGESIZE")


def _peak_rss_bytes() -> int:
    """Process-lifetime peak RSS (``ru_maxrss`` is KiB on Linux, bytes on
    macOS)."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return peak if sys.platform == "darwin" else peak * 1024


@dataclass
class MemoryMeter:
    """Live host and device memory meter for residency proofs, on the
    run's ``device`` (default ``cuda``).

    ``ru_maxrss`` is a process-LIFETIME high-water mark, so a meter
    started mid-process cannot see a peak below the history it inherits;
    the meter therefore reports both the baseline at construction and
    the growth since. Usage::

        meter = MemoryMeter()          # baseline snapshot
        ... run the workload ...
        rep = meter.report()
        rep["host_current_growth_bytes"]   # RSS now vs baseline
        rep["host_peak_growth_bytes"]      # lifetime peak vs baseline RSS
        rep["device_peak_bytes"]           # max over sampled device use

    ``sample()`` may be called any number of times mid-run to tighten
    the device high-water mark, read from ``torch.cuda.memory_allocated``
    (PyTorch's allocator on that device); ``device_max_allocated_bytes``
    is the allocator's own peak (``torch.cuda.max_memory_allocated``,
    since its last reset). On the CPU both are 0. A failing read of a
    CUDA device raises.
    """
    device: DeviceLike = None
    baseline_rss: int = 0
    baseline_peak: int = 0
    _device_peak: int = field(default=0, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.baseline_rss = _statm_rss_bytes()
        self.baseline_peak = _peak_rss_bytes()
        self.sample()

    def sample(self) -> None:
        if self.device.type == "cuda":
            self._device_peak = max(self._device_peak,
                                    torch.cuda.memory_allocated(self.device))

    def report(self) -> Dict[str, int]:
        self.sample()
        current = _statm_rss_bytes()
        peak = _peak_rss_bytes()
        return {
            "host_baseline_bytes": self.baseline_rss,
            "host_current_bytes": current,
            "host_current_growth_bytes": max(current - self.baseline_rss,
                                             0),
            "host_peak_bytes": peak,
            "host_peak_growth_bytes": max(peak - self.baseline_rss, 0),
            "device_peak_bytes": self._device_peak,
            "device_max_allocated_bytes": (
                torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0),
        }
