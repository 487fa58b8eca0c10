"""Federated strategies: each training algorithm as engine hooks, and
TIFeD's integer grids.

A ``FedStrategy`` tells the round engine (``core/engine.py``) WHAT a
client computes and HOW the server folds the results back; the engine
owns everything else (scheduling, metering, annealing, eval). The
hooks work on the engine's flat buffers (``bridge.FlatLayout``): phi is
one ``(P,)`` tensor and a round's cohort of C clients is one ``(C, P)``
buffer, so every client's inner step is one launch for the whole
cohort:

  client_update(layout, phi, client_batch, beta) -> (results, losses)
      phi: the broadcast ``(P,)`` parameters; client_batch: {"x","y"}
      with leading (C, support) axes; results: ``(C, P)`` (or the raw
      batch, for Transfer); losses: ``(C, ...)`` inner losses.
  server_aggregate(layout, phi, results, alpha_t, beta) -> phi
      alpha_t: the round's (possibly annealed) server rate, a
      one-element fp32 tensor on phi's device.

Scheduled runs (``SamplingPolicy.schedule_kind != "uniform"``) use the
schedule-aware forms instead:

  client_update_steps(layout, phi, client_batch, beta, k)
      k: ``(C,)`` per-client local step budgets, in the strategy's own
      units (stream samples for TinyReptile, epochs for Reptile/FedAvg);
      the default ignores k (one-shot workloads).
  server_aggregate_weighted(layout, phi, results, alpha_t, beta, weights)
      weights: ``(C,)`` per-round-normalized aggregation weights (0 for
      non-participants).
  local_step_budget(support) -> int
      The full per-client workload in scheduler units.

TIFeD's grids: exponents are powers of two throughout, so every
requantization multiplier is an exact fp32 scaling: inputs on the 2^EX
grid, hidden activations on 2^ACT as unsigned 7-bit, the quantized error
SERR grid steps below the output accumulator. Weight exponents are per
tensor (``kernels.ref.pow2_exponent``); biases sit at accumulator scale.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.engine import meta_interpolate
from repro_torch.core.meta import (cohort_grad, finetune_batch,
                                   finetune_batch_masked, finetune_online,
                                   finetune_online_masked)
from repro_torch.kernels import ref as kref

TIFED_EX = -4
TIFED_ACT = -3
TIFED_SERR = -5


@functools.lru_cache(maxsize=32)
def _tifed_constants(seed, epochs, dims):
    """Fixed DFA feedback matrices and per-epoch stochastic-rounding
    dither planes, drawn with NumPy exactly as the JAX package draws
    them: ``(fb1, fb2)`` int-valued fp32 ``(dout, H)``, and one
    ``(epochs, a, b)`` fp32 U[0, 1) plane per weight. Read-only arrays
    (the cache hands the same ones to every caller)."""
    din, h1, h2, dout = dims
    npr = np.random.default_rng(seed)
    fb = tuple(np.asarray(npr.integers(-127, 128, (dout, h)), np.float32)
               for h in (h1, h2))
    dith = tuple(np.asarray(npr.random((epochs, a, b)), np.float32)
                 for a, b in ((din, h1), (h1, h2), (h2, dout)))
    for arr in fb + dith:
        arr.setflags(write=False)
    return fb, dith


def tifed_dequantize(result):
    """``{"q": {leaf: codes}, "exp": {leaf: exponent}}`` -> fp32 params,
    ``q * 2^exp`` per leaf (the exponent broadcasts over trailing
    axes)."""
    out = {}
    for k, q in result["q"].items():
        e = torch.as_tensor(result["exp"][k], device=q.device).float()
        out[k] = q.float() * torch.exp2(
            e.reshape(e.shape + (1,) * (q.dim() - e.dim())))
    return out


def tifed_requantize(phi):
    """Snap fp32 phi onto the integer grids: weights to their per-tensor
    int8 grid, biases to the matching accumulator grid."""
    out = {}
    for i, ea in enumerate((TIFED_EX, TIFED_ACT, TIFED_ACT)):
        q, e = kref.quantize_pow2(phi[f"w{i}"])
        out[f"w{i}"] = torch.ldexp(q, e)
        eb = e + ea
        out[f"b{i}"] = torch.ldexp(torch.clamp(
            torch.round(torch.ldexp(phi[f"b{i}"], -eb)),
            -kref.BIAS_MAX, kref.BIAS_MAX), eb)
    return out


def weighted_client_mean(results: torch.Tensor, weights: torch.Tensor):
    """``sum_c weights[c] * results[c]`` along the leading clients axis,
    in fp32. Zero-weight clients are zeroed before the sum, so a
    scheduled-out client cannot poison the round with a NaN."""
    q = results.float()
    w = weights.reshape((-1,) + (1,) * (q.dim() - 1))
    return torch.sum(w * torch.where(w > 0, q, 0.0), dim=0)


def reptile_aggregate(phi, phi_hats, alpha_t):
    """Server update shared by TinyReptile (C=1) and batched Reptile:
    phi <- phi + alpha_t * (mean_c(phi_hat_c) - phi), the client mean in
    fp32, the interpolation through the ``meta_update`` kernel."""
    return meta_interpolate(phi, phi_hats.float().mean(dim=0), alpha_t)


def reptile_aggregate_weighted(phi, phi_hats, alpha_t, weights):
    """Participation/arrival-weighted Reptile server update:
    phi <- phi + alpha_t * (sum_c w_c phi_hat_c - phi)."""
    return meta_interpolate(phi, weighted_client_mean(phi_hats, weights),
                            alpha_t)


def _cohort(phi, clients: int):
    """The downlink: one private copy of phi per client, ``(C, P)``."""
    return phi.expand(clients, -1).contiguous()


@dataclasses.dataclass(frozen=True)
class FedStrategy:
    """Base strategy. Subclasses set the class attributes and hooks."""
    loss_fn: Callable

    data_mode = "batch"          # "batch" | "stream" client data layout
    meters_comm = True           # account CommChannel bytes + report them
    tracks_inner_loss = False    # report last-round client loss at evals

    def client_update(self, layout, phi, client_batch, beta):
        raise NotImplementedError

    def server_aggregate(self, layout, phi, results, alpha_t, beta):
        raise NotImplementedError

    def local_step_budget(self, support: int) -> int:
        """Full per-client workload in scheduler units: one unit per
        support sample (stream strategies) unless overridden."""
        return support

    def client_update_steps(self, layout, phi, client_batch, beta, k):
        """Schedule-aware client hook; the default ignores k (one-shot
        workloads)."""
        del k
        return self.client_update(layout, phi, client_batch, beta)

    def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                  beta, weights):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement weighted "
            "aggregation; define server_aggregate_weighted to run under "
            "scheduled sampling policies (partial participation / "
            "stragglers)")


@dataclasses.dataclass(frozen=True)
class TinyReptileStrategy(FedStrategy):
    """Paper Algorithm 1: the client consumes its support STREAM one
    sample at a time (online SGD); the server interpolates toward the
    returned phi_hat."""

    data_mode = "stream"
    tracks_inner_loss = True

    def client_update(self, layout, phi, client_batch, beta):
        x, y = client_batch["x"], client_batch["y"]
        return finetune_online(self.loss_fn, layout, _cohort(phi, len(x)),
                               x, y, beta)

    def client_update_steps(self, layout, phi, client_batch, beta, k):
        """Straggler clients consume only their first k stream samples."""
        x, y = client_batch["x"], client_batch["y"]
        return finetune_online_masked(self.loss_fn, layout,
                                      _cohort(phi, len(x)), x, y, beta, k)

    def server_aggregate(self, layout, phi, results, alpha_t, beta):
        return reptile_aggregate(phi, results, alpha_t)

    def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                  beta, weights):
        return reptile_aggregate_weighted(phi, results, alpha_t, weights)


@dataclasses.dataclass(frozen=True)
class ReptileStrategy(FedStrategy):
    """Reptile [Nichol et al. 2018]: the client trains on its whole
    support set for E epochs; the server averages pseudo-gradients. C=1
    is serial Reptile, C>1 batched Reptile."""
    epochs: int = 8

    tracks_inner_loss = True

    def client_update(self, layout, phi, client_batch, beta):
        return finetune_batch(self.loss_fn, layout,
                              _cohort(phi, len(client_batch["x"])),
                              client_batch, self.epochs, beta)

    def local_step_budget(self, support):
        return self.epochs

    def client_update_steps(self, layout, phi, client_batch, beta, k):
        """Straggler clients complete only their first k local epochs."""
        return finetune_batch_masked(self.loss_fn, layout,
                                     _cohort(phi, len(client_batch["x"])),
                                     client_batch, self.epochs, beta, k)

    def server_aggregate(self, layout, phi, results, alpha_t, beta):
        return reptile_aggregate(phi, results, alpha_t)

    def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                  beta, weights):
        return reptile_aggregate_weighted(phi, results, alpha_t, weights)


@dataclasses.dataclass(frozen=True)
class FedAvgStrategy(FedStrategy):
    """FedAVG [McMahan et al. 2016]: E local epochs, the server averages
    the MODELS (the Eq.-2 objective the paper shows failing in the meta
    regime)."""
    epochs: int = 8

    def client_update(self, layout, phi, client_batch, beta):
        return finetune_batch(self.loss_fn, layout,
                              _cohort(phi, len(client_batch["x"])),
                              client_batch, self.epochs, beta)

    def local_step_budget(self, support):
        return self.epochs

    def client_update_steps(self, layout, phi, client_batch, beta, k):
        return finetune_batch_masked(self.loss_fn, layout,
                                     _cohort(phi, len(client_batch["x"])),
                                     client_batch, self.epochs, beta, k)

    def server_aggregate(self, layout, phi, results, alpha_t, beta):
        return results.sum(dim=0) / results.shape[0]

    def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                  beta, weights):
        """Weighted model average over the participating clients only."""
        return weighted_client_mean(results, weights).to(phi.dtype)


@dataclasses.dataclass(frozen=True)
class FedSGDStrategy(FedStrategy):
    """FedSGD: every client ships ONE gradient; the server applies the
    mean with the client rate beta."""

    def client_update(self, layout, phi, client_batch, beta):
        loss, g = cohort_grad(self.loss_fn, layout,
                              _cohort(phi, len(client_batch["x"])),
                              client_batch)
        return g, loss

    def local_step_budget(self, support):
        return 1                 # one gradient: no straggler axis

    def server_aggregate(self, layout, phi, results, alpha_t, beta):
        return phi - beta * results.sum(dim=0) / results.shape[0]

    def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                  beta, weights):
        """Apply the participation-weighted mean gradient."""
        g = weighted_client_mean(results, weights)
        return (phi - beta * g).to(phi.dtype)


@dataclasses.dataclass(frozen=True)
class TransferStrategy(FedStrategy):
    """Joint-training baseline (paper Fig. 1): clients forward their raw
    batches; the server takes one SGD step on the pooled data. No
    federation, so no comm accounting."""

    meters_comm = False

    def client_update(self, layout, phi, client_batch, beta):
        return client_batch, torch.zeros(len(client_batch["x"]),
                                         device=phi.device)

    def local_step_budget(self, support):
        return 1                 # raw-batch forward: no straggler axis

    def server_aggregate(self, layout, phi, results, alpha_t, beta):
        pooled = {k: v.reshape((1, -1) + tuple(v.shape[2:]))
                  for k, v in results.items()}
        _, g = cohort_grad(self.loss_fn, layout, phi[None], pooled)
        return phi - beta * g[0]

    def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                  beta, weights):
        """Per-client pool gradients, weighted: scheduled-out clients'
        (zeroed) batches get weight 0."""
        _, g = cohort_grad(self.loss_fn, layout,
                           _cohort(phi, len(results["x"])), results)
        return (phi - beta * weighted_client_mean(g, weights)).to(phi.dtype)
