"""Federated strategies: each training algorithm as engine hooks, and
TIFeD's integer grids.

A ``FedStrategy`` tells the round engine (``core/engine.py``) WHAT a
client computes and HOW the server folds the results back; the engine
owns everything else (scheduling, metering, annealing, eval). The
hooks work on the engine's flat buffers (``bridge.GroupedLayout``): phi
is one ``(P_g,)`` tensor per leaf dtype group (a tuple; one group for a
single-dtype tree) and a round's cohort of C clients one ``(C, P_g)``
buffer per group, so every client's inner step is one launch per group
for the whole cohort:

  client_update(layout, phi, client_batch, beta) -> (results, losses)
      phi: the broadcast parameters; client_batch: {"x","y"} with
      leading (C, support) axes; results: the ``(C, P_g)`` buffers (or
      the raw batch, for Transfer); losses: ``(C, ...)`` inner losses.
  server_aggregate(layout, phi, results, alpha_t, beta) -> phi
      alpha_t: the round's (possibly annealed) server rate, a
      one-element fp32 tensor on phi's device.

Scheduled runs (``SamplingPolicy.schedule_kind != "uniform"``) use the
schedule-aware forms instead:

  client_update_steps(layout, phi, client_batch, beta, k)
      k: ``(C,)`` per-client local step budgets, in the strategy's own
      units (stream samples for TinyReptile, epochs for Reptile/FedAvg);
      the default ignores k (one-shot workloads).
  server_aggregate_weighted(layout, phi, results, alpha_t, beta, weights,
                            group=None)
      weights: ``(C,)`` per-round-normalized aggregation weights (0 for
      non-participants). A FedBuff flush calls it on the buffer, with a
      leading capacity axis and staleness-discounted weights. ``group``
      is the collective form (mesh runs; the JAX package's
      ``axis_name``): results and weights are this rank's cohort shard,
      the weights normalized over the whole cohort, and routing the mean
      through ``weighted_client_mean(..., group=group)`` sums the ranks'
      partial means into the cohort's.
  local_step_budget(support) -> int
      The full per-client workload in scheduler units.

Results need not be flat: TIFeD's are int8/int32 trees (``uplink_template``
gives their shapes, for the FedBuff buffer; ``payload_dtype`` declares
the native wire dtype). ``uplink_ref`` says what a partial channel's
dropped uplink entries fall back to.

Each leaf keeps the JAX package's dtype rules (``repro/core/
strategies.py``) with ``beta`` a weakly typed Python float: the client
means are fp32 (Reptile's and every weighted one); the Reptile
interpolation is fp32 math on the unrounded mean, stored in the leaf's
dtype (``meta_update``); FedAvg's and FedSGD's unweighted server steps
and Transfer's run in the leaf's own dtype; their weighted ones in fp32,
cast back to it.

TIFeD's grids: exponents are powers of two throughout, so every
requantization multiplier is an exact fp32 scaling: inputs on the 2^EX
grid, hidden activations on 2^ACT as unsigned 7-bit, the quantized error
SERR grid steps below the output accumulator. Weight exponents are per
tensor (``kernels.ref.pow2_exponent``); biases sit at accumulator scale.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.bridge import group_map
from repro_torch.core.engine import meta_interpolate
from repro_torch.core.meta import (cohort_grad, finetune_batch,
                                   finetune_batch_masked, finetune_online,
                                   finetune_online_masked)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.runtime.sharding import all_reduce

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
    ``q * 2^exp`` per leaf (the exponent broadcasts over trailing axes,
    so a cohort's tree with a leading clients axis dequantizes whole)."""
    out = {}
    for k, q in result["q"].items():
        e = torch.as_tensor(result["exp"][k], device=q.device)
        out[k] = q.float() * kref.exp2_int(
            e.reshape(e.shape + (1,) * (q.dim() - e.dim())))
    return out


def tifed_requantize(phi):
    """Snap fp32 phi onto the integer grids: weights to their per-tensor
    int8 grid, biases to the matching accumulator grid. Every scaling is
    an exact power of two built on the device (``kref.exp2_int``)."""
    out = {}
    for i, ea in enumerate((TIFED_EX, TIFED_ACT, TIFED_ACT)):
        q, e = kref.quantize_pow2(phi[f"w{i}"])
        out[f"w{i}"] = q * kref.exp2_int(e)
        eb = e + ea
        out[f"b{i}"] = torch.clamp(
            torch.round(phi[f"b{i}"] * kref.exp2_int(-eb)),
            -kref.BIAS_MAX, kref.BIAS_MAX) * kref.exp2_int(eb)
    return out


def weighted_client_mean(results, weights: torch.Tensor, group=None):
    """``sum_c weights[c] * results[c]`` along the leading clients axis,
    in fp32, per group. Zero-weight clients are zeroed before the sum,
    so a scheduled-out client cannot poison the round with a NaN. One
    ``client_mean`` launch a group on the card (a bf16 group's rows are
    read as they are); it rounds where the JAX engine's jitted mean
    rounds (``kernels/ref.py::client_mean``).

    ``group``: the rows are this rank's shard of the cohort, and the
    weights are normalized over the whole cohort, so the sum of the
    ranks' partial sums is the cohort's mean: one ``all_reduce`` a dtype
    group (the JAX package's one multi-operand ``psum``)."""
    return all_reduce_groups(
        group_map(lambda q: kops.client_mean(q, weights), results), group)


def all_reduce_groups(flats, group):
    """Flat buffers (a tensor, or a tuple of one a dtype group) summed in
    place across ``group``: one ``all_reduce`` a buffer."""
    if group is not None:
        group_map(lambda t: all_reduce(t, group), flats)
    return flats


def _client_mean(q):
    """The unweighted client mean in fp32; a bf16 group is summed in
    fp32 as it is read, with no fp32 copy of the cohort."""
    if q.dtype == torch.float32:
        return q.mean(dim=0)
    return q.mean(dim=0, dtype=torch.float32)


def reptile_aggregate(phi, phi_hats, alpha_t):
    """Server update shared by TinyReptile (C=1) and batched Reptile:
    phi <- phi + alpha_t * (mean_c(phi_hat_c) - phi), the client mean in
    fp32, the interpolation through the ``meta_update`` kernel."""
    return meta_interpolate(phi, group_map(_client_mean, phi_hats), alpha_t)


def reptile_aggregate_weighted(phi, phi_hats, alpha_t, weights,
                               group=None):
    """Participation/arrival-weighted Reptile server update:
    phi <- phi + alpha_t * (sum_c w_c phi_hat_c - phi). ``group`` reduces
    the weighted client mean across ranks (a sharded cohort, pod
    clients)."""
    return meta_interpolate(
        phi, weighted_client_mean(phi_hats, weights, group), alpha_t)


def _cohort(phi, clients: int):
    """The downlink: one private copy of phi per client, ``(C, P_g)``
    per group."""
    return group_map(lambda p: p.expand(clients, -1).contiguous(), phi)


def _device(phi) -> torch.device:
    return (phi[0] if isinstance(phi, tuple) else phi).device


@dataclasses.dataclass(frozen=True)
class FedStrategy:
    """Base strategy. Subclasses set the class attributes and hooks."""
    loss_fn: Callable

    data_mode = "batch"          # "batch" | "stream" client data layout
    meters_comm = True           # account CommChannel bytes + report them
    tracks_inner_loss = False    # report last-round client loss at evals
    uplink_ref = "params"        # what a partial uplink falls back to for
    #                              untransmitted entries: "params" (the
    #                              server's phi; model-returning uplinks),
    #                              "zeros" (gradient uplinks) or "none"
    #                              (no phi-shaped result to fall back on)
    payload_dtype = "float32"    # wire dtype of the client result: other
    #                              values declare NATIVE quantized uplinks,
    #                              which need a matching non-simulating
    #                              channel (e.g. CommChannel("int8",
    #                              quantize=False))

    def uplink_template(self, layout, phi):
        """One client's result with zeros: its shapes and dtypes (a
        tensor, or a dict of tensors), from which the engine sizes the
        FedBuff buffer. Default: phi's flat buffers."""
        return group_map(torch.zeros_like, phi)

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
                                  beta, weights, group=None):
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
                                  beta, weights, group=None):
        return reptile_aggregate_weighted(phi, results, alpha_t, weights,
                                          group)


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
                                  beta, weights, group=None):
        return reptile_aggregate_weighted(phi, results, alpha_t, weights,
                                          group)


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
        return group_map(lambda q: q.sum(dim=0) / q.shape[0], results)

    def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                  beta, weights, group=None):
        """Weighted model average over the participating clients only."""
        return group_map(lambda p, q: q.to(p.dtype), phi,
                         weighted_client_mean(results, weights, group))


@dataclasses.dataclass(frozen=True)
class FedSGDStrategy(FedStrategy):
    """FedSGD: every client ships ONE gradient; the server applies the
    mean with the client rate beta."""

    uplink_ref = "zeros"         # untransmitted gradient entries are 0

    def client_update(self, layout, phi, client_batch, beta):
        loss, g = cohort_grad(self.loss_fn, layout,
                              _cohort(phi, len(client_batch["x"])),
                              client_batch)
        return g, loss

    def local_step_budget(self, support):
        return 1                 # one gradient: no straggler axis

    def server_aggregate(self, layout, phi, results, alpha_t, beta):
        return group_map(lambda p, g: p - beta * g.sum(dim=0) / g.shape[0],
                         phi, results)

    def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                  beta, weights, group=None):
        """Apply the participation-weighted mean gradient."""
        return group_map(lambda p, g: (p - beta * g).to(p.dtype), phi,
                         weighted_client_mean(results, weights, group))


@dataclasses.dataclass(frozen=True)
class TransferStrategy(FedStrategy):
    """Joint-training baseline (paper Fig. 1): clients forward their raw
    batches; the server takes one SGD step on the pooled data. No
    federation, so no comm accounting."""

    meters_comm = False
    uplink_ref = "none"          # raw-data uplink: no phi-shaped reference

    def client_update(self, layout, phi, client_batch, beta):
        return client_batch, torch.zeros(len(client_batch["x"]),
                                         device=_device(phi))

    def local_step_budget(self, support):
        return 1                 # raw-batch forward: no straggler axis

    def server_aggregate(self, layout, phi, results, alpha_t, beta):
        pooled = {k: v.reshape((1, -1) + tuple(v.shape[2:]))
                  for k, v in results.items()}
        _, g = cohort_grad(self.loss_fn, layout,
                           group_map(lambda p: p[None], phi), pooled)
        return group_map(lambda p, gg: p - beta * gg[0], phi, g)

    def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                  beta, weights, group=None):
        """Per-client pool gradients, weighted: scheduled-out clients'
        (zeroed) batches get weight 0."""
        _, g = cohort_grad(self.loss_fn, layout,
                           _cohort(phi, len(results["x"])), results)
        return group_map(lambda p, gg: (p - beta * gg).to(p.dtype), phi,
                         weighted_client_mean(g, weights, group))


# the device copies of the TIFeD constants by (feedback seed, epochs,
# dims, clients, device): fb (int8), each epoch's dither planes expanded
# to the cohort, each epoch's layer per slot. Never evicted: a captured
# round reads them at their addresses for as long as it lives.
_TIFED_DEVICE: Dict = {}


def _tifed_device_constants(seed, epochs, dims, clients, device):
    key = (seed, epochs, dims, clients, str(device))
    hit = _TIFED_DEVICE.get(key)
    if hit is None:
        fb_np, dith_np = _tifed_constants(seed, epochs, dims)
        fb = tuple(torch.tensor(f, device=device).to(torch.int8)
                   for f in fb_np)
        dith = tuple(
            tuple(torch.tensor(d[e], device=device)
                  .expand((clients,) + d.shape[1:]).contiguous()
                  for d in dith_np) for e in range(epochs))
        layers = tuple(torch.full((clients,), e % 3, dtype=torch.int32,
                                  device=device) for e in range(epochs))
        hit = _TIFED_DEVICE[key] = (fb, dith, layers)
    return hit


@dataclasses.dataclass(frozen=True)
class TifedStrategy(FedStrategy):
    """TIFeD [arXiv 2307.03102]: integer-only local training with direct
    feedback alignment, as an engine strategy.

    Clients never touch fp32 weights: phi is quantized to per-tensor
    power-of-two int8 grids, and each local epoch runs an int8 forward
    pass with int32 accumulation, projects the quantized output error
    straight to one layer through a fixed random feedback matrix, and
    requantizes that layer's update with stochastic rounding (epoch t
    trains layer t mod 3). Learning rates are bit-shifts: ``lr_shift``
    plus log2(support) folds the batch mean in.

    Each epoch is one ``dfa_epoch_int8`` launch for the whole cohort, the
    round's C clients being the kernel's C slots. Straggler epochs past
    a client's budget are dropped per slot on the device (the carry
    passes through, the loss reads 0), so the round has no host branch
    and is captured whole.

    The uplink is the native int8/int32 result tree ``{"q": {w*, b*},
    "exp": {w*, b*}}`` (``payload_dtype="int8"``: billed at 1 byte a
    parameter through ``CommChannel("int8", quantize=False)``; the six
    exponents ride free). The server dequantizes, takes the (weighted)
    client mean, Reptile-interpolates with ``meta_update`` and snaps phi
    back onto the integer grids.

    ``loss_fn`` is only used by the engine's fp32 eval finetune
    (``models.paper_nets.relu_mlp_loss``: the integer forward is a ReLU
    MLP). ``unroll`` and ``use_pallas`` are accepted for the JAX
    package's signature and ignored: each epoch is one kernel launch on
    the card and the plain version on the CPU, as every wrapper of
    ``kernels/ops.py`` dispatches."""
    epochs: int = 8
    lr_shift: int = 6
    feedback_seed: int = 0
    unroll: int = 2
    use_pallas: Optional[bool] = None

    tracks_inner_loss = True
    payload_dtype = "int8"

    @staticmethod
    def _dims(phi):
        for i in range(3):
            if f"w{i}" not in phi or f"b{i}" not in phi:
                raise ValueError(
                    "TifedStrategy expects the paper MLP tree "
                    "{w0,b0,w1,b1,w2,b2} (models.paper_nets); got keys "
                    f"{sorted(phi)}")
        return (phi["w0"].shape[0], phi["w0"].shape[1],
                phi["w1"].shape[1], phi["w2"].shape[1])

    def uplink_template(self, layout, phi):
        views = layout.views(phi)
        self._dims(views)
        dev = _device(phi)
        q = {f"w{i}": torch.zeros(views[f"w{i}"].shape, dtype=torch.int8,
                                  device=dev) for i in range(3)}
        q.update({f"b{i}": torch.zeros(views[f"b{i}"].shape,
                                       dtype=torch.int32, device=dev)
                  for i in range(3)})
        return {"q": q, "exp": {k: torch.zeros((), dtype=torch.int32,
                                               device=dev)
                                for k in q}}

    def _run_epochs(self, layout, phi, client_batch, k):
        views = layout.views(phi)
        dims = self._dims(views)
        x = client_batch["x"]
        clients = x.shape[0]
        x = x.reshape(clients, -1, dims[0])
        y = client_batch["y"].reshape(clients, x.shape[1], dims[3])
        n = x.shape[1]
        # fold the 1/n batch mean into the shift (exact for pow2 n)
        lrs = self.lr_shift + int(np.floor(np.log2(n)))
        fb, dith, layers = _tifed_device_constants(
            self.feedback_seed, self.epochs, dims, clients, _device(phi))
        p2 = kref.exp2_int
        ws, ew = [], []
        for i in range(3):
            q, e = kref.quantize_pow2(views[f"w{i}"])
            ws.append(q)
            ew.append(e)
        ea = (TIFED_EX, TIFED_ACT, TIFED_ACT)
        sacc = [ew[i] + ea[i] for i in range(3)]
        bs = [torch.clamp(torch.round(views[f"b{i}"] * p2(-sacc[i])),
                          -kref.BIAS_MAX, kref.BIAS_MAX) for i in range(3)]
        xq = torch.clamp(torch.round(x * 2.0 ** -TIFED_EX), -127.0, 127.0)
        yal = torch.round(y * p2(-sacc[2]))
        scales = torch.stack(
            [p2(sacc[0] - TIFED_ACT), p2(sacc[1] - TIFED_ACT),
             p2(sacc[2] - TIFED_SERR), p2(2 * sacc[2]) / n]
            + [p2(ea[i] + TIFED_SERR - ew[i] - lrs) for i in range(3)]
            + [p2(TIFED_SERR - sacc[i] - lrs) for i in range(3)])
        cw = tuple(w.to(torch.int8).expand((clients,) + w.shape).contiguous()
                   for w in ws)
        cb = tuple(b.to(torch.int32).expand(clients, -1).contiguous()
                   for b in bs)
        xq = xq.to(torch.int8).contiguous()
        yal = yal.to(torch.int32).contiguous()
        losses = []
        for e in range(self.epochs):
            nw, nb, loss = kops.dfa_epoch_int8(cw, cb, xq, yal, layers[e],
                                               fb, dith[e], scales)
            if k is not None:
                live = k > e
                nw = tuple(torch.where(live.view(-1, 1, 1), a, b)
                           for a, b in zip(nw, cw))
                nb = tuple(torch.where(live.view(-1, 1), a, b)
                           for a, b in zip(nb, cb))
                loss = torch.where(live, loss, 0.0)
            cw, cb = nw, nb
            losses.append(loss)
        result = {
            "q": {"w0": cw[0], "w1": cw[1], "w2": cw[2],
                  "b0": cb[0], "b1": cb[1], "b2": cb[2]},
            "exp": {f"{kind}{i}": e.reshape(1).expand(clients)
                    for kind, es in (("w", ew), ("b", sacc))
                    for i, e in enumerate(es)},
        }
        return result, torch.stack(losses, dim=1)

    def client_update(self, layout, phi, client_batch, beta):
        del beta                      # the learning rate is the bit-shift
        return self._run_epochs(layout, phi, client_batch, None)

    def local_step_budget(self, support):
        return self.epochs

    def client_update_steps(self, layout, phi, client_batch, beta, k):
        """Straggler clients complete only their first k integer epochs."""
        del beta
        return self._run_epochs(layout, phi, client_batch, k)

    @staticmethod
    def _snap(layout, flat):
        return layout.pack(tifed_requantize(layout.views(flat)))

    def server_aggregate(self, layout, phi, results, alpha_t, beta):
        deq = tifed_dequantize(results)
        mean = layout.pack({k: v.mean(dim=0) for k, v in deq.items()})
        return self._snap(layout, meta_interpolate(phi, mean, alpha_t))

    def server_aggregate_weighted(self, layout, phi, results, alpha_t,
                                  beta, weights, group=None):
        """Dequantize each client's int8 tree, take the weighted client
        mean, Reptile-interpolate, requantize onto the integer grids. On
        a mesh the leaves' partial means are packed first, so the ranks
        sum them in one ``all_reduce``."""
        deq = tifed_dequantize(results)
        mean = all_reduce_groups(
            layout.pack({k: weighted_client_mean(v, weights)
                         for k, v in deq.items()}), group)
        return self._snap(layout, meta_interpolate(phi, mean, alpha_t))
