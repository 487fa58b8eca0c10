"""Step builders: the paper's technique (a TinyReptile round) as the LM
train step, the port of the JAX package's ``runtime/steps.py`` on its
single-device route.

``make_meta_train_step`` is TinyReptile with one client per round, built
from the round engine's building blocks (``core/engine.py``):

- ``streaming_sgd``: K streaming SGD steps, one microbatch each (the
  paper's online learning), one ``online_sgd`` launch per dtype group
  per step;
- ``kernels/ops.py::tree_meta_update``: the Reptile server update phi
  <- phi + alpha (phi_hat - phi), one ``meta_update`` launch per dtype
  group.

``make_joint_train_step`` is the joint-training baseline (one optimizer
step of ``optim.sgd`` or ``optim.adamw`` a batch), ``make_prefill_step``
the last-token logits, and ``make_decode_step`` the LM's decode step
(``Model.decode_fn``).
``DecodeRunner`` is what the serve launcher's decode mode drives: a whole
greedy decode step (the token, ``decode_fn``, the argmax) built once and
replayed, as the JAX launcher jits ``decode_fn`` once with ``cache_len``
a traced scalar.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.bridge import tree_leaves, unflatten_tree
from repro_torch.core.engine import streaming_sgd
from repro_torch.core.pipeline import prefetch_items
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import GraphStep, weak_method
from repro_torch.kernels.ops import tree_meta_update
from repro_torch.runtime.flags import feature, feature_scope


def data_rows(batch, mesh, axis: str):
    """This rank's rows of each microbatch: ``batch``'s leaves are (K, mb,
    ...), and rank i of the ``axis`` mesh axis takes the i-th of its
    equal parts of mb."""
    n, i = mesh.shape[axis], mesh.coordinate(axis)
    rows = next(iter(batch.values())).shape[1] // n
    return {k: v[:, i * rows:(i + 1) * rows] for k, v in batch.items()}


def make_meta_train_step(model, *, beta: float = 0.01, alpha: float = 0.5,
                         mesh=None) -> Callable:
    """TinyReptile round. batch: {"tokens": (K, mb, S), "labels": ...}.

    ``step(phi, batch, alpha)`` returns (new_phi, metrics): the mean,
    first and last inner losses as fp32 tensors on the device. ``alpha``
    is a float or a one-element fp32 tensor on phi's device.

    ``mesh`` (a ``ProcessMesh`` with a ``data`` axis: the JAX launcher's
    ``--mesh data``, the cohort step) splits each microbatch over the
    data axis's ranks: each takes its rows (``data_rows``) and the inner
    step's gradient is summed to the whole microbatch's mean on every
    rank (``streaming_sgd(group=)``), so phi stays the same on every
    rank. The JAX package also shards leaves over 32 MB on ``data``
    (FSDP), which saves memory only; here they stay whole on every rank.
    """
    group = mesh.group("data") if mesh is not None else None

    def step(phi, batch, alpha=alpha):
        if mesh is not None:
            batch = data_rows(batch, mesh, "data")
        phi_hat, losses = streaming_sgd(model.loss_fn, phi, batch, beta,
                                        group)
        new_phi = tree_meta_update(phi, phi_hat, alpha)
        return new_phi, {"loss": losses.mean(), "inner_first": losses[0],
                         "inner_last": losses[-1]}

    return step


def make_joint_train_step(model, optimizer, schedule) -> Callable:
    """Baseline joint training (the transfer-learning / FedAVG-objective
    regime the paper compares against): one optimizer step per batch.

    ``step(params, opt_state, opt_step, batch)`` returns ``(params,
    opt_state, opt_step + 1, {"loss", "lr"})``: the loss an fp32 tensor
    on the device, lr the schedule's float32 at ``opt_step`` (an int)."""
    def step(params, opt_state, opt_step, batch):
        leaves = dict(tree_leaves(params))
        live = {k: v.detach().requires_grad_() for k, v in leaves.items()}
        loss = model.loss_fn(unflatten_tree(live), batch)
        grads = unflatten_tree(dict(zip(live, torch.autograd.grad(
            loss, list(live.values())))))
        lr = schedule(opt_step)
        with torch.no_grad():
            new_params, new_state = optimizer.update(grads, opt_state,
                                                     params, lr)
        return new_params, new_state, opt_step + 1, {"loss": loss.detach(),
                                                     "lr": lr}
    return step


def make_prefill_step(model) -> Callable:
    """``step(params, batch)`` is ``model.prefill_fn`` without autograd:
    the last-token logits (B, 1, V) fp32."""
    def step(params, batch):
        with torch.no_grad():
            return model.prefill_fn(params, batch)
    return step


def make_decode_step(model) -> Callable:
    """One decode step: ``step(params, batch)`` is ``model.decode_fn``
    (batch: tokens (B, 1), cache, cache_len), returning (logits, cache)."""
    def step(params, batch):
        return model.decode_fn(params, batch)
    return step


class DecodeRunner:
    """Greedy decoding of waves of ``batch`` prompts of ``prompt_len``
    tokens, ``max_new`` new tokens each, as one step built once and
    replayed (``graphs.GraphStep``: a CUDA graph on the card, the same
    function run eagerly on the CPU).

    The step reads and writes only buffers at fixed addresses: the
    wave's prompts (B, P), an int32 cursor (the position), one KV cache of
    (B, ``cache_len``, Kv, hd) per attention application, the logits (B,
    1, V) fp32 and every step's argmax (B, P + ``max_new``); a Mamba2
    layer's cache is its conv window and fp32 state instead, written in
    place (``copy_``) at every step. At cursor c it takes the prompt's
    token c while c < P, else the argmax of step c - 1; runs
    ``decode_fn`` at c; writes the logits and their argmax at c; and
    advances the cursor, all on the device. A wave is P + ``max_new``
    steps from a reset cursor; its new tokens are the argmaxes of steps
    P - 1 ... P + ``max_new`` - 2, read once. A KV cache is reused across
    waves: each step writes row c before it attends to rows [0, c], and
    nothing reads past them. A Mamba2 state carries the whole past, so
    each wave zeroes it first, as the JAX launcher starts each wave from
    a fresh cache. An encoder-decoder's cross cache is read, never
    written: it keeps its zeros (as the JAX launcher leaves it) through
    the build and every wave.

    ``step()`` runs one step at the cursor (``wave`` runs a whole wave);
    ``trace_count`` counts the builds (1), ``capture_s`` and ``nodes``
    describe the capture on the card (None on the CPU).

    The ``ringkv`` lever is read once, when the cache is made, and kept
    as ``ring``: a windowed layer's cache is then a ring of ``window``
    rows, and every step runs under that setting, so the cache, the
    built step and the route always agree (a cache that does not match
    ``ring`` raises). ``cache_len`` stays the logical length: prompt and
    new tokens must fit in it, whatever a ring holds; the prompt buffer
    and the chosen tokens are sized by the steps."""

    def __init__(self, model, params, *, batch: int, prompt_len: int,
                 cache_len: int, max_new: int, device: DeviceLike = None):
        if prompt_len < 1 or max_new < 0 or prompt_len + max_new > cache_len:
            raise ValueError(f"DecodeRunner: a cache of {cache_len} cannot "
                             f"hold {prompt_len} prompt + {max_new} new "
                             f"tokens (prompt_len >= 1, max_new >= 0)")
        dev = resolve_device(device)
        self.model, self.params = model, params
        self.prompt_len, self.max_new = prompt_len, max_new
        self.steps = prompt_len + max_new
        self.prompts = torch.zeros((batch, prompt_len), dtype=torch.int64,
                                   device=dev)
        self.cursor = torch.zeros(1, dtype=torch.int32, device=dev)
        self.ring = feature("ringkv")
        self._rows = model.cache_rows(cache_len)
        self.cache = model.init_cache(batch, cache_len, device=dev)
        # the recurrent entries (every Mamba2 layer's, wherever the cache
        # holds them), zeroed at each wave
        self._recurrent = [t for path, t in tree_leaves(self.cache)
                           if path[-1] in ("conv", "ssm")]
        self.logits = torch.zeros((batch, 1, model.cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        self.chosen = torch.zeros((batch, self.steps), dtype=torch.int64,
                                  device=dev)
        self.trace_count = 0
        self.step = GraphStep(weak_method(self._decode_step), dev)

    @property
    def capture_s(self) -> Optional[float]:
        return self.step.capture_s

    @property
    def nodes(self) -> Optional[int]:
        return self.step.nodes

    def _check_cache(self) -> None:
        """The cache's KV rows must be what ``ring`` gives the model."""
        got = [e["k"].shape[1] if "k" in e else None
               for e in self.cache["layers"]]
        if got != self._rows:
            raise ValueError(f"DecodeRunner: the cache's KV rows {got} do "
                             f"not match the route it was built for "
                             f"(ring={self.ring}: {self._rows})")

    def _decode_step(self) -> None:
        c, P = self.cursor, self.prompt_len
        with torch.no_grad(), feature_scope(ringkv=self.ring):
            tokens = torch.where(
                c < P, self.prompts.index_select(1, c.clamp(max=P - 1)),
                self.chosen.index_select(1, (c - 1).clamp(min=0)))
            logits, _ = self.model.decode_fn(self.params, {
                "tokens": tokens, "cache": self.cache, "cache_len": c})
            self.logits.copy_(logits)
            self.chosen[:, c] = logits[:, 0].argmax(dim=-1, keepdim=True)
            c.add_(1)

    def build(self) -> None:
        """Build the step once (on the card: run it, then capture it) on
        whatever the buffers hold; each wave starts from a reset cursor."""
        self._check_cache()
        if not self.step.ready:
            self.cursor.zero_()
            self.step()
            self.trace_count += 1

    def wave(self, prompts: torch.Tensor,
             on_logits: Optional[Callable] = None) -> List[List[int]]:
        """Decode one wave: ``prompts`` (B, P) integer tokens on any
        device. ``on_logits(logits)`` gets a copy of every step's logits
        (the buffer is overwritten by the next step). Returns each slot's
        ``max_new`` new tokens."""
        self.build()
        self.prompts.copy_(prompts)
        self.cursor.zero_()
        for t in self._recurrent:
            t.zero_()
        for _ in range(self.steps):
            self.step()
            if on_logits is not None:
                on_logits(self.logits.clone())
        return self.chosen[:, self.prompt_len - 1:self.steps - 1].tolist()


def microbatch(batch: Dict[str, Any], k: int) -> Dict[str, Any]:
    """Reshape (B, ...) arrays to (k, B//k, ...) inner-stream
    microbatches (NumPy arrays or tensors)."""
    def r(x):
        b = x.shape[0]
        return x.reshape(k, b // k, *x.shape[1:])
    return {name: r(x) for name, x in batch.items()}


def prefetch_batches(make_batch: Callable[[int], Any], num_batches: int,
                     depth: int = 2) -> Iterator[Any]:
    """Yield ``make_batch(i)`` for ``i in range(num_batches)``, built by
    a background thread strictly in index order, so a seeded host RNG
    drawn inside it gives exactly the synchronous sequence (``depth=0``
    calls it inline)."""
    return prefetch_items(make_batch, num_batches, depth=depth)
