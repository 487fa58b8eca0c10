"""Model assembly for the LM family, the port of the JAX package's
``models/transformer.py``: decoder LMs built from an ``ArchConfig``.

Ported: the dense family (attention + MLP blocks: tinyllama-1.1b,
starcoder2-15b, glm4-9b, minicpm-2b), the MoE family (attention + MoE
blocks, ``models/moe.py``: mixtral-8x22b, llama4-maverick-400b-a17b,
whose dense and MoE blocks alternate), the SSM family (Mamba2 blocks,
mamba2-130m) and the hybrid family (Mamba2 blocks with one weight-shared
attention block applied before each group of ``hybrid_attn_every``
of them and once more before the tail: zamba2-1.2b), on every path:
``Model.init``, ``loss_fn`` (mean next-token cross entropy, plus 0.01
times the MoE blocks' summed aux loss), ``prefill_fn`` (last-token
logits), ``init_cache`` and ``decode_fn``. Decode attention runs
through the ``flash_decode`` kernel, the Mamba2 train and prefill scan
through ``ssd_scan``; the train and prefill attention, the experts and
the Mamba2 decode step are plain tensor ops, as they are plain jnp in
the JAX package. The encoder-decoder and VLM families raise "not ported
yet".

The port keeps ``params["layers"]`` as a list with one dict per layer
(the hybrid's Mamba2 layers in order, its shared block beside them as
``params["shared_block"]``), and the decode cache as ``{"layers":
[entry per application]}``, one entry per ``layer_specs`` entry: ``{"k",
"v"}`` for an attention application (each of the hybrid's shared-block
applications has its own) and ``{"conv", "ssm"}`` for a Mamba2 layer.
The JAX package stacks the layers of a homogeneous model of four or
more layers over a leading axis (scan over layers, ``Model.use_scan``),
its cache too, and always stacks the hybrid's groups; ``bridge.
lm_params_from_jax`` / ``lm_params_to_jax`` and ``lm_cache_from_jax`` /
``lm_cache_to_jax`` map between the layouts with ``Model.jax_layout``.
Where it scans, the JAX package recomputes each layer group's forward in
the backward pass (``jax.checkpoint``); the port does the same one
attention or MoE block (and each shared-block application) at a time
(``torch.utils.checkpoint``, non-reentrant so ``torch.autograd.grad``
takes it), since their activations would not fit otherwise. The Mamba2
blocks keep their activations, so the ``ssd_scan`` kernel runs once per
layer per forward and not again in the backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.bridge import HybridLayout, tree_leaves, unflatten_tree
from repro_torch.configs.base import ATTN, MAMBA, MOE, SHARED_ATTN, ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import mlp, mlp_shapes, normal_init, rms_norm

AUX_LOSS_WEIGHT = 0.01
LABEL_IGNORE = -1

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the families the port builds, each on every path
PORTED_FAMILIES = ("ssm", "dense", "moe", "hybrid")


def layer_specs(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """Per-application (kind, window) list, including SHARED_ATTN entries."""
    specs = []
    attn_idx = 0  # index among attention layers, for global_attn_every
    for kind in cfg.block_kinds():
        if kind in (ATTN, MOE):
            window = cfg.sliding_window
            if cfg.global_attn_every and (attn_idx + 1) % cfg.global_attn_every == 0:
                window = 0  # periodic global layer (llama4 iRoPE)
            attn_idx += 1
            specs.append((kind, window))
        elif kind == SHARED_ATTN:
            specs.append((SHARED_ATTN, cfg.sliding_window))
        else:
            specs.append((MAMBA, 0))
    return specs


def find_period(specs: List[Tuple[str, int]]) -> int:
    L = len(specs)
    for p in range(1, L + 1):
        if L % p == 0 and specs == specs[:p] * (L // p):
            return p
    return L


def _block_shapes(cfg: ArchConfig, kind: str, dtype) -> Dict[str, Any]:
    d = cfg.d_model
    if kind == MAMBA:
        return {"norm1": ((d,), dtype),
                "mamba": mamba_lib.mamba_shapes(
                    d, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand,
                    cfg.ssm_conv_width, dtype)}
    shapes = {"norm1": ((d,), dtype),
              "attn": attn_lib.attention_shapes(
                  d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                  dtype),
              "norm2": ((d,), dtype)}
    if kind == MOE:
        shapes["moe"] = moe_lib.moe_shapes(d, cfg.d_ff, cfg.num_experts,
                                           cfg.shared_expert, dtype)
    else:
        shapes["mlp"] = mlp_shapes(d, cfg.d_ff, cfg.act, dtype)
    return shapes


#: leaves that start at zero (norm weights, used as 1 + w, and biases)
_ZERO_LEAVES = ("final_norm", "norm1", "norm2", "dt_bias", "conv_b",
                "gate_norm", "b_in", "b_out")


def _init_leaf(name, shape, dtype, gen, device):
    """The JAX package's init of one leaf, by its name: ``A_log =
    log(linspace(1, 16, H))``, ``D = 1``, zeros for norms and biases,
    ``normal_init`` for every matrix (and the conv taps)."""
    if name == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[0],
                                        dtype=dtype)).to(device)
    if name == "D":
        return torch.ones(shape, dtype=dtype, device=device)
    if name in _ZERO_LEAVES:
        return torch.zeros(shape, dtype=dtype, device=device)
    return normal_init(gen, shape, 1.0, dtype, device)


def _apply_block(cfg: ArchConfig, kind: str, window: int, bp, x):
    """Forward one block (train/prefill). Returns (x, aux): the MoE
    block's aux loss, None for a block without experts (the JAX package
    adds an exact 0 there)."""
    eps = cfg.norm_eps
    if kind == MAMBA:
        return x + mamba_lib.mamba_block(
            bp["mamba"], rms_norm(x, bp["norm1"], eps),
            d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
            expand=cfg.ssm_expand, conv_width=cfg.ssm_conv_width,
            chunk=cfg.ssm_chunk, norm_eps=eps), None
    x = x + attn_lib.attention_block(
        bp["attn"], rms_norm(x, bp["norm1"], eps),
        num_kv_heads=cfg.num_kv_heads, rope_theta=cfg.rope_theta,
        causal=True, window=window)
    return _ffn(cfg, kind, bp, x)


def _ffn(cfg: ArchConfig, kind: str, bp, x):
    """The block's second half on x: the MLP, or the experts with their
    aux loss. Returns (x, aux or None)."""
    y_in = rms_norm(x, bp["norm2"], cfg.norm_eps)
    if kind == MOE:
        y, aux = moe_lib.moe_block(bp["moe"], y_in,
                                   experts_per_token=cfg.experts_per_token)
        return x + y, aux
    return x + mlp(bp["mlp"], y_in, cfg.act), None


@dataclasses.dataclass
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"the {self.cfg.family!r} family ({self.cfg.name}) is not "
                f"ported yet: the port runs the dense, MoE, SSM and hybrid "
                f"families, each on its train, prefill and decode paths "
                f"(ROADMAP queue A item 6f)")
        if self.cfg.dtype not in _DTYPES:
            raise NotImplementedError(f"dtype {self.cfg.dtype!r}")

    # ----- structure ------------------------------------------------------
    @property
    def specs(self):
        return layer_specs(self.cfg)

    @property
    def is_hybrid(self) -> bool:
        return self.cfg.family == "hybrid"

    @property
    def use_scan(self) -> bool:
        """Whether the JAX package stacks this model's layers (a period
        of blocks repeated four or more times; never for the hybrid,
        whose groups it stacks in a layout of their own)."""
        if self.is_hybrid:
            return False
        p = find_period(self.specs)
        return len(self.specs) // p >= 4

    @property
    def jax_layout(self):
        """The JAX package's layer layout, as the bridge takes it: its
        stacking period (an int), None where it keeps one dict per layer,
        or ``bridge.HybridLayout`` for the hybrid family."""
        if self.is_hybrid:
            return HybridLayout(self.cfg.hybrid_attn_every)
        return find_period(self.specs) if self.use_scan else None

    def param_shapes(self) -> Dict[str, Any]:
        """The params tree with ``(shape, dtype)`` leaves."""
        cfg = self.cfg
        dtype = _DTYPES[cfg.dtype]
        shapes: Dict[str, Any] = {
            "embed": ((cfg.vocab_size, cfg.d_model), dtype),
            "final_norm": ((cfg.d_model,), dtype)}
        if not cfg.tie_embeddings:
            shapes["lm_head"] = ((cfg.d_model, cfg.vocab_size), dtype)
        if self.is_hybrid:
            shapes["shared_block"] = _block_shapes(cfg, ATTN, dtype)
        shapes["layers"] = [_block_shapes(cfg, kind, dtype)
                            for kind, _ in self.specs if kind != SHARED_ATTN]
        return shapes

    # ----- init -----------------------------------------------------------
    def init(self, gen: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        """Random params on ``device`` (default ``cuda``; the CPU only
        when asked), drawn on the CPU from ``gen``, so one seed gives the
        same weights on every device (torch's numbers: to start from the
        JAX package's init, carry it over with
        ``bridge.lm_params_from_jax``)."""
        dev = resolve_device(device)
        return unflatten_tree({
            path: _init_leaf(path[-1], shape, dtype, gen, dev)
            for path, (shape, dtype) in tree_leaves(self.param_shapes())})

    # ----- forward pieces ---------------------------------------------------
    def _embed_inputs(self, params, batch):
        """Token embedding (these families have no frontend)."""
        return params["embed"][batch["tokens"].long()]

    def _blocks(self, params):
        """``(kind, window, block params)`` per application, in order: the
        hybrid's shared block at each ``SHARED_ATTN`` entry (applied as an
        attention block), one dict of ``params["layers"]`` at each other
        entry."""
        layers = iter(params["layers"])
        for kind, window in self.specs:
            if kind == SHARED_ATTN:
                yield ATTN, window, params["shared_block"]
            else:
                yield kind, window, next(layers)

    def _backbone(self, params, x):
        """All blocks. Returns (x, the summed MoE aux loss or None).
        Where the JAX package scans the layers (and always for the
        hybrid), each attention or MoE block's forward is recomputed in
        the backward."""
        recompute = ((self.use_scan or self.is_hybrid)
                     and torch.is_grad_enabled())
        aux = None
        for kind, window, bp in self._blocks(params):
            if recompute and kind != MAMBA:
                x, a = checkpoint(_apply_block, self.cfg, kind, window, bp,
                                  x, use_reentrant=False)
            else:
                x, a = _apply_block(self.cfg, kind, window, bp, x)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def _lm_head(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    # ----- training loss ---------------------------------------------------
    def loss_fn(self, params, batch):
        """Mean next-token cross-entropy over labels != -1, plus
        ``AUX_LOSS_WEIGHT`` times the MoE blocks' aux loss."""
        x = self._embed_inputs(params, batch)
        x, aux = self._backbone(params, x)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        loss = chunked_cross_entropy(x, self._lm_head(params),
                                     batch["labels"])
        return loss if aux is None else loss + AUX_LOSS_WEIGHT * aux

    # ----- prefill ----------------------------------------------------------
    def prefill_fn(self, params, batch):
        """Last-token logits (B, 1, V) in fp32."""
        x = self._embed_inputs(params, batch)
        x, _ = self._backbone(params, x)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return (x[:, -1:] @ self._lm_head(params)).float()

    # ----- decode -----------------------------------------------------------
    def init_cache(self, batch_size: int, seq_len: int,
                   device: DeviceLike = None) -> Dict[str, Any]:
        """The decode cache on ``device`` (default ``cuda``), zeros, one
        entry per ``specs`` entry: ``{"k", "v"}`` (batch, seq_len, Kv, hd)
        in the model dtype for an attention application (the hybrid's
        shared block gets one at each application); ``{"conv"}`` (batch,
        W - 1, conv_dim) in the model dtype and ``{"ssm"}`` (batch,
        heads, head_dim, d_state) fp32 for a Mamba2 layer, which holds no
        sequence axis (``bridge.lm_cache_from_jax`` maps the JAX
        package's layouts)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = _DTYPES[cfg.dtype]
        layers = []
        for kind, _ in self.specs:
            if kind == MAMBA:
                _, nheads, conv_dim = mamba_lib.mamba_dims(
                    cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                    cfg.ssm_state)
                layers.append({
                    "conv": torch.zeros(
                        (batch_size, cfg.ssm_conv_width - 1, conv_dim),
                        dtype=dtype, device=dev),
                    "ssm": torch.zeros(
                        (batch_size, nheads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=dev)})
            else:
                shape = (batch_size, seq_len, cfg.num_kv_heads,
                         cfg.resolved_head_dim)
                layers.append({
                    "k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)})
        return {"layers": layers}

    def _decode_block(self, kind, window, bp, x, entry, cache_len, rope):
        """One block on one token; writes its cache entry in place (K and
        V at ``cache_len``, or the Mamba2 conv window and state). A MoE
        block dispatches the step's B tokens as the train path does."""
        cfg = self.cfg
        eps = cfg.norm_eps
        if kind == MAMBA:
            out, conv, ssm = mamba_lib.mamba_decode_block(
                bp["mamba"], rms_norm(x, bp["norm1"], eps), entry["conv"],
                entry["ssm"], d_state=cfg.ssm_state,
                head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
                conv_width=cfg.ssm_conv_width, norm_eps=eps)
            entry["conv"].copy_(conv)
            entry["ssm"].copy_(ssm)
            return x + out
        out, _, _ = attn_lib.decode_attention_block(
            bp["attn"], rms_norm(x, bp["norm1"], eps), entry["k"],
            entry["v"], cache_len, rope, window=window)
        return _ffn(cfg, kind, bp, x + out)[0]

    def decode_fn(self, params, batch):
        """One decode step. batch: ``tokens`` (B, 1), ``cache``
        (``init_cache``), ``cache_len`` (the position this token takes: an
        int, or an int32 tensor of one element on the device, as the JAX
        package's ``decode_fn`` takes a traced scalar). Returns (logits
        (B, 1, V) fp32, the cache).

        The cache is updated in place and returned (the JAX package
        returns a new one): a caller never reuses a cache from before a
        step. Each attention application launches ``flash_decode`` once
        on the card; its RoPE angles are computed once for all layers. A
        Mamba2 layer reads no position: its entry carries the whole past.
        A tensor ``cache_len`` is never read on the host, so the step can
        be captured once and replayed at every position
        (``runtime/steps.py::DecodeRunner``); its caller keeps it below
        the cache length."""
        cfg = self.cfg
        tokens, cache, cache_len = (batch["tokens"], batch["cache"],
                                    batch["cache_len"])
        x = params["embed"][tokens.long()]
        rope = None
        if any(kind != MAMBA for kind, _ in self.specs):
            if isinstance(cache_len, torch.Tensor):
                pos = cache_len.reshape(1, 1).expand(tuple(tokens.shape))
            else:
                pos = torch.full(tuple(tokens.shape), cache_len,
                                 dtype=torch.int32, device=x.device)
            rope = attn_lib.rope_angles(pos, cfg.resolved_head_dim,
                                        cfg.rope_theta)
        for (kind, window, bp), entry in zip(self._blocks(params),
                                             cache["layers"]):
            x = self._decode_block(kind, window, bp, x, entry, cache_len,
                                   rope)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (x @ self._lm_head(params)).float(), cache


def chunked_cross_entropy(x, lm_head, labels, chunk=1024):
    """Mean cross entropy over the sequence in chunks of ``chunk``
    positions, so the fp32 logits of the whole sequence never exist at
    once. x: (B, S, d); labels: (B, S), -1 ignored."""
    B, S, d = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=LABEL_IGNORE)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, x.shape[1], chunk):
        xc, lc = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk].long()
        logits = (xc @ lm_head).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
        valid = lc != LABEL_IGNORE
        nll = torch.where(valid, logz - gold, torch.zeros_like(logz))
        total = total + nll.sum()
        count = count + valid.sum()
    return total / count.clamp(min=1)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
