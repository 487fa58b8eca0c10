"""Model assembly for the LM family, the port of the JAX package's
``models/transformer.py``: decoder LMs built from an ``ArchConfig``.

Every family of the JAX package: the dense family (attention + MLP
blocks: tinyllama-1.1b, starcoder2-15b, glm4-9b, minicpm-2b), the MoE
family (attention + MoE blocks, ``models/moe.py``: mixtral-8x22b,
llama4-maverick-400b-a17b, whose dense and MoE blocks alternate), the SSM
family (Mamba2 blocks, mamba2-130m), the hybrid family (Mamba2 blocks
with one weight-shared attention block applied before each group of
``hybrid_attn_every`` of them and once more before the tail:
zamba2-1.2b), the encoder-decoder whisper-tiny (an encoder over
precomputed frame embeddings with sinusoidal positions, decoder blocks
with cross-attention, sinusoidal positions and no RoPE) and the VLM
paligemma-3b (patch embeddings through ``vision_proj`` prepended to the
text, the loss over the text only), on every path: ``Model.init``,
``loss_fn`` (mean next-token cross entropy, plus 0.01 times the MoE
blocks' summed aux loss), ``prefill_fn`` (last-token logits),
``init_cache`` and ``decode_fn``. Decode attention (whisper's cross
step too) runs through the ``flash_decode`` kernel, the Mamba2 train and
prefill scan through ``ssd_scan``; the train and prefill attention, the
experts and the Mamba2 decode step are plain tensor ops, as they are
plain jnp in the JAX package. As there, decode starts from a cross cache
of zeros (``init_cache``): no path fills it from an encoder run.

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

On the engine's 2-D ``("clients", "model")`` route the params are this
rank's shards, as the run's ``ModelPartitioner`` splits them, and the
engine installs its ``runtime.sharding.ModelShards`` for the thread
that computes (``active_model_shards``). ``loss_fn`` then computes
tensor-parallel where the rules give Megatron's layout: an attention
sub-block whose ``wq``/``wk``/``wv`` are split on their heads and ``wo``
on its heads runs on this rank's heads, and the SwiGLU MLP whose
``w_gate``/``w_up`` and ``w_down`` are split on ``d_ff`` on this rank's
slice of it, each between ``copy_to_model`` (before the column-parallel
products) and ``reduce_from_model`` (after ``wo`` and ``w_down``, the
partial products summed in fp32, where one GEMM keeps its fp32
accumulator); the embedding looks up this rank's vocab rows and sums,
and the cross entropy is vocab-parallel (the maxima, the exponentials'
sums and the gold logits over the model group). Every other split leaf
(a Mamba2 block's, the experts', the encoder's and the cross
attention's, ``vision_proj``, any leaf of a user's partitioner) is
gathered inside the block that uses it and freed after it
(``ModelShards.gathered``; its gradient is this rank's slice). With no
shards installed (``mesh=None``, 1-D meshes, a model extent of 1) every
path runs as above.

``runtime/flags.py``: under probe mode nothing is stacked, as in the
JAX package (``jax_layout`` is None for a homogeneous model, so the
bridge carries the per-layer layout); its one-chunk cross entropy and
unrolled loops, which serve XLA's cost analysis, compute what the
default route computes and are not taken. With the ``ringkv`` lever a
windowed attention application's decode cache has ``min(seq_len,
window)`` rows, a ring (``models/attention.py::decode_attention_block``).
"""
from __future__ import annotations

import dataclasses
import functools
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
from repro_torch.models.layers import (mlp, mlp_partial, mlp_shapes,
                                       normal_init, rms_norm)
from repro_torch.runtime.flags import feature, probe_mode
from repro_torch.runtime.sharding import (active_model_shards, copy_to_model,
                                          max_over_model, reduce_from_model)

AUX_LOSS_WEIGHT = 0.01
LABEL_IGNORE = -1

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _sinusoidal(positions, d_model):
    """positions: (S,) or (B, S) -> (..., d_model) fp32: sin then cos of
    ``positions * exp(-i log(10000) / max(half - 1, 1))``, the JAX
    package's fp32 frequencies. Made on the positions' device (an int32
    cursor there is never read on the host)."""
    half = d_model // 2
    # log(10000) and its quotient rounded to fp32, as jnp computes them
    step = (torch.log(torch.tensor(10000.0)) / max(half - 1, 1)).item()
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) * step)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _block_shapes(cfg: ArchConfig, kind: str, dtype,
                  cross: bool = False) -> Dict[str, Any]:
    d = cfg.d_model
    if kind == MAMBA:
        return {"norm1": ((d,), dtype),
                "mamba": mamba_lib.mamba_shapes(
                    d, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand,
                    cfg.ssm_conv_width, dtype)}
    attn = attn_lib.attention_shapes(d, cfg.num_heads, cfg.num_kv_heads,
                                     cfg.resolved_head_dim, dtype)
    shapes = {"norm1": ((d,), dtype), "attn": attn, "norm2": ((d,), dtype)}
    if cross:
        shapes["norm_x"] = ((d,), dtype)
        shapes["cross"] = dict(attn)
    if kind == MOE:
        shapes["moe"] = moe_lib.moe_shapes(d, cfg.d_ff, cfg.num_experts,
                                           cfg.shared_expert, dtype)
    else:
        shapes["mlp"] = mlp_shapes(d, cfg.d_ff, cfg.act, dtype)
    return shapes


#: leaves that start at zero (norm weights, used as 1 + w, and biases)
_ZERO_LEAVES = ("final_norm", "norm1", "norm2", "norm_x", "dt_bias",
                "conv_b", "gate_norm", "b_in", "b_out")


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


def _apply_block(cfg: ArchConfig, kind: str, window: int, bp, x,
                 enc_out=None, use_rope=True):
    """Forward one block (train/prefill). Returns (x, aux): the MoE
    block's aux loss, None for a block without experts (the JAX package
    adds an exact 0 there). A decoder block of the encoder-decoder family
    (``"cross"`` in bp) attends to ``enc_out`` after its self-attention."""
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
        causal=True, window=window, use_rope=use_rope)
    if "cross" in bp:
        x = x + attn_lib.attention_block(
            bp["cross"], rms_norm(x, bp["norm_x"], eps),
            num_kv_heads=cfg.num_kv_heads, rope_theta=cfg.rope_theta,
            causal=False, kv_x=enc_out, use_rope=False)
    return _ffn(cfg, kind, bp, x)


#: the splits the tensor-parallel attention and MLP take (leaf -> dim)
_ATTN_TP = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
_MLP_TP = {"w_gate": 1, "w_up": 1, "w_down": 0}


def _apply_block_tp(tp, at, cfg: ArchConfig, kind: str, window: int, bp, x,
                    enc_out=None, use_rope=True):
    """``_apply_block`` on this rank's shards of block ``at`` (its path):
    the attention on this rank's heads and the SwiGLU MLP on its slice of
    ``d_ff`` where the specs split them so, every other split leaf of the
    block gathered here. A Mamba2 block and an encoder-decoder block are
    computed whole on their gathered leaves."""
    if kind == MAMBA or "cross" in bp:
        return _apply_block(cfg, kind, window, tp.gathered(bp, at), x,
                            enc_out, use_rope)
    eps = cfg.norm_eps
    attn_tp = tp.all_split(at + ("attn",), _ATTN_TP)
    mlp_tp = (kind != MOE and cfg.act == "silu"
              and tp.all_split(at + ("mlp",), _MLP_TP))
    keep = ([("attn", k) for k in _ATTN_TP] if attn_tp else []) + (
        [("mlp", k) for k in _MLP_TP] if mlp_tp else [])
    bp = tp.gathered(bp, at, keep)
    h = rms_norm(x, bp["norm1"], eps)
    if attn_tp:
        part = attn_lib.attention_block(
            bp["attn"], copy_to_model(h, tp.group),
            num_kv_heads=cfg.num_kv_heads // tp.parts,
            rope_theta=cfg.rope_theta, causal=True, window=window,
            use_rope=use_rope, partial=True)
        x = x + reduce_from_model(part, tp.group, torch.promote_types(
            h.dtype, bp["attn"]["wo"].dtype))
    else:
        x = x + attn_lib.attention_block(
            bp["attn"], h, num_kv_heads=cfg.num_kv_heads,
            rope_theta=cfg.rope_theta, causal=True, window=window,
            use_rope=use_rope)
    if not mlp_tp:
        return _ffn(cfg, kind, bp, x)
    y_in = copy_to_model(rms_norm(x, bp["norm2"], eps), tp.group)
    part = mlp_partial(bp["mlp"], y_in)
    return x + reduce_from_model(part, tp.group, torch.promote_types(
        y_in.dtype, bp["mlp"]["w_down"].dtype)), None


def _embed_tp(tp, table, tokens):
    """The embedding of ``tokens`` from this rank's vocab rows of the
    table (split on dim 0): its rows where the token falls in them,
    zeros elsewhere, summed over the model group (exact: one term of
    each sum is not 0)."""
    n = table.shape[0]
    t = tokens.long() - tp.index * n
    inside = (t >= 0) & (t < n)
    rows = table[t.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model(rows, tp.group, table.dtype)


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
    def is_encdec(self) -> bool:
        return self.cfg.encoder_layers > 0

    @property
    def use_scan(self) -> bool:
        """Whether the JAX package stacks this model's layers (a period
        of blocks repeated four or more times; never for the hybrid,
        whose groups it stacks in a layout of their own, nor for the
        encoder-decoder, nor in probe mode, which unrolls them)."""
        if probe_mode() or self.is_hybrid or self.is_encdec:
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
        shapes["layers"] = [_block_shapes(cfg, kind, dtype,
                                          cross=self.is_encdec)
                            for kind, _ in self.specs if kind != SHARED_ATTN]
        if self.is_encdec:
            shapes["encoder"] = {
                "layers": [_block_shapes(cfg, ATTN, dtype)
                           for _ in range(cfg.encoder_layers)],
                "final_norm": ((cfg.d_model,), dtype)}
        if cfg.frontend == "vision":
            shapes["vision_proj"] = ((cfg.d_model, cfg.d_model), dtype)
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
    def _encode(self, params, frames):
        """The encoder over precomputed frame embeddings (B, S, d) (the
        JAX package's stub frontend): sinusoidal positions in the frames'
        dtype, non-causal blocks without RoPE, the final norm. Runs in
        the frames' dtype where it is wider than the weights' (fp32
        frames against bf16 weights, promoted as in jnp)."""
        cfg = self.cfg
        x = frames + _sinusoidal(torch.arange(frames.shape[1],
                                              device=frames.device),
                                 cfg.d_model).to(frames.dtype)
        tp = active_model_shards()
        for i, bp in enumerate(params["encoder"]["layers"]):
            if tp is not None:
                bp = tp.gathered(bp, ("encoder", "layers", i))
            x = x + attn_lib.attention_block(
                bp["attn"], rms_norm(x, bp["norm1"], cfg.norm_eps),
                num_kv_heads=cfg.num_kv_heads, rope_theta=cfg.rope_theta,
                causal=False, use_rope=False)
            x = x + mlp(bp["mlp"], rms_norm(x, bp["norm2"], cfg.norm_eps),
                        cfg.act)
        norm = params["encoder"]["final_norm"]
        if tp is not None:
            norm = tp.gather(("encoder", "final_norm"), norm)
        return rms_norm(x, norm, cfg.norm_eps)

    def _embed_inputs(self, params, batch):
        """Token (and frontend) embedding. Returns (x, enc_out, offset):
        the VLM's patch embeddings (cast to x's dtype, times
        ``vision_proj``) go in front of the text, ``offset`` of them; the
        encoder-decoder's tokens get sinusoidal positions and its encoder
        runs over ``batch["frames"]``."""
        tp = active_model_shards()
        if tp is not None and tp.dim(("embed",)) == 0:
            x = _embed_tp(tp, params["embed"], batch["tokens"])
        else:
            x = self._leaf(params, "embed")[batch["tokens"].long()]
        enc_out, offset = None, 0
        if self.cfg.frontend == "vision" and "patch_embeds" in batch:
            patches = batch["patch_embeds"].to(x.dtype) @ self._leaf(
                params, "vision_proj")
            x = torch.cat([patches, x], dim=1)
            offset = patches.shape[1]
        if self.is_encdec:
            enc_out = self._encode(params, batch["frames"])
            x = x + _sinusoidal(torch.arange(x.shape[1], device=x.device),
                                self.cfg.d_model).to(x.dtype)
        return x, enc_out, offset

    def _blocks(self, params):
        """``(kind, window, block params)`` per application, in order: the
        hybrid's shared block at each ``SHARED_ATTN`` entry (applied as an
        attention block), one dict of ``params["layers"]`` at each other
        entry."""
        for kind, window, bp, _ in self._blocks_at(params):
            yield kind, window, bp

    def _blocks_at(self, params):
        """``_blocks`` with each block's path in the params tree."""
        i = 0
        for kind, window in self.specs:
            if kind == SHARED_ATTN:
                yield ATTN, window, params["shared_block"], ("shared_block",)
            else:
                yield kind, window, params["layers"][i], ("layers", i)
                i += 1

    @staticmethod
    def _leaf(params, name):
        """A top-level leaf whole: gathered at its use on the 2-D route."""
        tp = active_model_shards()
        leaf = params[name]
        return leaf if tp is None else tp.gather((name,), leaf)

    def _backbone(self, params, x, enc_out=None):
        """All blocks (the decoder's, attending to ``enc_out``, for the
        encoder-decoder). Returns (x, the summed MoE aux loss or None).
        Where the JAX package scans the layers (and always for the
        hybrid), each attention or MoE block's forward is recomputed in
        the backward."""
        recompute = ((self.use_scan or self.is_hybrid)
                     and torch.is_grad_enabled())
        use_rope = not self.is_encdec
        tp = active_model_shards()
        aux = None
        for kind, window, bp, at in self._blocks_at(params):
            apply = (_apply_block if tp is None
                     else functools.partial(_apply_block_tp, tp, at))
            if recompute and kind != MAMBA:
                x, a = checkpoint(apply, self.cfg, kind, window, bp,
                                  x, enc_out, use_rope, use_reentrant=False)
            else:
                x, a = apply(self.cfg, kind, window, bp, x, enc_out,
                             use_rope)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def _lm_head(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    # ----- training loss ---------------------------------------------------
    def loss_fn(self, params, batch):
        """Mean next-token cross-entropy over labels != -1 (the text
        positions only, behind a VLM's patches), plus ``AUX_LOSS_WEIGHT``
        times the MoE blocks' aux loss."""
        x, enc_out, offset = self._embed_inputs(params, batch)
        x, aux = self._backbone(params, x, enc_out)
        x = rms_norm(x, self._leaf(params, "final_norm"), self.cfg.norm_eps)
        if offset:
            x = x[:, offset:]
        tp = active_model_shards()
        head_vocab = (None if tp is None else
                      tp.dim(("embed",)) == 0 if self.cfg.tie_embeddings
                      else tp.dim(("lm_head",)) == 1)
        if head_vocab:
            loss = chunked_cross_entropy(copy_to_model(x, tp.group),
                                         self._lm_head(params),
                                         batch["labels"], vocab_shards=tp)
        else:
            head = (self._lm_head(params) if tp is None else
                    tp.gather(("embed",), params["embed"]).T
                    if self.cfg.tie_embeddings
                    else tp.gather(("lm_head",), params["lm_head"]))
            loss = chunked_cross_entropy(x, head, batch["labels"])
        return loss if aux is None else loss + AUX_LOSS_WEIGHT * aux

    # ----- prefill ----------------------------------------------------------
    def prefill_fn(self, params, batch):
        """Last-token logits (B, 1, V) in fp32."""
        x, enc_out, _ = self._embed_inputs(params, batch)
        x, _ = self._backbone(params, x, enc_out)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return (x[:, -1:] @ self._lm_head(params)).float()

    # ----- decode -----------------------------------------------------------
    def cache_rows(self, seq_len: int) -> List[Any]:
        """The rows of each ``specs`` entry's KV cache for ``seq_len``
        positions (None for a Mamba2 layer): ``min(seq_len, window)``
        for a windowed application under the ``ringkv`` lever (a ring;
        a periodic global layer's window is 0), else ``seq_len``."""
        ring = feature("ringkv")
        return [None if kind == MAMBA else
                min(seq_len, window) if ring and window else seq_len
                for kind, window in self.specs]

    def init_cache(self, batch_size: int, seq_len: int,
                   device: DeviceLike = None) -> Dict[str, Any]:
        """The decode cache on ``device`` (default ``cuda``), zeros, one
        entry per ``specs`` entry: ``{"k", "v"}`` (batch, rows, Kv, hd)
        in the model dtype for an attention application, rows by
        ``cache_rows`` (the hybrid's shared block gets one at each
        application); ``{"conv"}`` (batch, W - 1, conv_dim) in the model
        dtype and ``{"ssm"}`` (batch,
        heads, head_dim, d_state) fp32 for a Mamba2 layer, which holds no
        sequence axis (``bridge.lm_cache_from_jax`` maps the JAX
        package's layouts); for the encoder-decoder also ``"cross"``, a
        ``{"k", "v"}`` of (batch, encoder_tokens, Kv, hd) per decoder
        layer, zeros as the JAX package leaves them."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = _DTYPES[cfg.dtype]
        layers = []
        for (kind, _), rows in zip(self.specs, self.cache_rows(seq_len)):
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
                shape = (batch_size, rows, cfg.num_kv_heads,
                         cfg.resolved_head_dim)
                layers.append({
                    "k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)})
        cache = {"layers": layers}
        if self.is_encdec:
            shape = (batch_size, cfg.encoder_tokens, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            cache["cross"] = [
                {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
                for _ in self.specs]
        return cache

    def _decode_block(self, kind, window, bp, x, entry, cache_len, rope,
                      cross=None):
        """One block on one token; writes its cache entry in place (K and
        V at ``cache_len``, or the Mamba2 conv window and state). A MoE
        block dispatches the step's B tokens as the train path does. A
        decoder block of the encoder-decoder then attends to its ``cross``
        entry, all ``encoder_tokens`` rows of it (``flash_decode`` at that
        fixed length), with no new key written."""
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
        x = x + out
        if cross is not None:
            q = attn_lib.project(rms_norm(x, bp["norm_x"], eps),
                                 bp["cross"]["wq"])
            c = attn_lib.decode_attention(q, cross["k"], cross["v"],
                                          cfg.encoder_tokens)
            x = x + attn_lib.unproject(c, bp["cross"]["wo"])
        return _ffn(cfg, kind, bp, x)[0]

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
        the cache length (a ring's layers take any position). The
        encoder-decoder's token gets the sinusoidal position of
        ``cache_len`` (made on the device from a tensor cursor) instead
        of RoPE."""
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
            if self.is_encdec:
                x = x + _sinusoidal(pos, cfg.d_model).to(x.dtype)
            else:
                rope = attn_lib.rope_angles(pos, cfg.resolved_head_dim,
                                            cfg.rope_theta)
        crosses = cache.get("cross") or [None] * len(cache["layers"])
        for (kind, window, bp), entry, cross in zip(
                self._blocks(params), cache["layers"], crosses):
            x = self._decode_block(kind, window, bp, x, entry, cache_len,
                                   rope, cross)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (x @ self._lm_head(params)).float(), cache


def chunked_cross_entropy(x, lm_head, labels, chunk=1024,
                          vocab_shards=None):
    """Mean cross entropy over the sequence in chunks of ``chunk``
    positions, so the fp32 logits of the whole sequence never exist at
    once. x: (B, S, d); labels: (B, S), -1 ignored.

    ``vocab_shards`` (a ``ModelShards``): ``lm_head`` is this rank's
    slice of the vocab (its columns ``index * V_local`` on) and ``x`` the
    input of a column-parallel product; the logits' maximum, the sum of
    their exponentials and the gold logit are taken over the model
    group."""
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
        if vocab_shards is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                lc.clamp(min=0)[..., None])[..., 0]
        else:
            logz, gold = _vocab_parallel_terms(vocab_shards, logits, lc)
        valid = lc != LABEL_IGNORE
        nll = torch.where(valid, logz - gold, torch.zeros_like(logz))
        total = total + nll.sum()
        count = count + valid.sum()
    return total / count.clamp(min=1)


def _vocab_parallel_terms(tp, logits, labels):
    """logsumexp and the gold logit of fp32 ``logits`` (..., V_local),
    this rank's slice of the vocab, over the model group: the maximum
    (a constant of the gradient), the exponentials' sum and the gold
    logit (one rank's term, zeros elsewhere) summed there."""
    n = logits.shape[-1]
    m = max_over_model(logits.detach().amax(dim=-1), tp.group)
    sumexp = reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1),
                               tp.group)
    t = labels - tp.index * n
    inside = (t >= 0) & (t < n)
    mine = torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce_from_model(torch.where(inside, mine,
                                         torch.zeros_like(mine)), tp.group)
    return m + torch.log(sumexp), gold


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
