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
that computes (``active_model_shards``); so does the production step on
a ``("data", "model")`` mesh (``runtime/steps.py``), whose shards are
also split on ``data`` (FSDP): a tensor-parallel layer first gathers a
leaf's data parts (``ModelShards.model_part``), every other use gathers
the leaf whole. ``loss_fn`` then computes
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
path runs as above. ``prefill_fn`` runs the same blocks under the
shards, with the logits vocab-parallel and gathered; ``decode_fn`` under
a production decode step's shards, which carry its part of the cache,
runs each block through ``_decode_block_tp`` (the attention over the
rank's slice of a cache split on its sequence, the slices merged).

``runtime/flags.py``: under probe mode nothing is stacked, as in the
JAX package (``jax_layout`` is None for a homogeneous model, so the
bridge carries the per-layer layout); its one-chunk cross entropy and
unrolled loops, which serve XLA's cost analysis, compute what the
default route computes and are not taken. With the ``ringkv`` lever a
windowed attention application's decode cache has ``min(seq_len,
window)`` rows, a ring (``models/attention.py::decode_attention_block``).
The mesh levers act on a mesh step's shards or rows, read once a call
(``BatchRows.levers``): ``moelocal`` (the data mesh and the production
mesh) dispatches each batch rank's token group alone and changes the
function; ``moe2d`` (the production mesh) computes the experts on this
rank's 2-D shards of them (``_moe``); ``gqa_flat`` and ``seqpar`` (the
production mesh's train and prefill attention, ``_attention_route``)
attend this rank's heads with K and V repeated, or its query rows. With
no mesh, and on the 2-D route, none changes anything.
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
from repro_torch.runtime.shardctx import current_batch_rows
from repro_torch.runtime.sharding import (ModelShards, active_model_shards,
                                          copy_to_model, max_over_model,
                                          reduce_from_model)

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
                 enc_out=None, use_rope=True, rows=None):
    """Forward one block (train/prefill). Returns (x, aux): the MoE
    block's aux loss, None for a block without experts (the JAX package
    adds an exact 0 there). A decoder block of the encoder-decoder family
    (``"cross"`` in bp) attends to ``enc_out`` after its self-attention.
    ``rows``: the ``--mesh data`` step's ``BatchRows`` (``_moe``)."""
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
    return _ffn(cfg, kind, bp, x, rows)


#: the splits the tensor-parallel attention and MLP take (leaf -> dim)
_ATTN_TP = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
_MLP_TP = {"w_gate": 1, "w_up": 1, "w_down": 0}
#: the experts' leaves, which the ``moe2d`` lever keeps as local shards
_EXPERTS = ("w_gate", "w_up", "w_down")


def _attention_route(tp, at, cfg: ArchConfig, seq_len: int) -> str:
    """How the production mesh's train and prefill attention of block
    ``at`` runs on ``seq_len`` positions: ``seqpar`` (the lever, where
    ``model`` divides the sequence: this rank's query rows, every head),
    ``tp`` (the specs split ``wq``/``wk``/``wv``/``wo`` on heads: this
    rank's heads), ``gqa_flat`` (the lever, where ``wq`` and ``wo``
    split on heads and ``wk``/``wv`` do not: K and V whole, repeated to
    the heads, this rank's heads of them), else ``whole`` (every leaf
    gathered, every head)."""
    a = at + ("attn",)
    if "seqpar" in tp.levers and tp.group is not None \
            and seq_len % tp.parts == 0:
        return "seqpar"
    if tp.all_split(a, _ATTN_TP):
        return "tp"
    if "gqa_flat" in tp.levers and tp.all_split(a, {"wq": 1, "wo": 0}) \
            and cfg.num_kv_heads % tp.parts:
        return "gqa_flat"
    return "whole"


def _stationary_experts(tp, at, kind: str, tokens: int) -> bool:
    """Whether block ``at``'s experts stay this rank's shards (the
    ``moe2d`` lever, where the experts do not split on E over ``model``
    or ``data``) instead of being gathered whole, for this rank's
    ``tokens`` (B S). Under ``moelocal`` too, where its groups dispatch
    alone, the experts are gathered, as the JAX block's local route
    places no constraint on them."""
    if kind != MOE or "moe2d" not in tp.levers or tp.moe_groups(tokens) > 1:
        return False
    names = [at + ("moe", k) for k in _EXPERTS]
    return all(tp.dim(n) != 0 and tp.data_dims.get(n) != 0 for n in names)


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
    route = _attention_route(tp, at, cfg, x.shape[1])
    mlp_tp = (kind != MOE and cfg.act == "silu"
              and tp.all_split(at + ("mlp",), _MLP_TP))
    keep = ([("attn", k) for k in _ATTN_TP] if route == "tp" else
            [("attn", "wq"), ("attn", "wo")] if route == "gqa_flat"
            else []) + ([("mlp", k) for k in _MLP_TP] if mlp_tp else [])
    split = [("attn", k) for k in _ATTN_TP] if route == "seqpar" else \
        [("attn", "wk"), ("attn", "wv")] if route == "gqa_flat" else []
    local = ([("moe", k) for k in _EXPERTS] if _stationary_experts(
        tp, at, kind, x.shape[0] * x.shape[1]) else [])
    bp = tp.gathered(bp, at, keep, local + split)
    for _, k in split:     # each model rank computes a part of their work
        bp["attn"][k] = tp.gather_summed(at + ("attn", k), bp["attn"][k])
    h = rms_norm(x, bp["norm1"], eps)
    out_dtype = torch.promote_types(h.dtype, bp["attn"]["wo"].dtype)
    if route == "seqpar":
        n = x.shape[1] // tp.parts
        part = attn_lib.attention_rows(
            bp["attn"], copy_to_model(h, tp.group), tp.index * n, n,
            rope_theta=cfg.rope_theta, window=window, use_rope=use_rope)
        x = x + tp.gather_rows(part, 1)
    elif route in ("tp", "gqa_flat"):
        kv = cfg.num_kv_heads // tp.parts if route == "tp" else None
        part = attn_lib.attention_block(
            bp["attn"], copy_to_model(h, tp.group), num_kv_heads=kv,
            rope_theta=cfg.rope_theta, causal=True, window=window,
            use_rope=use_rope, partial=True,
            heads=None if route == "tp" else (tp.index, tp.parts))
        x = x + reduce_from_model(part, tp.group, out_dtype)
    else:
        x = x + attn_lib.attention_block(
            bp["attn"], h, num_kv_heads=cfg.num_kv_heads,
            rope_theta=cfg.rope_theta, causal=True, window=window,
            use_rope=use_rope)
    if not mlp_tp:
        return _ffn(cfg, kind, bp, x, tp, at)
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


def _ffn(cfg: ArchConfig, kind: str, bp, x, rows=None, at=()):
    """The block's second half on x: the MLP, or the experts with their
    aux loss (``_moe``). Returns (x, aux or None). ``rows``: the
    ``BatchRows`` of a mesh step (the production mesh's ``ModelShards``
    for block ``at``), passed in: a recompute in the backward may run on
    another thread."""
    y_in = rms_norm(x, bp["norm2"], cfg.norm_eps)
    if kind == MOE:
        y, aux = _moe(cfg, bp["moe"], y_in, rows, at)
        return x + y, aux
    return x + mlp(bp["mlp"], y_in, cfg.act), None


def _moe(cfg: ArchConfig, p, y_in, rows, at):
    """The MoE block on a mesh step's rows ``y_in`` (B, S, d), as the
    JAX package dispatches them:

    - under ``moelocal``, where the batch ranks divide the B S tokens
      (``BatchRows.moe_groups``), each group alone: where the batch is
      split over those ranks this rank's rows are its group (no row
      moves), else this rank holds every group and runs each
      (``moe_grouped``); the aux loss is the groups' mean;
    - else the whole batch's tokens: every batch rank's rows gathered
      (``all_rows``), dispatched, and this rank's taken back; under
      ``moe2d`` the experts computed on this rank's 2-D shards of them
      (``moe_lib.experts_2d``).

    With no mesh (``rows`` None) the block as it is."""
    k = cfg.experts_per_token
    if rows is None:
        return moe_lib.moe_block(p, y_in, experts_per_token=k)
    B, S, _ = y_in.shape
    groups = rows.moe_groups(B * S)
    if groups > 1:
        if rows.batch_axes:
            return moe_lib.moe_block(p, y_in, experts_per_token=k)
        return moe_lib.moe_grouped(p, y_in, groups, experts_per_token=k)
    experts = None
    if isinstance(rows, ModelShards) and _stationary_experts(rows, at, MOE,
                                                             B * S):
        experts = functools.partial(moe_lib.experts_2d, rows, at)
    y, aux = moe_lib.moe_block(p, rows.all_rows(y_in), experts_per_token=k,
                               experts=experts)
    return rows.own_rows(y, B), aux


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
        x = self._embed_tokens(params, batch["tokens"])
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

    def _embed_tokens(self, params, tokens):
        """The tokens' embedding: from this rank's vocab rows where the
        shards split ``embed`` on vocab (``_embed_tp``), else a lookup in
        the (gathered) table."""
        tp = active_model_shards()
        if tp is not None and tp.dim(("embed",)) == 0:
            return _embed_tp(tp, tp.model_part(("embed",), params["embed"]),
                             tokens)
        return self._leaf(params, "embed")[tokens.long()]

    def _logits(self, params, x):
        """``x @ the LM head`` in fp32. Under shards that split the head
        (``lm_head``, or the tied ``embed``) on vocab, vocab-parallel:
        this rank's columns, then every rank's gathered exactly
        (``ModelShards.gather_model``), so each rank has its rows' whole
        logits."""
        tp = active_model_shards()
        if tp is None:
            return (x @ self._lm_head(params)).float()
        tied = self.cfg.tie_embeddings
        if tp.dim(("embed",)) == 0 if tied else tp.dim(("lm_head",)) == 1:
            head = (tp.model_part(("embed",), params["embed"]).T if tied
                    else tp.model_part(("lm_head",), params["lm_head"]))
            return tp.gather_model(x @ head, x.dim() - 1).float()
        head = (tp.gather(("embed",), params["embed"]).T if tied
                else tp.gather(("lm_head",), params["lm_head"]))
        return (x @ head).float()

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
        rows = current_batch_rows() if tp is None else None
        aux = None
        for kind, window, bp, at in self._blocks_at(params):
            apply = (functools.partial(_apply_block, rows=rows) if tp is None
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
            head = (tp.model_part(("embed",), params["embed"]).T
                    if self.cfg.tie_embeddings
                    else tp.model_part(("lm_head",), params["lm_head"]))
            loss = chunked_cross_entropy(copy_to_model(x, tp.group), head,
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
        x = rms_norm(x, self._leaf(params, "final_norm"), self.cfg.norm_eps)
        return self._logits(params, x[:, -1:])

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
        layer, zeros as the JAX package leaves them. ``device="meta"``
        gives the cache's shapes and dtypes without allocating it
        (``launch/specs.py``)."""
        cfg = self.cfg
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
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

    def _decode_block_tp(self, tp, at, i, kind, window, bp, x, entry,
                         cache_len, rope, cross=None):
        """``_decode_block`` on this rank's shards of block ``at`` (its
        path) and its part of the cache (``tp.cache``, entry ``i``). The
        attention: where the specs split ``wq``/``wk``/``wv``/``wo`` on
        heads, q, k and v are projected for this rank's heads and
        gathered over ``model`` (exact), else computed whole from the
        gathered leaves; k and v go to the rank that owns ``cache_len``'s
        row, every rank attends over its slice of the cache for all heads
        and the slices are merged (``attention.cache_attention``); this
        rank's heads of the result go through the row-parallel ``wo``
        and ``reduce_from_model``. The cross-attention of the
        encoder-decoder attends its slice of the cross cache alike. The
        SwiGLU MLP is tensor-parallel where the specs split it so, the
        experts dispatch the whole batch's tokens. A Mamba2 layer runs
        whole on its gathered leaves: its ``ssm`` state, split on heads,
        is gathered, stepped, and this rank's heads written back."""
        cfg = self.cfg
        eps = cfg.norm_eps
        cs = tp.cache
        if kind == MAMBA:
            bp = tp.gathered(bp, at)
            name = ("layers", i, "ssm")
            out, conv, ssm = mamba_lib.mamba_decode_block(
                bp["mamba"], rms_norm(x, bp["norm1"], eps), entry["conv"],
                cs.gather(name, entry["ssm"], dims=(1,)),
                d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                expand=cfg.ssm_expand, conv_width=cfg.ssm_conv_width,
                norm_eps=eps)
            entry["conv"].copy_(conv)
            entry["ssm"].copy_(cs.local(name, ssm, dims=(1,)))
            return x + out
        attn_tp = tp.all_split(at + ("attn",), _ATTN_TP)
        mlp_tp = (kind != MOE and cfg.act == "silu"
                  and tp.all_split(at + ("mlp",), _MLP_TP))
        keep = ([("attn", k) for k in _ATTN_TP] if attn_tp else []) + (
            [("mlp", k) for k in _MLP_TP] if mlp_tp else [])
        local = ([("moe", k) for k in _EXPERTS] if _stationary_experts(
            tp, at, kind, x.shape[0] * x.shape[1]) else [])
        bp = tp.gathered(bp, at, keep, local)
        h = rms_norm(x, bp["norm1"], eps)
        a = bp["attn"]
        q, k, v = (attn_lib.project(h, a[w]) for w in ("wq", "wk", "wv"))
        if attn_tp:                     # every head, on every model rank
            q, k, v = (tp.gather_model(t, 2) for t in (q, k, v))
        if rope is not None:
            q, k = attn_lib.rotate(q, *rope), attn_lib.rotate(k, *rope)
        out = attn_lib.cache_attention(q, k, v, entry["k"], entry["v"],
                                       cache_len, window=window,
                                       seq=cs.seq(("layers", i, "k")))
        if attn_tp:
            n = out.shape[2] // tp.parts
            part = torch.einsum("bsnh,nhd->bsd",
                                out[:, :, tp.index * n:(tp.index + 1) * n]
                                .float(), a["wo"].float())
            x = x + reduce_from_model(part, tp.group, torch.promote_types(
                h.dtype, a["wo"].dtype))
        else:
            x = x + attn_lib.unproject(out, a["wo"])
        if cross is not None:
            seq = cs.seq(("cross", i, "k"))
            q = attn_lib.project(rms_norm(x, bp["norm_x"], eps),
                                 bp["cross"]["wq"])
            if seq is None:
                c = attn_lib.decode_attention(q, cross["k"], cross["v"],
                                              cfg.encoder_tokens)
            else:
                c = attn_lib.merge_partials(*attn_lib.decode_attention(
                    q, cross["k"], cross["v"], cfg.encoder_tokens,
                    offset=seq.offset, lse=True), seq.groups, q.dtype)[0]
            x = x + attn_lib.unproject(c, bp["cross"]["wo"])
        if not mlp_tp:
            return _ffn(cfg, kind, bp, x, tp, at)[0]
        part = mlp_partial(bp["mlp"], rms_norm(x, bp["norm2"], eps))
        return x + reduce_from_model(part, tp.group, torch.promote_types(
            x.dtype, bp["mlp"]["w_down"].dtype))

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
        of RoPE.

        Under a production decode step's shards (``active_model_shards``
        with a ``cache``: ``runtime/steps.py::make_decode_step(mesh=)``)
        the params are this rank's shards, the tokens its batch rows and
        the cache its part, split on the sequence over the ranks
        (``runtime.sharding.CacheShards``): each block runs
        ``_decode_block_tp``, and the logits are vocab-parallel where the
        head is split on vocab, gathered, (B_local, 1, V) fp32."""
        cfg = self.cfg
        tokens, cache, cache_len = (batch["tokens"], batch["cache"],
                                    batch["cache_len"])
        tp = active_model_shards()
        if tp is not None and tp.cache is None:
            raise ValueError("decode_fn: the shards installed carry no "
                             "cache shards (make_decode_step(mesh=) "
                             "installs them)")
        x = self._embed_tokens(params, tokens)
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
        for i, ((kind, window, bp, at), entry, cross) in enumerate(zip(
                self._blocks_at(params), cache["layers"], crosses)):
            if tp is None:
                x = self._decode_block(kind, window, bp, x, entry,
                                       cache_len, rope, cross)
            else:
                x = self._decode_block_tp(tp, at, i, kind, window, bp, x,
                                          entry, cache_len, rope, cross)
        x = rms_norm(x, self._leaf(params, "final_norm"), cfg.norm_eps)
        return self._logits(params, x), cache


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
