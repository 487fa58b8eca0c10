"""Model assembly for the LM family, the port of the JAX package's
``models/transformer.py``: decoder LMs built from an ``ArchConfig``.

Ported so far: the SSM family (Mamba2 blocks, e.g. mamba2-130m) on the
train/prefill path: ``Model.init``, ``loss_fn`` (mean next-token cross
entropy) and ``prefill_fn`` (last-token logits). Attention, MoE, hybrid
and encoder-decoder blocks, and the decode path, raise "not ported yet".

The port keeps ``params["layers"]`` as a list with one dict per layer.
The JAX package stacks the layers of a homogeneous model of four or more
layers over a leading axis (scan over layers, ``Model.use_scan``);
``bridge.lm_params_from_jax`` / ``lm_params_to_jax`` map between the two
layouts with ``Model.scan_period``. The JAX package recomputes each layer
group's forward in the backward pass (``jax.checkpoint``); the port
keeps the activations instead (they fit on the card), so the ``ssd_scan``
kernel runs once per layer per forward and not again in the backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.bridge import tree_leaves, unflatten_tree
from repro_torch.configs.base import ATTN, MAMBA, MOE, SHARED_ATTN, ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models.layers import normal_init, rms_norm

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


def _block_shapes(cfg: ArchConfig, kind: str, dtype) -> Dict[str, Any]:
    if kind != MAMBA:
        raise NotImplementedError(
            f"{kind!r} blocks are not ported yet: the port runs the SSM "
            f"family (Mamba2 blocks)")
    d = cfg.d_model
    return {"norm1": ((d,), dtype),
            "mamba": mamba_lib.mamba_shapes(
                d, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand,
                cfg.ssm_conv_width, dtype)}


#: leaves that start at zero (norm weights, used as 1 + w, and biases)
_ZERO_LEAVES = ("final_norm", "norm1", "dt_bias", "conv_b", "gate_norm")


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


def _apply_block(cfg: ArchConfig, kind: str, bp, x):
    """Forward one block (train/prefill); the SSM family's blocks carry
    no auxiliary loss."""
    h = mamba_lib.mamba_block(
        bp["mamba"], rms_norm(x, bp["norm1"], cfg.norm_eps),
        d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand, conv_width=cfg.ssm_conv_width,
        chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps)
    return x + h


@dataclasses.dataclass
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family != "ssm":
            raise NotImplementedError(
                f"the {self.cfg.family!r} family ({self.cfg.name}) is not "
                f"ported yet: the port runs the SSM family (mamba2)")
        if self.cfg.dtype not in _DTYPES:
            raise NotImplementedError(f"dtype {self.cfg.dtype!r}")

    # ----- structure ------------------------------------------------------
    @property
    def specs(self):
        return layer_specs(self.cfg)

    @property
    def use_scan(self) -> bool:
        """Whether the JAX package stacks this model's layers (a period
        of blocks repeated four or more times)."""
        p = find_period(self.specs)
        return len(self.specs) // p >= 4

    @property
    def scan_period(self) -> Optional[int]:
        """The JAX layout's stacking period, or None when it keeps one
        dict per layer."""
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
        shapes["layers"] = [_block_shapes(cfg, kind, dtype)
                            for kind, _ in self.specs]
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
        """Token embedding (the SSM family has no frontend)."""
        return params["embed"][batch["tokens"].long()]

    def _backbone(self, params, x):
        for bp, (kind, _) in zip(params["layers"], self.specs):
            x = _apply_block(self.cfg, kind, bp, x)
        return x

    def _lm_head(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    # ----- training loss ---------------------------------------------------
    def loss_fn(self, params, batch):
        """Mean next-token cross-entropy over labels != -1."""
        x = self._embed_inputs(params, batch)
        x = self._backbone(params, x)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return chunked_cross_entropy(x, self._lm_head(params),
                                     batch["labels"])

    # ----- prefill ----------------------------------------------------------
    def prefill_fn(self, params, batch):
        """Last-token logits (B, 1, V) in fp32."""
        x = self._embed_inputs(params, batch)
        x = self._backbone(params, x)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return (x[:, -1:] @ self._lm_head(params)).float()


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
