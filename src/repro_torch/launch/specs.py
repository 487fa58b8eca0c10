"""Input specs for every (arch x input shape) cell of the production
plan, after the JAX package's ``launch/specs.py``: each leaf's shape,
dtype and spec, with nothing allocated.

A leaf is a ``LeafSpec``: its shape, its torch dtype and its spec (the
JAX package's ``PartitionSpec`` as a plain tuple, one entry per dim: an
axis name, a tuple of names, or None). The rules are
``runtime/sharding.py``'s and read only a mesh's ``axis_names`` and
``shape``, so a ``MeshShape`` names the 16 x 16 or 2 x 16 x 16 mesh
without a rank. Params come from ``Model.param_shapes()``, decode caches
from ``Model.init_cache(..., device="meta")``.

The port keeps one dict a layer where the JAX package stacks the layers
of a deep homogeneous model (and the hybrid's groups) along a leading
axis. A leaf's spec is decided where the JAX package decides it, on its
stacked leaf (the FSDP threshold reads the stack's bytes:
``runtime.sharding.layout_specs``), and each layer takes it without the
stack dim. ``param_specs`` and ``decode_batch_specs`` give the port's
trees; ``jax_param_specs`` and ``jax_cache_specs`` the same leaves in the
JAX package's layout, ``{"a/b/c": LeafSpec}`` (stacked names and shapes),
as its ``input_specs`` names them; ``bridge.jax_layout_map`` maps the
leaves between the two.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.bridge import tree_leaves, unflatten_tree
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models.transformer import _DTYPES, build_model
from repro_torch.runtime import sharding as shrules

K_INNER = 4  # TinyReptile inner-stream length per round at mesh scale


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One leaf of a cell's params or batch, described, not allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Tuple

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    def chip_bytes(self, mesh) -> int:
        """The bytes of one part on one chip (``launch/describe.py``)."""
        parts = math.prod(shrules._size(mesh, ax) for ax in self.spec
                          if ax is not None)
        return self.nbytes // parts

    def local_shape(self, mesh) -> Tuple[int, ...]:
        """The shape of one part on one chip."""
        return tuple(d // shrules._size(mesh, ax)
                     for d, ax in zip(self.shape, self.spec))


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _plan(named: Dict[Tuple, LeafSpec], layout, rule, cache=False):
    """Leaves given in the port's layout (their specs ignored) ->
    ``({"a/b/c": LeafSpec}`` in the JAX package's layout, ``{port path:
    LeafSpec}``), every spec ``rule``'s on the JAX leaf
    (``runtime.sharding.jax_layout_specs``)."""
    jax, port = shrules.jax_layout_specs(
        {k: v.shape for k, v in named.items()}, layout, rule, cache)
    return ({name: LeafSpec(shape, named[member].dtype, spec)
             for name, (shape, spec, member) in jax.items()},
            {k: dataclasses.replace(v, spec=port[k])
             for k, v in named.items()})


def _param_plan(cfg: ArchConfig, mesh):
    model = build_model(cfg)
    named = {path: LeafSpec(tuple(shape), dtype, ())
             for path, (shape, dtype) in tree_leaves(model.param_shapes())}
    return _plan(named, model.jax_layout,
                 lambda name, shape: shrules.param_spec(name, shape, mesh))


def param_specs(cfg: ArchConfig, mesh):
    """The params tree of ``cfg`` (the port's layout) with ``LeafSpec``
    leaves under the production rules on ``mesh``."""
    return unflatten_tree(_param_plan(cfg, mesh)[1])


def jax_param_specs(cfg: ArchConfig, mesh) -> Dict[str, LeafSpec]:
    """``param_specs``'s leaves in the JAX package's layout, by their
    JAX path (``"layers/0/attn/wq"``)."""
    return _param_plan(cfg, mesh)[0]


def train_batch_specs(cfg: ArchConfig, shape: InputShape, mesh,
                      k_inner: int = K_INNER) -> Dict[str, LeafSpec]:
    """Meta-train batch: (K, mb, S) token streams."""
    mb = shape.global_batch // k_inner
    seq = shape.seq_len
    tok_spec = shrules.token_spec(mesh, mb, extra_dims=1, leading=1)
    batch = {}
    text_len = seq
    if cfg.frontend == "vision":
        text_len = seq - cfg.frontend_tokens
        batch["patch_embeds"] = LeafSpec(
            (k_inner, mb, cfg.frontend_tokens, cfg.d_model), _dtype(cfg),
            shrules.token_spec(mesh, mb, extra_dims=2, leading=1))
    if cfg.family == "audio":
        batch["frames"] = LeafSpec(
            (k_inner, mb, cfg.encoder_tokens, cfg.d_model), _dtype(cfg),
            shrules.token_spec(mesh, mb, extra_dims=2, leading=1))
    batch["tokens"] = LeafSpec((k_inner, mb, text_len), torch.int32, tok_spec)
    batch["labels"] = LeafSpec((k_inner, mb, text_len), torch.int32, tok_spec)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: InputShape, mesh
                        ) -> Dict[str, LeafSpec]:
    B, seq = shape.global_batch, shape.seq_len
    tok_spec = shrules.token_spec(mesh, B, extra_dims=1)
    batch = {}
    text_len = seq
    if cfg.frontend == "vision":
        text_len = seq - cfg.frontend_tokens
        batch["patch_embeds"] = LeafSpec(
            (B, cfg.frontend_tokens, cfg.d_model), _dtype(cfg),
            shrules.token_spec(mesh, B, extra_dims=2))
    if cfg.family == "audio":
        batch["frames"] = LeafSpec(
            (B, cfg.encoder_tokens, cfg.d_model), _dtype(cfg),
            shrules.token_spec(mesh, B, extra_dims=2))
    batch["tokens"] = LeafSpec((B, text_len), torch.int32, tok_spec)
    return batch


def _cache_plan(cfg: ArchConfig, shape: InputShape, mesh):
    """The decode cache's leaves (shapes from a ``meta`` cache) in both
    layouts, as ``_plan`` gives them."""
    model = build_model(cfg)
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device="meta")
    named = {k: LeafSpec(tuple(v.shape), v.dtype, ())
             for k, v in tree_leaves(cache)}
    return _plan(named, model.jax_layout,
                 shrules.cache_rule(mesh, shape.global_batch), cache=True)


def jax_cache_specs(cfg: ArchConfig, shape: InputShape, mesh
                    ) -> Dict[str, LeafSpec]:
    """The decode cache's leaves in the JAX package's layout, by their
    JAX path (``"layers/0/k"``, ``"group_mamba/2/ssm"``)."""
    return _cache_plan(cfg, shape, mesh)[0]


def decode_batch_specs(cfg: ArchConfig, shape: InputShape, mesh
                       ) -> Dict[str, Any]:
    """Decode step: one new token against a seq_len KV cache (the
    port's cache layout, each leaf's spec decided on its JAX leaf)."""
    B = shape.global_batch
    return {
        "tokens": LeafSpec((B, 1), torch.int32,
                           shrules.token_spec(mesh, B, extra_dims=1)),
        "cache": unflatten_tree(_cache_plan(cfg, shape, mesh)[1]),
        "cache_len": LeafSpec((), torch.int32, ()),
    }


def local_cache_shapes(cfg: ArchConfig, shape: InputShape, mesh
                       ) -> Dict[Tuple, Tuple[int, ...]]:
    """``{port path: shape}`` of one chip's part of the decode cache of
    ``decode_batch_specs`` (what ``runtime.sharding.CacheShards`` gives
    a rank of a live mesh)."""
    return {k: v.local_shape(mesh)
            for k, v in _cache_plan(cfg, shape, mesh)[1].items()}


def cache_chip_bytes(cfg: ArchConfig, shape: InputShape, mesh) -> int:
    """The bytes of one chip's part of the decode cache."""
    return sum(v.chip_bytes(mesh)
               for v in _cache_plan(cfg, shape, mesh)[1].values())


def input_specs(cfg: ArchConfig, shape: InputShape, mesh):
    """The full (params, batch) spec pair for the step kind of ``shape``."""
    params = param_specs(cfg, mesh)
    if shape.kind == "train":
        return params, train_batch_specs(cfg, shape, mesh)
    if shape.kind == "prefill":
        return params, prefill_batch_specs(cfg, shape, mesh)
    return params, decode_batch_specs(cfg, shape, mesh)
