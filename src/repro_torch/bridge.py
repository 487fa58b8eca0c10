"""Carry parameter trees between the JAX package and the port.

Both sides speak NumPy: the JAX package's params are nested dicts and
lists whose leaves convert with ``np.asarray``; the port's are the same
trees of torch tensors. Dtypes are kept, bf16 included: the JAX
package's bf16 leaves are ``ml_dtypes`` arrays, which ``torch`` cannot
take, so they cross as fp32, which holds every bf16 value exactly, and
are cast back on the far side (``params_to_numpy`` hands bf16 tensors
back as fp32 arrays). ``lm_params_from_jax`` / ``lm_params_to_jax`` also
map the LM family's layer layout, and ``lm_cache_from_jax`` /
``lm_cache_to_jax`` the decode cache's, which follows it. The port keeps
one dict per layer and one cache entry per application; the JAX package
stacks the layers of a deep homogeneous model over a leading axis (its
period an int), and always stacks the hybrid family's (``HybridLayout``):

- params: JAX ``layers`` is ``hybrid_attn_every`` (k) dicts stacked over
  the n_full full groups, Mamba2 layer g * k + pos being row g of dict
  pos, then ``tail`` lists the r = num_layers - k n_full layers left;
  ``shared_block`` is one block. The port's ``layers`` lists all
  num_layers Mamba2 layers in order (``tail`` appended, the key
  dropped) and keeps ``shared_block``.
- caches: JAX ``group_attn`` (one ``{"k", "v"}`` stacked over the
  groups: the shared block's cache at each group's application),
  ``group_mamba`` (k entries stacked over the groups), and with a tail
  ``tail_attn`` and ``tail_mamba`` (r entries). The port's ``layers``
  has one entry per application in order: group g's attention entry,
  its k Mamba2 entries, ..., then the tail's attention entry and its r
  Mamba2 entries.

A round-state snapshot holds phi in the layout of the package that wrote
it, so a hybrid's snapshots stay within one package.

``FlatLayout`` packs a tree into one flat buffer, the form the port's
kernels update in one launch: a flat ``{name: leaf}`` dict by its names,
a nested tree (the LM's ``{"embed", ..., "layers": [...]}``) by its
``flatten_tree`` paths (``FlatLayout.of_tree``), either way in the JAX
package's leaf order. ``GroupedLayout`` is the form for trees that mix
leaf dtypes (the LM's bf16 matrices beside its fp32 SSM scalars): one
``FlatLayout`` per dtype group and the whole tree's leaf order, with the
``FlatLayout`` methods over a tuple of buffers, one a group
(``group_map`` maps a function over such tuples, or over one buffer).

On the 2-D ``("clients", "model")`` route each rank holds its shard of
every leaf: ``GroupedLayout.with_shapes`` is the layout of those shards
(the whole tree's groups and leaf order, each leaf at its local shape),
and ``shard_tree`` cuts a whole tree (the JAX package's init as NumPy,
or tensors) into this rank's shards on its device, leaf by leaf, so the
device never holds a whole split leaf. The production mesh's shards
(``("data", "model")``) cross the same way: ``lm_shards_from_jax`` cuts
the JAX package's params into a rank's, ``whole_tree`` gathers a rank's
back; ``lm_cache_shards_from_jax`` and ``whole_cache`` do the same for a
decode cache split by ``runtime.sharding.CacheShards``, and
``adam_shards_from_jax`` for AdamW's state. ``jax_layout_map`` names, for
trees given by their paths alone
(``launch/specs.py``'s shapes), the JAX leaf each port leaf is stacked
into, and the reverse.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _is_bfloat16(a) -> bool:
    return getattr(getattr(a, "dtype", None), "name", None) == "bfloat16"


def params_from_numpy(tree, device: DeviceLike = None):
    """Nested dicts and lists of array-likes -> the same tree of tensors
    on ``device`` (a bf16 array arrives as a bf16 tensor)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    if _is_bfloat16(tree):
        return torch.from_numpy(np.asarray(tree, np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def params_to_numpy(params):
    """Nested dicts and lists of tensors -> the same tree of host NumPy
    arrays; bf16 leaves come back as fp32 arrays (exact)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    if isinstance(params, torch.Tensor):
        t = params.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(params)


def tree_leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs of a nested dict/list tree, dict keys in
    sorted order (as ``jax.tree.leaves`` walks them); a path is a tuple
    of dict keys (str) and list indices (int). Anything else, a tuple
    included, is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def flatten_tree(tree) -> Dict[Tuple, Any]:
    """A nested tree as ``{path: leaf}``."""
    return dict(tree_leaves(tree))


def unflatten_tree(flat: Dict[Tuple, Any]):
    """``flatten_tree``'s inverse: int path entries become list indices."""
    if list(flat) == [()]:
        return flat[()]
    groups: Dict[Any, Dict[Tuple, Any]] = {}
    for path, leaf in flat.items():
        groups.setdefault(path[0], {})[path[1:]] = leaf
    if all(isinstance(k, int) for k in groups):
        return [unflatten_tree(groups[i]) for i in range(len(groups))]
    return {k: unflatten_tree(v) for k, v in groups.items()}


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    """The JAX package's hybrid layout (``Model.jax_layout`` of the
    hybrid family): ``every`` Mamba2 layers to a group."""
    every: int


def _map_layers(tree, fn):
    out = dict(tree)
    out["layers"] = fn(tree["layers"])
    return out


def _unstack(stacks, period):
    """Scan-stacked dicts -> one dict per layer (layer g * p + pos is row
    g of dict pos)."""
    n_groups = len(next(iter(flatten_tree(stacks[0]).values())))
    return [index_tree(stacks[pos], g)
            for g in range(n_groups) for pos in range(period)]


def _stack(layers, period):
    """``_unstack``'s inverse, as NumPy."""
    return [unflatten_tree({
        path: np.stack([flatten_tree(layers[g * period + pos])[path]
                        for g in range(len(layers) // period)])
        for path in flatten_tree(layers[pos])}) for pos in range(period)]


def _port_layout(tree, layout):
    """The JAX package's LM params as NumPy in the port's layout (views
    of the stacked arrays)."""
    tree = _as_numpy(tree)
    if isinstance(layout, HybridLayout):
        tree = dict(tree)
        tree["layers"] = (_unstack(tree["layers"], layout.every)
                          + list(tree.pop("tail", [])))
    elif layout is not None:
        tree = _map_layers(tree, lambda s: _unstack(s, layout))
    return tree


def lm_params_from_jax(tree, layout=None, device: DeviceLike = None):
    """The JAX package's LM params (NumPy or ``jax.Array`` leaves) -> the
    port's tree on ``device``, by ``layout`` (``Model.jax_layout``): None
    where both keep one dict per layer; a period p where
    ``tree["layers"]`` is the JAX scan layout, p dicts whose leaves are
    stacked over the layer groups, layer g * p + pos being row g of dict
    pos; a ``HybridLayout`` for the hybrid's groups and tail (the module
    docstring). The port unstacks them into one dict per layer."""
    return params_from_numpy(_port_layout(tree, layout), device)


def lm_shards_from_jax(tree, layout, shards, device: DeviceLike = None):
    """The JAX package's LM params -> this rank's shards of the port's
    tree on ``device`` (``shard_tree`` by ``shards``, a
    ``runtime.sharding.ModelShards``): each leaf is cut on the host and
    only the shard is copied to the device."""
    named = flatten_tree(_port_layout(tree, layout))
    return unflatten_tree(shard_tree(named, shards, device))


def whole_tree(local, shards):
    """A rank's shards (a params tree) -> the whole tree, every leaf
    gathered on every rank (``ModelShards.gather_exact``; a collective
    that every rank of the mesh calls, leaf by leaf in the same order)."""
    return unflatten_tree({k: shards.gather_exact(k, v)
                           for k, v in tree_leaves(local)})


def jax_layout_map(paths, layout=None, cache: bool = False
                   ) -> Dict[Tuple, Tuple[bool, Tuple[Tuple, ...]]]:
    """Where the port's leaves sit in the JAX package's layout, for trees
    given only by their leaf paths (``flatten_tree`` paths; no leaf is
    read). Returns ``{JAX path: (stacked, port paths)}`` in the port's
    leaf order: a stacked JAX leaf holds its port leaves along a new
    leading axis, in that order; an unstacked one is its one port leaf.
    ``layout`` is ``Model.jax_layout``. ``cache`` maps a decode cache
    (one ``layers`` entry per application) instead of params: under a
    ``HybridLayout`` its ``group_attn``, ``group_mamba``, ``tail_attn``
    and ``tail_mamba`` (``lm_cache_from_jax``'s layouts)."""
    paths = list(paths)
    n = 1 + max((p[1] for p in paths if p[0] == "layers"), default=-1)
    out: Dict[Tuple, Tuple[bool, list]] = {}

    def place(jpath, stacked, path):
        out.setdefault(jpath, (stacked, []))[1].append(path)

    for path in paths:
        if path[0] != "layers" or layout is None:
            place(path, False, path)
            continue
        i, rest = path[1], path[2:]
        if not isinstance(layout, HybridLayout):
            place(("layers", i % layout) + rest, True, path)
        elif not cache:
            full = n // layout.every * layout.every
            if i < full:
                place(("layers", i % layout.every) + rest, True, path)
            else:
                place(("tail", i - full) + rest, False, path)
        else:
            k = layout.every + 1           # a group: its attention, k Mamba2
            full = n // k * k
            if i < full:
                pos = i % k
                place(("group_attn",) + rest if pos == 0 else
                      ("group_mamba", pos - 1) + rest, True, path)
            elif i == full:
                place(("tail_attn",) + rest, False, path)
            else:
                place(("tail_mamba", i - full - 1) + rest, False, path)
    # a stacked leaf's layers in the port's order: layer g of the group
    # is row g
    return {k: (st, tuple(sorted(v, key=lambda p: p[1]) if st else v))
            for k, (st, v) in out.items()}


def lm_params_to_jax(params, layout=None):
    """The port's LM params -> NumPy in the JAX package's ``layout``
    (``lm_params_from_jax``'s inverse); bf16 leaves come back as fp32
    arrays."""
    tree = params_to_numpy(params)
    if isinstance(layout, HybridLayout):
        layers = tree["layers"]
        full = len(layers) // layout.every * layout.every
        tree["layers"] = _stack(layers[:full], layout.every)
        tree["tail"] = layers[full:]
    elif layout is not None:
        tree = _map_layers(tree, lambda ls: _stack(ls, layout))
    return tree


def lm_cache_from_jax(cache, layout=None, device: DeviceLike = None):
    """The JAX package's decode cache -> the port's, on ``device``. The
    JAX cache is ``{"layers": [{"k": ..., "v": ...}, ...]}``, with the
    scan layout's p entries of ``(G, B, S, Kv, hd)`` (G layer groups)
    when ``layout`` is a period p, else one entry per layer, and the
    hybrid's ``group_attn``, ``group_mamba``, ``tail_attn`` and
    ``tail_mamba`` under a ``HybridLayout``; the port's has one entry per
    application. The layers map as ``lm_params_from_jax`` maps params."""
    return params_from_numpy(_port_cache(cache, layout), device)


def _port_cache(cache, layout):
    """The JAX package's decode cache as NumPy in the port's layout."""
    if not isinstance(layout, HybridLayout):
        return _port_layout(cache, layout)
    cache = _as_numpy(cache)
    layers = []
    attn, mamba = cache["group_attn"], cache["group_mamba"]
    for g in range(len(attn["k"])):
        layers.append(index_tree(attn, g))
        layers.extend(index_tree(m, g) for m in mamba)
    if "tail_attn" in cache:
        layers.append(cache["tail_attn"])
        layers.extend(cache["tail_mamba"])
    return {"layers": layers}


def lm_cache_shards_from_jax(cache, layout, cache_shards,
                             device: DeviceLike = None):
    """The JAX package's decode cache -> this rank's part of the port's
    on ``device``, by ``cache_shards`` (a ``runtime.sharding.
    CacheShards``): each leaf is cut on the host and only the part is
    copied to the device."""
    named = flatten_tree(_port_cache(cache, layout))
    return unflatten_tree(shard_tree(named, cache_shards, device))


def whole_cache(local, cache_shards):
    """A rank's part of a decode cache -> the whole cache, every leaf
    gathered on every rank (``CacheShards.gather``; a collective that
    every rank of the mesh calls, leaf by leaf in the same order)."""
    return unflatten_tree({k: cache_shards.gather(k, v)
                           for k, v in tree_leaves(local)})


def adam_shards_from_jax(state, layout, shards, device: DeviceLike = None):
    """The JAX package's ``AdamState`` (``mu`` and ``nu`` in the params'
    JAX layout, ``count``) -> the port's ``optim.AdamState`` of this
    rank's shards on ``device``, by ``shards`` (the params' ``ModelShards``:
    the moments split as the params are)."""
    from repro_torch.optim import AdamState
    mu, nu, count = state
    return AdamState(
        lm_shards_from_jax(mu, layout, shards, device),
        lm_shards_from_jax(nu, layout, shards, device),
        torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                     device=resolve_device(device)))


def lm_cache_to_jax(cache, layout=None):
    """The port's decode cache -> NumPy in the JAX package's ``layout``
    (bf16 as fp32 arrays), ``lm_cache_from_jax``'s inverse."""
    if not isinstance(layout, HybridLayout):
        return lm_params_to_jax(cache, layout)
    layers = params_to_numpy(cache)["layers"]
    n = layout.every + 1           # a group: its attention entry, k Mamba2
    full = len(layers) // n * n
    groups = [layers[i:i + n] for i in range(0, full, n)]
    out = {"group_attn": _stack([g[0] for g in groups], 1)[0],
           "group_mamba": _stack([m for g in groups for m in g[1:]],
                                 layout.every)}
    if full < len(layers):
        out["tail_attn"], out["tail_mamba"] = layers[full], layers[full + 1:]
    return out


def shard_tree(named: Dict[Any, Any], shards, device: DeviceLike = None
               ) -> Dict[Any, torch.Tensor]:
    """``{name: whole leaf}`` (NumPy arrays, bf16 ones included, or
    tensors) -> ``{name: this rank's shard}`` as tensors on ``device``,
    by ``shards`` (a ``runtime.sharding.ModelShards``): each leaf is cut
    where it lies (a NumPy leaf on the host) and only the shard is
    copied to the device."""
    dev = resolve_device(device)
    out = {}
    for k, v in named.items():
        part = shards.local(k, v)
        if isinstance(part, torch.Tensor):
            out[k] = part.to(dev).clone()
        else:
            out[k] = params_from_numpy(np.ascontiguousarray(part), dev)
    return out


def index_tree(tree, i):
    """Row ``i`` of every leaf of a nested tree (views for tensors)."""
    return unflatten_tree({k: v[i] for k, v in flatten_tree(tree).items()})


def _as_numpy(tree):
    """Leaves as NumPy arrays (``np.asarray``; bf16 stays bf16)."""
    return unflatten_tree({k: np.asarray(v)
                           for k, v in flatten_tree(tree).items()})


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each leaf of a ``{name: tensor}`` tree sits in one flat
    buffer: leaves in sorted-name order, each flattened, concatenated
    along the last axis. Leading (batch) axes are kept, so a cohort of C
    models is one ``(C, size)`` buffer, and the gradient of the summed
    per-model losses with respect to it is each model's own gradient."""
    names: Tuple[Any, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    #: the names are ``flatten_tree`` paths of a nested tree (``of_tree``)
    nested: bool = False

    @classmethod
    def of(cls, tree, batch_dims: int = 0) -> "FlatLayout":
        names = tuple(sorted(tree))
        return cls(names, tuple(tuple(tree[k].shape[batch_dims:])
                                for k in names))

    @classmethod
    def of_tree(cls, tree) -> "FlatLayout":
        """The layout of one model's params: a flat ``{name: leaf}`` dict
        by its names (``of``), a nested tree of dicts and lists by its
        ``flatten_tree`` paths. Sorted names and sorted paths are both
        ``jax.tree.leaves``' order, so leaf i here is leaf i there."""
        if isinstance(tree, dict) and not any(
                isinstance(v, (dict, list)) for v in tree.values()):
            return cls.of(tree)
        return dataclasses.replace(cls.of(flatten_tree(tree)), nested=True)

    def named(self, tree) -> Dict[Any, Any]:
        """A tree of this layout's structure as ``{name: leaf}``."""
        return flatten_tree(tree) if self.nested else dict(tree)

    def tree(self, named: Dict[Any, Any]):
        """``named``'s inverse: ``{name: leaf}`` in the structure the
        layout was made from (the nested tree, or the flat dict)."""
        return unflatten_tree(named) if self.nested else named

    def tree_views(self, flat: torch.Tensor):
        """``views`` of a ``(*batch, size)`` buffer in the structure the
        layout was made from; no copy."""
        return self.tree(self.views(flat))

    def buffer(self, tree):
        """The 1-D buffer whose ``views`` the leaves of ``tree`` (a
        ``{name: leaf}`` dict) are, in this layout's order, or None: a tree
        that ``views`` handed out is its buffer without a copy."""
        base = tree[self.names[0]]._base
        if (base is None or base.dim() != 1 or not base.is_contiguous()
                or base.numel() != sum(map(math.prod, self.shapes))):
            return None
        at = base.storage_offset()
        for k, shape in zip(self.names, self.shapes):
            leaf = tree[k]
            if (leaf._base is not base or leaf.storage_offset() != at
                    or tuple(leaf.shape) != shape
                    or not leaf.is_contiguous()):
                return None
            at += leaf.numel()
        return base

    def pack(self, tree, batch_dims: int = 0) -> torch.Tensor:
        """The tree as one buffer ``(*batch, size)`` (a copy)."""
        lead = tuple(tree[self.names[0]].shape[:batch_dims])
        return torch.cat([tree[k].reshape(lead + (-1,)) for k in self.names],
                         dim=-1)

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{name: view}`` of a ``(*batch, size)`` buffer, each view
        shaped ``(*batch, *leaf_shape)``; no copy."""
        out, off = {}, 0
        for k, shape in zip(self.names, self.shapes):
            n = math.prod(shape)
            out[k] = flat[..., off:off + n].reshape(flat.shape[:-1] + shape)
            off += n
        return out


def group_map(fn, *bufs):
    """``fn`` over the groups of ``GroupedLayout`` buffers (tuples, one
    tensor a group, zipped), returning a tuple; over plain tensors (a
    ``FlatLayout``'s buffers) ``fn(*bufs)`` itself."""
    if isinstance(bufs[0], tuple):
        return tuple(fn(*group) for group in zip(*bufs))
    return fn(*bufs)


@dataclasses.dataclass(frozen=True)
class GroupedLayout:
    """A tree that may mix leaf dtypes as one flat buffer per dtype: a
    ``FlatLayout`` a group (the group's leaves in the whole tree's
    order), groups in the order their dtype first appears in that order.
    Buffers are tuples, one tensor a group; ``views``, ``pack``,
    ``named``, ``tree`` and ``tree_views`` are ``FlatLayout``'s over
    them, the views keyed in the whole tree's order. ``names`` and
    ``shapes`` are the whole tree's, the order the JAX package's leaves
    take (``jax.tree.leaves``), so anything drawn per leaf (a partial
    wire's permutations, its chunk ids) follows it and is cut into the
    groups afterwards. A single-dtype tree is one group whose layout is
    ``FlatLayout.of_tree``'s, so its buffer is that layout's buffer."""
    groups: Tuple[FlatLayout, ...]
    dtypes: Tuple[torch.dtype, ...]
    names: Tuple[Any, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    nested: bool = False

    @classmethod
    def of_tree(cls, tree) -> "GroupedLayout":
        """The layout of one model's params (tensor leaves), grouped by
        their dtypes."""
        whole = FlatLayout.of_tree(tree)
        named = whole.named(tree)
        members: Dict[torch.dtype, list] = {}
        for k, shape in zip(whole.names, whole.shapes):
            members.setdefault(named[k].dtype, []).append((k, shape))
        if len(members) == 1:
            groups = (whole,)
        else:
            groups = tuple(
                FlatLayout(tuple(k for k, _ in m), tuple(s for _, s in m),
                           whole.nested) for m in members.values())
        return cls(groups, tuple(members), whole.names, whole.shapes,
                   whole.nested)

    def named(self, tree) -> Dict[Any, Any]:
        return flatten_tree(tree) if self.nested else dict(tree)

    def tree(self, named: Dict[Any, Any]):
        return unflatten_tree(named) if self.nested else named

    def views(self, flats) -> Dict[Any, torch.Tensor]:
        """``{name: view}`` of the group buffers, in the whole tree's
        order; no copy."""
        merged = {}
        for lay, flat in zip(self.groups, flats):
            merged.update(lay.views(flat))
        return {k: merged[k] for k in self.names}

    def tree_views(self, flats):
        return self.tree(self.views(flats))

    def pack(self, tree, batch_dims: int = 0) -> Tuple[torch.Tensor, ...]:
        """The ``{name: leaf}`` tree as one buffer a group (copies)."""
        return tuple(lay.pack(tree, batch_dims) for lay in self.groups)

    def with_shapes(self, shapes: Dict[Any, Tuple[int, ...]]
                    ) -> "GroupedLayout":
        """This layout with each leaf at ``shapes[name]``: the same groups,
        dtypes and leaf order (a rank's shards of the tree on the 2-D
        route)."""
        groups = tuple(dataclasses.replace(
            lay, shapes=tuple(tuple(shapes[k]) for k in lay.names))
            for lay in self.groups)
        return dataclasses.replace(self, groups=groups, shapes=tuple(
            tuple(shapes[k]) for k in self.names))

    def cut(self, per_leaf) -> Tuple[np.ndarray, ...]:
        """Per-leaf NumPy arrays, in the whole tree's order, raveled and
        concatenated group by group."""
        by_name = dict(zip(self.names, per_leaf))
        return tuple(np.concatenate([np.ravel(by_name[k])
                                     for k in lay.names])
                     for lay in self.groups)
