"""Mixture-of-Experts block, the port of the JAX package's
``models/moe.py``: top-k token-choice routing with sort-based capacity
dispatch, the experts' SwiGLU as batched products over (E, C), the
load-balance aux loss and the optional shared expert (Llama-4).

Every step is a tensor op of a fixed shape: the capacity C depends only
on the token count T, k and E, never on the routing, and nothing is read
on the host (no ``.item()``, ``nonzero``, boolean-mask indexing or
``unique``), so the dispatch runs inside a captured CUDA graph (the
decode runner's step, the engine's round).

Ties: ``jax.lax.top_k`` returns equal values lowest index first, and
``torch.topk`` leaves their order unspecified, so the port takes the
first k of a stable descending sort. A zero input row gives uniform
probabilities and picks experts 0 ... k - 1, as there.

The expert products are plain ``jnp.einsum`` in the JAX package and
plain ``torch.bmm`` here: no Pallas kernel computes them.

The ``moelocal`` and ``moe2d`` levers (``runtime/flags.py``) are
accepted and change nothing here: with no device mesh the JAX package's
block runs ``moelocal`` as one token group and ``moe2d`` only places
shards, so both compute the unsharded dispatch this module computes.
Their sharding needs a mesh and is not ported. On the engine's 2-D
``("clients", "model")`` route the experts, which the ``moe`` partitioner
splits on E, are gathered whole inside the block that uses them
(``models/transformer.py::_apply_block_tp``) and this module computes on
them as it is.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import mlp, mlp_shapes, silu

#: the profiler range around the experts' three batched products
EXPERTS_RANGE = "moe_experts"


def moe_shapes(d_model, d_ff, num_experts, shared_expert, dtype):
    """``{leaf: (shape, dtype)}`` of one MoE sub-block, as ``init_moe``
    builds it: the router (d, E) in fp32 whatever ``dtype`` is, the
    experts' (E, d, f) and (E, f, d) matrices, and with ``shared_expert``
    a SwiGLU MLP beside them. ``normal_init`` takes fan_in from a
    matrix's first axis, which is E for the experts, as in the JAX
    package."""
    shapes = {"router": ((d_model, num_experts), torch.float32),
              "w_gate": ((num_experts, d_model, d_ff), dtype),
              "w_up": ((num_experts, d_model, d_ff), dtype),
              "w_down": ((num_experts, d_ff, d_model), dtype)}
    if shared_expert:
        shapes["shared"] = mlp_shapes(d_model, d_ff, "silu", dtype)
    return shapes


def capacity(num_tokens, k, num_experts, factor=1.25):
    """Rows per expert: T k / E times ``factor``, rounded up to 8."""
    c = int(math.ceil(num_tokens * k / num_experts * factor))
    return max(8, -(-c // 8) * 8)


def route(params, xf, k):
    """The router on tokens xf (T, d): fp32 logits, softmax, the k
    largest probabilities (ties lowest index first) renormalised by
    max(their sum, 1e-9). Returns (probs (T, E), gate (T, k), idx (T, k)
    int64)."""
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :k], idx[:, :k]
    return probs, gate / torch.clamp(gate.sum(-1, keepdim=True),
                                     min=1e-9), idx


def moe_block(params, x, *, experts_per_token, capacity_factor=1.25):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, the aux loss fp32)."""
    B, S, d = x.shape
    E = params["w_gate"].shape[0]
    k = experts_per_token
    T = B * S
    dev = x.device
    xf = x.reshape(T, d)
    probs, gate, idx = route(params, xf, k)

    # load-balance aux loss: E * sum(mean router prob * token fraction);
    # the fraction is 1 / (T k) added once per choice, as the JAX
    # package's scatter-add sums it
    e_flat = idx.reshape(-1)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add(
        0, e_flat, torch.full((T * k,), 1.0 / (T * k), dtype=torch.float32,
                              device=dev))
    aux = E * torch.sum(probs.mean(dim=0) * ce)

    # sort-based capacity dispatch: choices grouped by expert in token
    # order (a stable sort), the first C of each expert kept, the rest
    # sent to the spare row E * C and dropped
    C = capacity(T, k, E, capacity_factor)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat.index_select(0, order)
    tok_sorted = torch.div(order, k, rounding_mode="floor")
    g_sorted = gate.reshape(-1).index_select(0, order)
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - starts.index_select(0, e_sorted)
    keep = pos < C
    slot = torch.where(keep, e_sorted * C + pos,
                       torch.full_like(pos, E * C))

    # the spare row takes every dropped choice (in any order) and is cut
    ex_in = torch.zeros((E * C + 1, d), dtype=x.dtype,
                        device=dev).index_copy(
        0, slot, xf.index_select(0, tok_sorted))[:E * C].reshape(E, C, d)
    with torch.profiler.record_function(EXPERTS_RANGE):
        h = silu(torch.bmm(ex_in, params["w_gate"]))
        h = h * torch.bmm(ex_in, params["w_up"])
        y_e = torch.bmm(h, params["w_down"])                # (E, C, d)

    y_pad = torch.cat([y_e.reshape(E * C, d),
                       torch.zeros((1, d), dtype=y_e.dtype, device=dev)])
    contrib = y_pad.index_select(0, slot) * torch.where(
        keep, g_sorted, torch.zeros_like(g_sorted))[:, None].to(y_e.dtype)
    # Each token gets at most k <= 2 choices summed onto a zero row (a
    # dropped one adds 0): 0 + a is exact and a + b == b + a, so the
    # atomic adds on the card give the same bits in any order, here and
    # in index_select's backward (the gather of xf above).
    y = torch.zeros((T, d), dtype=x.dtype, device=dev).index_add(
        0, tok_sorted, contrib).reshape(B, S, d)
    if "shared" in params:
        y = y + mlp(params["shared"], x, "silu")
    return y, aux
