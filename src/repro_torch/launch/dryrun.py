"""The dry run: one cell of the production plan traced as one rank of
its 256- or 512-rank group, after the JAX package's ``launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m --shape long_500k --multi-pod

Where the JAX package lowers and compiles a cell's step for one chip of
512 forced host devices, the port joins a fake process group
(``torch.distributed``'s ``fake`` backend: no rank is started, nothing is
sent, every collective returns at once) of 256 ranks (``16x16``,
``("data", "model")``) or 512 (``2x16x16``, ``("pod", "data",
"model")``) as rank 0, builds ``launch/mesh.py::make_production_mesh`` on
it, and runs the step once on ``meta`` tensors: each has a shape, a
dtype and no storage, so nothing is allocated or computed and a
full-size cell traces on any host, with or without a card. Each kernel
wrapper takes its shape-only route there (``kernels/costs.py``), as it
does for a ``FakeTensorMode`` tensor; the port's steps take the same
route whatever the device, and ``meta`` costs a third of the fake mode's
time an operation (the CPU-only build also cannot run autograd on fake
CUDA tensors). The inputs are the cell's (``launch/specs.py``): this
rank's shards of the params (``ModelShards.of_model``), the batch,
AdamW's state for the joint step, and for decode this rank's part of the
cache (``CacheShards``) and an int32 cursor on the device (the device-L
route: a host read of it raises on ``meta``). No weight is drawn.

The report has the JAX report's keys where their meaning carries over:

- ``memory``: ``argument_size_in_bytes`` (this rank's inputs: its param
  shards, its rows of the batch, its part of the cache or of AdamW's
  state), ``output_size_in_bytes`` (the step's outputs),
  ``temp_size_in_bytes`` (the peak of the storage the step makes and
  holds at once, its outputs included, so argument + temp is the
  predicted peak a rank) and ``alias_size_in_bytes`` (what the JAX
  package donates and the step updates in place: phi on train, the
  cache on decode);
- ``cost``: ``flops`` and ``bytes accessed``, every aten operation's
  (``torch.utils.flop_counter``'s formulas; each operation's tensor
  inputs and outputs, a view counting nothing) plus each kernel's
  analytic record (``kernels`` by name: calls, FLOPs, bytes);
- ``collective_bytes`` and ``collective_counts`` under ``COLLECTIVES``,
  from the port's own counters (``runtime/sharding.py``'s ``CALLS``):
  each call as the port makes it, counted by its result's bytes, the
  JAX convention. Every collective of the port is an ``all_reduce``
  (gloo takes no other of CUDA tensors), so a gather is the all-reduce
  of its zero-padded whole buffer; ``collectives_by_group`` splits them
  by the counters of ``MODEL_CALLS``, ``DATA_CALLS`` and
  ``MERGE_CALLS``, and ``gathers`` sets each gather's ring traffic
  beside an all-gather's of the same shards;
- ``probe`` and ``probe_cost``: the JAX linear model, cost(L, K) = K (a
  + b L) + m on train and c0 + b L otherwise, from traces at one and two
  periods of layers (and K = 1, 2) under ``runtime/flags.py::
  probe_scope``. The port counts every operation at full depth too
  (``cost``), which the JAX package's cost analysis of a scanned loop
  cannot; its tests hold the two equal under probe mode;
- ``roofline``: ``compute_s``, ``memory_s``, ``collective_s`` and the
  ``dominant`` term from ``launch/mesh.py``'s H100 constants
  (``PEAK_FLOPS_BF16``, ``HBM_BW``, ``NVLINK_BW``; ``memory_s_flash``
  with ``--refine``). A 16-rank model group spans two 8-GPU NVLink
  nodes, so part of its traffic crosses the slower network between
  them: the collective term is a lower bound;
- ``model_flops_per_chip`` (6 N_active D on train, 2 N_active D
  otherwise, over the chips) and ``useful_ratio``; ``refine`` (the
  flash-adjusted memory term); ``timing.trace_s``.

Dropped, as XLA's alone: ``hlo_lines``, ``collective_*_scanbody`` and
``generated_code_size_in_bytes``. ``parse_collective_bytes`` is kept as
the pure text function it is.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import time

import torch

from repro_torch.configs import ALL_ARCHS, SHAPES, get_arch, get_shape
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
                "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def skip_reason(cfg, shape):
    if shape.name == "long_500k":
        if cfg.name == "whisper-tiny":
            return "enc-dec decoder (448-pos design); 500k decode meaningless"
        if not cfg.supports_long_context():
            return "pure full-attention arch; no sub-quadratic variant"
    return None


def parse_collective_bytes(hlo_text: str):
    """Sum result-shape bytes of every collective op, per kind."""
    out = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    shape_re = re.compile(r"(\w+)\[([\d,]*)\]")
    for line in hlo_text.splitlines():
        m = re.search(r"=\s*(.*?)\s+(" + "|".join(COLLECTIVES) + r")\(", line)
        if not m:
            continue
        lhs, kind = m.group(1), m.group(2)
        nbytes = 0
        for dt, dims in shape_re.findall(lhs):
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES[dt]
        out[kind] += nbytes
        counts[kind] += 1
    return out, counts


# -- the fake group -----------------------------------------------------------

@contextlib.contextmanager
def fake_group(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks,
    for the block; a process already in a group raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("dryrun: this process is already in a process "
                           "group; the dry run makes its own fake one")
    dist.init_process_group("fake", rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- a cell's step and inputs -------------------------------------------------

def _nbytes(tree) -> int:
    """The bytes of every tensor in a tree of dicts, lists and tuples."""
    from torch.utils._pytree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _empty(specs, dev):
    """A tree of ``LeafSpec``s (or a flat dict of them) as empty tensors
    of their whole shapes on ``dev``."""
    from repro_torch.bridge import tree_leaves, unflatten_tree
    return unflatten_tree({k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                           for k, v in tree_leaves(specs)})


def build_step_and_args(cfg, shape, mesh, step_kind, k_inner=None,
                        device="meta"):
    """The production step of ``shape``'s kind on ``mesh`` (a
    ``ProcessMesh``) and this rank's arguments for it, as empty tensors
    on ``device`` (``meta``: shapes alone, for a trace; or under
    ``FakeTensorMode``, fake ones):
    its param shards, the batch whole (each step takes its own rows),
    AdamW's state and step for the joint step, its rows' tokens, its
    part of the cache and an int32 cursor for decode. Returns ``(step,
    args, info)``: ``info`` holds the argument bytes this rank holds
    (``argument``), the donated ones (``donated``: phi, or the cache),
    and the param and cache bytes a rank."""
    from repro_torch import optim
    from repro_torch.bridge import tree_leaves, unflatten_tree
    from repro_torch.launch import specs as specs_mod
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime import steps as steps_lib
    from repro_torch.runtime.sharding import token_spec

    model = build_model(cfg)
    dev = torch.device(device)
    k_inner = k_inner or specs_mod.K_INNER
    if shape.kind == "train" and step_kind == "joint":
        opt = optim.adamw()
        step = steps_lib.make_joint_train_step(model, opt,
                                               optim.constant(1e-4),
                                               mesh=mesh)
    elif shape.kind == "train":
        step = steps_lib.make_meta_train_step(model, mesh=mesh)
    elif shape.kind == "prefill":
        step = steps_lib.make_prefill_step(model, mesh=mesh)
    else:
        step = steps_lib.make_decode_step(model, mesh=mesh,
                                          batch_size=shape.global_batch,
                                          seq_len=shape.seq_len)
    shards = step.shards
    dtypes = {k: d for k, (_, d) in tree_leaves(model.param_shapes())}
    params = unflatten_tree({k: torch.empty(shards.local_shape(k),
                                            dtype=dtypes[k], device=dev)
                             for k in shards.shapes})
    info = {"param_bytes": _nbytes(params), "cache_bytes": 0}
    if shape.kind == "train":
        batch_specs = specs_mod.train_batch_specs(cfg, shape, mesh,
                                                  k_inner=k_inner)
        batch = _empty(batch_specs, dev)
        rows = sum(s.chip_bytes(mesh) for s in batch_specs.values())
        if step_kind == "joint":
            batch = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                     for k, v in batch.items()}
            state = opt.init(params)
            args = (params, state, 0, batch)
            info["argument"] = info["param_bytes"] + _nbytes(
                [state.mu, state.nu]) + rows
        else:
            args = (params, batch)
            info["argument"] = info["param_bytes"] + rows
        info["donated"] = info["param_bytes"]
    elif shape.kind == "prefill":
        batch_specs = specs_mod.prefill_batch_specs(cfg, shape, mesh)
        args = (params, _empty(batch_specs, dev))
        info["argument"] = info["param_bytes"] + sum(
            s.chip_bytes(mesh) for s in batch_specs.values())
        info["donated"] = 0
    else:
        B = shape.global_batch
        axes = token_spec(mesh, B, extra_dims=1)[0]
        parts = math.prod(mesh.shape[a] for a in axes) if axes else 1
        cache = step.cache_shards.init(dev)
        info["cache_bytes"] = _nbytes(cache)
        batch = {"tokens": torch.empty((B // parts, 1), dtype=torch.int32,
                                       device=dev),
                 "cache": cache,
                 "cache_len": torch.empty(1, dtype=torch.int32, device=dev)}
        args = (params, batch)
        info["argument"] = info["param_bytes"] + _nbytes(batch)
        info["donated"] = info["cache_bytes"]
    return step, args, info


def collective_counters():
    """The port's collective counters now (``runtime/sharding.py``): every
    ``all_reduce`` (count and bytes) and, by group, the model group's,
    the batch groups' and the decode merges'."""
    from repro_torch.runtime import sharding as sh
    return {"all_reduce": dict(sh.CALLS), "model": dict(sh.MODEL_CALLS),
            "data": dict(sh.DATA_CALLS), "merge": dict(sh.MERGE_CALLS)}


def collectives_since(before):
    """What ``collective_counters`` counted since ``before``."""
    after = collective_counters()
    return {g: {k: v - before[g][k] for k, v in after[g].items()}
            for g in after}


def trace(cfg, shape, mesh, step_kind="meta", k_inner=None) -> dict:
    """One trace of the cell's step as this rank, on ``meta``: what it
    computes, moves, holds and calls (``costs.CostMode``), and the
    collectives it makes by the port's counters."""
    from repro_torch.kernels.costs import CostMode
    step, args, info = build_step_and_args(cfg, shape, mesh, step_kind,
                                           k_inner)
    before = collective_counters()
    t0 = time.perf_counter()
    with CostMode(args) as cm:
        out = step(*args)
    seconds = time.perf_counter() - t0
    calls = collectives_since(before)
    out_bytes = _nbytes(out)
    return {"flops": cm.flops, "bytes": cm.bytes, "kernels": cm.kernels,
            "temp": cm.peak, "output": out_bytes, "calls": calls,
            "trace_s": seconds, **info}


def _cost_row(t) -> dict:
    """A trace's numbers as the probes' linear model reads them."""
    row = {"flops": float(t["flops"]), "bytes": float(t["bytes"])}
    for k in COLLECTIVES:
        all_reduce = k == "all-reduce"
        row[f"coll_bytes/{k}"] = float(
            t["calls"]["all_reduce"]["all_reduce_bytes"] if all_reduce else 0)
        row[f"coll_count/{k}"] = float(
            t["calls"]["all_reduce"]["all_reduce"] if all_reduce else 0)
    return row


def _probe_period(cfg):
    """Layer-count granularity for cost probes."""
    if cfg.family == "hybrid":
        return max(cfg.hybrid_attn_every, 1)
    from repro_torch.models.transformer import find_period, layer_specs
    return find_period(layer_specs(cfg))


def _probe_cost(cfg, shape, mesh, step_kind, k_inner=None):
    """One probe trace (probe mode's per-layer layout) -> its costs. A
    train probe of ``k_inner`` steps takes that many of the cell's
    microbatches (``global_batch / K_INNER`` rows each), so that each
    inner step costs what it costs in the cell: the JAX package's probes
    split the whole global batch into their K microbatches instead, and
    its model then counts the forward and backward K_INNER times over."""
    from repro_torch.launch.specs import K_INNER
    from repro_torch.runtime.flags import probe_scope
    if shape.kind == "train" and k_inner:
        shape = dataclasses.replace(
            shape, global_batch=shape.global_batch // K_INNER * k_inner)
    with probe_scope(True):
        return _cost_row(trace(cfg, shape, mesh, step_kind, k_inner))


def probe_costs(cfg, shape, mesh, step_kind):
    """Extrapolate exact per-step costs from probe traces.

    Model: cost(L, K) = K * (a + b*L) + m + c*L   (train; K = inner stream)
           cost(L)    = c0 + b*L                  (prefill / decode)

    The JAX package's train model has no c: the once-a-step work that
    grows with the layers (the server's interpolation over phi) is then
    counted K times. A fourth probe, (2p, 2), gives it."""
    from repro_torch.launch.specs import K_INNER
    p = _probe_period(cfg)
    L_full = cfg.num_layers
    L1, L2 = p, 2 * p
    if L_full <= L2:  # tiny model: probe exactly
        c = _probe_cost(dataclasses.replace(cfg, num_layers=L_full),
                        shape, mesh, step_kind,
                        k_inner=1 if shape.kind == "train" else None)
        if shape.kind != "train":
            return c, {"probes": [L_full]}
        c2 = _probe_cost(dataclasses.replace(cfg, num_layers=L_full),
                         shape, mesh, step_kind, k_inner=2)
        full = {k: c[k] + (c2[k] - c[k]) * (K_INNER - 1) for k in c}
        return full, {"probes": [(L_full, 1), (L_full, 2)]}
    cfg1 = dataclasses.replace(cfg, num_layers=L1)
    cfg2 = dataclasses.replace(cfg, num_layers=L2)
    if shape.kind == "train":
        p11 = _probe_cost(cfg1, shape, mesh, step_kind, k_inner=1)
        p21 = _probe_cost(cfg2, shape, mesh, step_kind, k_inner=1)
        p12 = _probe_cost(cfg1, shape, mesh, step_kind, k_inner=2)
        p22 = _probe_cost(cfg2, shape, mesh, step_kind, k_inner=2)
        full = {}
        for k in p11:
            b = (p22[k] - p12[k] - p21[k] + p11[k]) / (L2 - L1)  # per layer
            a = p12[k] - p11[k] - b * L1         # and per step, at K=1
            c = (p21[k] - p11[k]) / (L2 - L1) - b  # per layer, once
            m = p11[k] - (a + b * L1) - c * L1   # K-independent overhead
            full[k] = K_INNER * (a + b * L_full) + m + c * L_full
        return full, {"probes": [(L1, 1), (L2, 1), (L1, 2), (L2, 2)]}
    c1 = _probe_cost(cfg1, shape, mesh, step_kind)
    c2 = _probe_cost(cfg2, shape, mesh, step_kind)
    full = {}
    for k in c1:
        b = (c2[k] - c1[k]) / (L2 - L1)
        full[k] = c1[k] + b * (L_full - L1)
    return full, {"probes": [L1, L2]}


def refine_memory(cfg, shape, mesh, step_kind, full_cost):
    """Flash-adjusted memory term for train/prefill cells.

    The port's blockwise attention still writes and reads every block's
    scores, an S^2 bytes term that a fused flash kernel keeps on chip.
    Extract it empirically (probes at S, S/2, S/4; exact quadratic fit)
    and replace it with the flash HBM floor: K/V re-read once per Q
    block, c_flash = B_local * 2(K,V) * width * 2B / q_block per layer,
    with a 3x factor on train for the flash backward re-reads.
    """
    from repro_torch.launch.specs import K_INNER
    from repro_torch.models.transformer import layer_specs
    from repro_torch.runtime.flags import feature
    p = _probe_period(cfg)
    cfgp = dataclasses.replace(cfg, num_layers=p)
    ss = [shape.seq_len // 4, shape.seq_len // 2, shape.seq_len]
    ts = []
    for s in ss:
        shp = dataclasses.replace(shape, seq_len=s)
        c = _probe_cost(cfgp, shp, mesh, step_kind,
                        k_inner=1 if shape.kind == "train" else None)
        ts.append(c["bytes"])
    x1, x2, x3 = ss
    t1, t2, t3 = ts
    slope12 = (t2 - t1) / (x2 - x1)
    slope13 = (t3 - t1) / (x3 - x1)
    c_quad = (slope13 - slope12) / (x3 - x2)

    # analytic flash S^2 coefficient (per probe scope: p layers, K=1)
    model_size = mesh.shape.get("model", 1)
    data_size = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    if shape.kind == "train":
        b_local = max(shape.global_batch // K_INNER // data_size, 1)
    else:
        b_local = max(shape.global_batch // data_size, 1)
    if feature("gqa_flat") and cfg.num_heads % model_size == 0:
        width = (cfg.num_heads // model_size) * cfg.resolved_head_dim
    else:  # grouped path: Kv replicated when Kv < model axis
        kv_local = (cfg.num_kv_heads // model_size
                    if cfg.num_kv_heads % model_size == 0
                    else cfg.num_kv_heads)
        width = kv_local * cfg.resolved_head_dim
    n_attn = sum(1 for k, _ in layer_specs(cfgp) if k != "mamba")
    bwd = 3.0 if shape.kind == "train" else 1.0
    q_block = 512
    c_flash = n_attn * b_local * 2 * width * 2 * bwd / q_block

    scale = (cfg.num_layers / p) * (K_INNER if shape.kind == "train" else 1)
    s2 = shape.seq_len ** 2
    adjusted = full_cost["bytes"] - max(c_quad - c_flash, 0.0) * s2 * scale
    return {
        "bytes_flash_adjusted": adjusted,
        "c_quad_probe": c_quad,
        "c_flash_analytic": c_flash,
        "probe_seqs": ss,
    }


def model_flops_per_chip(cfg, shape, chips: int) -> float:
    """MODEL_FLOPS = 6 N_active D on train (forward and backward), 2
    N_active D otherwise, one token a sequence on decode; the K inner
    microbatches together consume the global batch once."""
    tokens = shape.seq_len * shape.global_batch
    if shape.kind == "decode":
        tokens = shape.global_batch
    mult = 6 if shape.kind == "train" else 2
    return mult * cfg.active_param_count() * tokens / chips


def _gathers(calls, mesh) -> dict:
    """Each group's gathers (zero-padded all-reduces of a whole buffer)
    with the bytes a rank sends in a ring: an all-reduce 2 (p - 1) / p of
    the buffer, an all-gather of the same shards (p - 1) / p."""
    out = {}
    for group, axis in (("model", "model"), ("data", "data")):
        p = mesh.shape.get(axis, 1)
        n = calls[group]["gather_bytes"]
        out[group] = {"count": calls[group]["gather"], "bytes": n,
                      "ranks": p,
                      "ring_bytes_as_all_reduce": 2 * (p - 1) * n / p,
                      "ring_bytes_as_all_gather": (p - 1) * n / p}
    return out


def dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
           step_kind: str = "meta", donate: bool = True,
           refine: bool = False):
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    reason = skip_reason(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              "step": step_kind if shape.kind == "train" else shape.kind,
              "mesh": "2x16x16" if multi_pod else "16x16"}
    if reason:
        result["status"] = "SKIP"
        result["reason"] = reason
        return result
    world = 512 if multi_pod else 256
    with fake_group(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        result.update(_report(cfg, shape, mesh, step_kind, donate, refine))
    result["status"] = "OK"
    return result


def _report(cfg, shape, mesh, step_kind, donate, refine) -> dict:
    """The OK report's keys for a cell traced on ``mesh``."""
    chips = mesh.size
    t = trace(cfg, shape, mesh, step_kind)
    res = {"memory": {"argument_size_in_bytes": t["argument"],
                      "output_size_in_bytes": t["output"],
                      "temp_size_in_bytes": t["temp"],
                      "alias_size_in_bytes": t["donated"] if donate else 0},
           "cost": {"flops": float(t["flops"]),
                    "bytes accessed": float(t["bytes"])},
           "kernels": t["kernels"],
           "param_bytes_per_rank": t["param_bytes"],
           "cache_bytes_per_rank": t["cache_bytes"]}
    row = _cost_row(t)
    res["collective_bytes"] = {k: row[f"coll_bytes/{k}"] for k in COLLECTIVES}
    res["collective_counts"] = {k: row[f"coll_count/{k}"]
                                for k in COLLECTIVES}
    res["collectives_by_group"] = {g: t["calls"][g]
                                   for g in ("model", "data", "merge")}
    res["gathers"] = _gathers(t["calls"], mesh)
    try:
        full_cost, probe_meta = probe_costs(cfg, shape, mesh, step_kind)
        res["probe"] = probe_meta
        res["probe_cost"] = full_cost
    except Exception as e:
        res["probe_error"] = f"{type(e).__name__}: {e}"
    flops, bytes_acc = row["flops"], row["bytes"]
    coll_total = float(sum(res["collective_bytes"].values()))
    res["roofline"] = {
        "chips": chips,
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": bytes_acc / HBM_BW,
        "collective_s": coll_total / NVLINK_BW,
    }
    res["roofline"]["dominant"] = max(
        ("compute_s", "memory_s", "collective_s"),
        key=lambda k: res["roofline"][k])
    res["model_flops_per_chip"] = model_flops_per_chip(cfg, shape, chips)
    if flops:
        res["useful_ratio"] = res["model_flops_per_chip"] / flops
    if refine and shape.kind in ("train", "prefill"):
        try:
            ref = refine_memory(cfg, shape, mesh, step_kind,
                                {"bytes": bytes_acc})
            res["refine"] = ref
            res["roofline"]["memory_s_flash"] = (
                ref["bytes_flash_adjusted"] / HBM_BW)
        except Exception as e:
            res["refine_error"] = f"{type(e).__name__}: {e}"
    res["timing"] = {"trace_s": round(t["trace_s"], 1)}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ALL_ARCHS))
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--step", default="meta", choices=["meta", "joint"])
    ap.add_argument("--out", default=None, help="write JSON here")
    ap.add_argument("--opt", default="",
                    help="comma list of perf levers (runtime/flags.py): "
                         "gqa_flat, banded, moe2d, ringkv, moelocal, "
                         "seqpar, ssd_pallas; the rest off")
    ap.add_argument("--refine", action="store_true",
                    help="flash-adjusted memory term (extra seq probes)")
    args = ap.parse_args(argv)
    if args.opt:
        from repro_torch.runtime.flags import set_features_from_env_string
        set_features_from_env_string(args.opt)
    res = dryrun(args.arch, args.shape, multi_pod=args.multi_pod,
                 step_kind=args.step, refine=args.refine)
    if args.opt:
        res["opt"] = args.opt
    text = json.dumps(res, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if res["status"] not in ("OK", "SKIP"):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
