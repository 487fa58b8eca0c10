"""How far the port's two fp32 routes sit from float64 on the gradients
that ``chip_smoke.py`` holds the card to the CPU by.

    python -m repro_torch.kernels.ssd_grad_float64 [--out FILE]

Two fp32 gradients, on ``chip_smoke.py``'s own inputs:

- ``zamba2_5l``: the reduced zamba2-1.2b at 5 layers (``FAMILY_REDUCED``,
  init seed 10, a (2, 64) token batch from NumPy seed 23), the gradient
  of ``Model.loss_fn``;
- ``mamba2_130m_<depth>l``: mamba2-130m at full width, cut to 2 layers
  and whole at 24 (``FULL_LM_GRAD_TOL``'s depths; init seed 0), the
  engine's one inner SGD step: ``core.meta.cohort_grad`` of a cohort of
  2 clients on 2 sequences of 64 tokens each (``LmTaskDistribution``,
  NumPy seed 1).

Each is computed four ways: fp32 on the card (the Mamba2 forward through
the ``ssd_scan`` kernel), fp32 on the card through the plain scan
(``card_plain``: the card's own rounding without the kernel), fp32 on
the CPU (the plain scan), and float64 on the card through the plain path
(``ssd_scan`` takes fp32 and bf16 only): ``mamba_block`` scans with the
plain ``ssd_chunked`` (from a zero state of the input's dtype) and every
``Tensor.float()`` of the plain path keeps a float64 tensor at float64,
so the reference carries no fp32 rounding beyond the fp32 constants the
port itself uses (the RoPE angles). For each leaf it reports each fp32
route's largest distance from float64 over the leaf's largest float64
entry, and the card's distance from the CPU over the CPU's largest entry
(the measure ``chip_smoke.py`` gates). One JSON line per case: the worst
leaf by each measure, and leaf by leaf the ratio of the card's distance
from float64 to the CPU's and to ``card_plain``'s (largest, with its
leaf, median, and how many leaves pass 3). Needs a CUDA device; the
full-width case holds some 1 GB of float64 params.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.bridge import FlatLayout, tree_leaves, unflatten_tree
from repro_torch.configs import get_arch
from repro_torch.core.meta import cohort_grad
from repro_torch.data import LmTaskDistribution, lm_loss
from repro_torch.models import mamba2
from repro_torch.models.transformer import build_model

#: (name, arch, num_layers, init seed, token seed) of ``Model.loss_fn``
#: cases: chip_smoke.py's FAMILY_REDUCED zamba2_5l (its index 3: seeds
#: 7 + 3 and 20 + 3), FAMILY_TOKENS
LOSS_CASES = (("zamba2_5l", "zamba2-1.2b", 5, 10, 23),)
LOSS_TOKENS = (2, 64)
#: mamba2-130m's depths of chip_smoke.py's grad_vs_cpu
COHORT_DEPTHS = (2, 24)


@contextlib.contextmanager
def plain_scan():
    """``mamba_block`` scans with the plain ``ssd_chunked`` on every
    device, from a zero state of the input's dtype."""
    real_scan = mamba2.ssd_chunked_kernel

    def scan(x, dt, A, Bm, Cm, chunk):
        b, _, h, p = x.shape
        state = x.new_zeros((b, h, p, Bm.shape[-1]))
        return mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk, state)[0]

    mamba2.ssd_chunked_kernel = scan
    try:
        yield
    finally:
        mamba2.ssd_chunked_kernel = real_scan


@contextlib.contextmanager
def float64_plain():
    """The plain path at float64: ``Tensor.float()`` leaves a float64
    tensor as it is, and ``mamba_block`` scans with ``ssd_chunked``."""
    real_float = torch.Tensor.float

    def keep64(self, *args, **kwargs):
        if self.dtype == torch.float64:
            return self
        return real_float(self, *args, **kwargs)

    torch.Tensor.float = keep64
    try:
        with plain_scan():
            yield
    finally:
        torch.Tensor.float = real_float


#: (tag, device, dtype, context) of the routes each gradient is taken by
ROUTES = (("card", "cuda", torch.float32, contextlib.nullcontext),
          ("card_plain", "cuda", torch.float32, plain_scan),
          ("cpu", "cpu", torch.float32, contextlib.nullcontext),
          ("f64", "cuda", torch.float64, float64_plain))


def _cast(tree, dev, dtype):
    return unflatten_tree({p: t.to(dev, dtype) if t.is_floating_point()
                           else t.to(dev) for p, t in tree_leaves(tree)})


def loss_grad(model, params, batch):
    """``model.loss_fn`` and each leaf's gradient, as float64 NumPy."""
    leaves = {k: v.detach().requires_grad_() for k, v in tree_leaves(params)}
    loss = model.loss_fn(unflatten_tree(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (np.array([loss.item()]),
            {k: g.detach().cpu().double().numpy()
             for k, g in zip(leaves, grads)})


def cohort_grad_np(model, init, batch, dev, dtype):
    """The engine's one inner step's cohort gradient at ``init`` (CPU
    tensors), cast to ``dtype`` on ``dev``: (losses, {leaf: (2, ...)})."""
    layout = FlatLayout.of_tree(init)
    flat = layout.pack(layout.named(init)).expand(2, -1).to(
        dev, dtype).contiguous()
    loss, g = cohort_grad(lm_loss(model), layout, flat,
                          {k: v.to(dev) for k, v in batch.items()})
    return (loss.cpu().double().numpy(),
            {k: v.cpu().double().numpy() for k, v in layout.views(g).items()})


def distances(out):
    """Per leaf: each fp32 route's largest distance from float64 over the
    leaf's largest float64 entry, and the card's from the CPU's over the
    CPU's largest entry."""
    ref, card, cpu = out["f64"], out["card"], out["cpu"]
    rows = []
    for k, r in ref.items():
        top, top_cpu = np.abs(r).max(), np.abs(cpu[k]).max()
        row = {"leaf": "/".join(map(str, k)), "max_abs_grad_f64": float(top)}
        for tag in ("card", "card_plain", "cpu"):
            row[f"{tag}_vs_f64"] = (float(np.abs(out[tag][k] - r).max() / top)
                                    if top else 0.0)
        row["card_vs_cpu"] = (float(np.abs(card[k] - cpu[k]).max() / top_cpu)
                              if top_cpu else 0.0)
        rows.append(row)
    return rows


def ratio_by_leaf(rows, other):
    """Leaf by leaf, the card's distance from float64 over ``other``'s:
    the largest (with its leaf and both distances), the median, and how
    many leaves pass 3."""
    ratios = [(r["card_vs_f64"] / max(r[f"{other}_vs_f64"], 1e-30), r)
              for r in rows]
    top, row = max(ratios, key=lambda t: t[0])
    return {"largest": top, "leaf": row["leaf"],
            "card_vs_f64": row["card_vs_f64"],
            f"{other}_vs_f64": row[f"{other}_vs_f64"],
            "median": float(np.median([t for t, _ in ratios])),
            "leaves_over_3": sum(t > 3 for t, _ in ratios)}


def summarize(name, rows, losses, seconds):
    worst = {key: max(rows, key=lambda r: r[key]) for key in (
        "card_vs_f64", "card_plain_vs_f64", "cpu_vs_f64", "card_vs_cpu")}
    return {"case": name, "leaves": len(rows), "losses": losses,
            "worst": worst,
            "card_over_cpu_by_leaf": ratio_by_leaf(rows, "cpu"),
            "card_over_card_plain_by_leaf": ratio_by_leaf(rows,
                                                          "card_plain"),
            "leaves_by_card_vs_cpu": sorted(
                rows, key=lambda r: -r["card_vs_cpu"])[:5],
            "s": seconds}


def run_loss_case(name, arch, layers, seed, tok_seed):
    cfg = dataclasses.replace(get_arch(arch).reduced(), num_layers=layers)
    model = build_model(cfg)
    init = model.init(torch.Generator().manual_seed(seed), "cpu")
    r = np.random.default_rng(tok_seed)
    tok = r.integers(0, cfg.vocab_size, LOSS_TOKENS)
    lab = np.concatenate([tok[:, 1:], np.full((LOSS_TOKENS[0], 1), -1)],
                         axis=1)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    t0 = time.perf_counter()
    out = {}
    for tag, dev, dtype, ctx in ROUTES:
        with ctx():
            out[tag] = loss_grad(model, _cast(init, dev, dtype),
                                 {k: v.to(dev) for k, v in batch.items()})
    rows = distances({k: v[1] for k, v in out.items()})
    return summarize(name, rows, {k: v[0].tolist() for k, v in out.items()},
                     time.perf_counter() - t0)


def run_cohort_case(depth):
    cfg = dataclasses.replace(get_arch("mamba2-130m"), dtype="float32",
                              num_layers=depth)
    model = build_model(cfg)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    dist = LmTaskDistribution(cfg.vocab_size, 64)
    block = dist.sample_support_block(np.random.default_rng(1), 1, 2, 2)
    batch = {k: torch.from_numpy(v[0]) for k, v in block.items()}
    t0 = time.perf_counter()
    out = {}
    for tag, dev, dtype, ctx in ROUTES:
        with ctx():
            out[tag] = cohort_grad_np(model, init, batch, dev, dtype)
        torch.cuda.empty_cache()
    rows = distances({k: v[1] for k, v in out.items()})
    return summarize(f"mamba2_130m_{depth}l", rows,
                     {k: v[0].tolist() for k, v in out.items()},
                     time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssd_grad_float64: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    lines = [{"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}]
    print(json.dumps(lines[0]), flush=True)
    for case in LOSS_CASES:
        lines.append(run_loss_case(*case))
        print(json.dumps(lines[-1]), flush=True)
    for depth in COHORT_DEPTHS:
        lines.append(run_cohort_case(depth))
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)


if __name__ == "__main__":
    main()
