"""Describe an architecture: config, param counts, layer pattern, and the
production sharding plan (per-leaf spec + per-chip bytes), with nothing
allocated and no rank started (a ``MeshShape``), after the JAX package's
``launch/describe.py``, whose text it prints.

  PYTHONPATH=src python -m repro_torch.launch.describe --arch mixtral-8x22b
  PYTHONPATH=src python -m repro_torch.launch.describe --arch zamba2-1.2b --params

The rows are the JAX package's leaves (``launch/specs.py::
jax_param_specs``): stacked names and shapes where it stacks the layers,
each leaf's spec decided there, printed as its ``PartitionSpec``.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import ALL_ARCHS, get_arch
from repro_torch.launch.specs import jax_param_specs
from repro_torch.models.transformer import find_period, layer_specs
from repro_torch.runtime.sharding import MeshShape

SINGLE_POD = MeshShape(("data", "model"), (16, 16))
MULTI_POD = MeshShape(("pod", "data", "model"), (2, 16, 16))


def partition_spec_str(spec) -> str:
    """A spec tuple as the JAX package prints its ``PartitionSpec``."""
    return "PartitionSpec" + repr(tuple(spec))


def chip_bytes(cfg, mesh) -> int:
    """The parameter bytes one chip holds under the production rules on
    ``mesh`` (any object with ``axis_names`` and a ``shape`` mapping):
    each leaf's part, summed."""
    return sum(leaf.chip_bytes(mesh)
               for leaf in jax_param_specs(cfg, mesh).values())


def describe(arch: str, show_params: bool, multi_pod: bool):
    cfg = get_arch(arch)
    mesh = MULTI_POD if multi_pod else SINGLE_POD
    print(f"# {cfg.name}  [{cfg.family}]  ({cfg.source})")
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if v not in (0, None, False, "") and f.name not in ("name", "family",
                                                            "source"):
            print(f"  {f.name:18s} = {v}")
    specs = layer_specs(cfg)
    p = find_period(specs)
    kinds = "".join({"attn": "A", "moe": "M", "mamba": "s",
                     "shared_attn": "S"}[k] for k, _ in specs)
    print(f"  layer pattern      = {kinds[:80]}{'...' if len(kinds) > 80 else ''}"
          f"  (period {p}, {len(specs)} applications)")
    print(f"  params (analytic)  = {cfg.param_count():,} "
          f"(active/token: {cfg.active_param_count():,})")
    print(f"  long-context OK    = {cfg.supports_long_context()}")

    total_bytes = 0
    max_chip = 0
    rows = []
    for pstr, leaf in jax_param_specs(cfg, mesh).items():
        nbytes = leaf.nbytes
        total_bytes += nbytes
        max_chip += leaf.chip_bytes(mesh)
        rows.append((leaf.chip_bytes(mesh), pstr, leaf.shape, leaf.spec))
    print(f"  param bytes        = {total_bytes/1e9:.2f} GB total, "
          f"{max_chip/1e9:.3f} GB/chip under {dict(mesh.shape)}")
    if show_params:
        rows.sort(reverse=True)
        print(f"  {'bytes/chip':>12s}  {'leaf':40s} {'shape':24s} spec")
        for b, pstr, shape, spec in rows[:25]:
            print(f"  {b/1e6:10.1f}MB  {pstr[:40]:40s} "
                  f"{str(tuple(shape)):24s} {partition_spec_str(spec)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ALL_ARCHS))
    ap.add_argument("--params", action="store_true",
                    help="show the largest parameter leaves + specs")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ALL_ARCHS)
    for a in archs:
        describe(a, args.params, args.multi_pod)
        print()


if __name__ == "__main__":
    main()
