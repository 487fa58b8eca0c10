"""Dry-run sweep driver, after the JAX package's ``launch/sweep.py``:
every (arch x shape x mesh) cell as an isolated subprocess (its own fake
process group, crash containment). Results land in
results/dryrun_torch/<arch>__<shape>__<mesh>.json (the JAX package's
sweep writes results/dryrun/, so the two never overwrite each other);
existing results are skipped (reported ``cached``).

Usage: PYTHONPATH=src python -m repro_torch.launch.sweep [--meshes single] ...
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCHS = [
    "llama4-maverick-400b-a17b", "mamba2-130m", "mixtral-8x22b",
    "whisper-tiny", "tinyllama-1.1b", "glm4-9b", "zamba2-1.2b",
    "minicpm-2b", "paligemma-3b", "starcoder2-15b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_cell(arch, shape, multi_pod, outdir, timeout=3000):
    mesh = "2x16x16" if multi_pod else "16x16"
    out = os.path.join(outdir, f"{arch}__{shape}__{mesh}.json")
    if os.path.exists(out):
        return "cached"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env, cwd=os.getcwd())
    except subprocess.TimeoutExpired:
        with open(out, "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "TIMEOUT", "timeout_s": timeout}, f)
        return "TIMEOUT"
    if r.returncode != 0:
        with open(out, "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "ERROR",
                       "stderr": r.stderr[-4000:]}, f, indent=1)
        return "ERROR"
    with open(out) as f:
        return json.load(f).get("status", "?") + f" ({time.time()-t0:.0f}s)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="results/dryrun_torch")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--timeout", type=int, default=3000)
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    meshes = [m == "multi" for m in args.meshes.split(",")]
    total = ok = 0
    for multi in meshes:
        for arch in args.archs.split(","):
            for shape in args.shapes.split(","):
                total += 1
                status = run_cell(arch, shape, multi, args.outdir,
                                  args.timeout)
                mesh = "2x16x16" if multi else "16x16"
                print(f"[{total}] {arch:28s} {shape:12s} {mesh:8s} {status}",
                      flush=True)
                if "OK" in status or "SKIP" in status or status == "cached":
                    ok += 1
    print(f"done: {ok}/{total} ok")


if __name__ == "__main__":
    main()
