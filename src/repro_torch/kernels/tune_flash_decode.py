"""Choose ``flash_decode``'s split plan on the card.

    python -m repro_torch.kernels.tune_flash_decode [--out FILE]

For each pair of ``TARGET_BLOCKS`` and ``MIN_TILES`` in a small grid the
plan is set, and ``flash_decode`` is held against its plain version and
timed on the device (torch.profiler: the kernel's own time per launch,
40 calls cycling over 8 copies of the caches, past the L2) at the
decode path's shape (tinyllama-1.1b at batch 8, cache 2,048, bf16) for
L = 1 ... 2,048, at the 32k fp32 shape, and at paligemma-3b's decode
(head dim 256, 8 query heads over one KV head, bf16) at L = 2,048.
Prints one JSON line per setting and case, then the launch-weighted mean
over the L a decode wave passes through (1 ... 640) per setting. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref

PATH, K32 = (8, 32, 4, 64, 2048), (4, 8, 4, 64, 32768)
HD256 = (8, 8, 1, 256, 2048)     # paligemma-3b's decode
PATH_L = (1, 64, 128, 320, 577, 640, 1024, 2048)
WAVE = (1, 640)                  # L a decode wave of 512 + 128 runs over
SETTINGS = [(t, m) for t in (264, 528) for m in (1, 2, 4)]


def inputs(shape, dtype, copies, seed):
    B, H, Kv, hd, S = shape
    r = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
               .to("cuda", dtype)
               for s in ((B, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))
    return q, [(k, v)] + [(k.clone(), v.clone()) for _ in range(copies - 1)]


def device_us(fn, calls=40, windows=3):
    """Mean device time of the flash_decode kernel per launch it recorded
    (the tracer may lose events; up to ``windows`` tries)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and "flash_decode" in ev.key and ev.count]
        if evs:
            return (sum(ev.self_device_time_total for ev in evs)
                    / sum(ev.count for ev in evs))
    raise SystemExit("tune_flash_decode: the profiler saw no kernel")


def wave_mean(us_by_L):
    """Launch-weighted mean over L = 1 .. 640, linear between rows."""
    Ls = sorted(L for L in us_by_L if L <= WAVE[1])
    grid = np.arange(WAVE[0], WAVE[1] + 1)
    return float(np.interp(grid, Ls, [us_by_L[L] for L in Ls]).mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_flash_decode: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    lines = [{"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}]
    q, kvs = inputs(PATH, torch.bfloat16, 8, 0)
    q32, kvs32 = inputs(K32, torch.float32, 1, 1)
    q256, kvs256 = inputs(HD256, torch.bfloat16, 8, 2)
    cases = [("path", PATH, q, kvs, L, 0) for L in PATH_L]
    cases += [("path_w256", PATH, q, kvs, 1024, 256),
              ("32k_fp32", K32, q32, kvs32, 32768, 0),
              ("hd256", HD256, q256, kvs256, 2048, 0)]
    summary = {}
    for target, min_tiles in SETTINGS:
        fd.TARGET_BLOCKS, fd.MIN_TILES = target, min_tiles
        fd.plan.cache_clear()
        us_by_L = {}
        for tag, shape, qq, kk, L, w in cases:
            k, v = kk[0]
            got = fd.flash_decode(qq, k, v, L, window=w)
            want = ref.flash_decode(qq, k, v, L, window=w)
            err = (got.float() - want).abs().max().item()
            tol = 2e-2 if qq.dtype == torch.bfloat16 else 3e-4
            torch.testing.assert_close(
                got.float(), want, rtol=tol,
                atol=tol * min(1.0, want.abs().max().item()))
            cyc = itertools.cycle(kk)
            us = device_us(lambda: fd.flash_decode(qq, *next(cyc), L,
                                                   window=w))
            B, H, Kv, hd, S = shape
            lo = max(0, L - w) if w else 0
            line = {"target_blocks": target, "min_tiles": min_tiles,
                    "case": tag, "L": L, "window": w,
                    "plan": fd.plan(B, Kv, H // Kv, L - lo,
                                    fd.MAX_SPLITS if qq.dtype == torch.float32
                                    else fd.CLUSTER_SPLITS),
                    "device_us": us, "max_abs_err": err}
            lines.append(line)
            print(json.dumps(line), flush=True)
            if tag == "path":
                us_by_L[L] = us
        summary[f"{target}/{min_tiles}"] = {
            "wave_mean_us": wave_mean(us_by_L), "L2048_us": us_by_L[2048]}
    lines.append({"summary": summary})
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)


if __name__ == "__main__":
    main()
