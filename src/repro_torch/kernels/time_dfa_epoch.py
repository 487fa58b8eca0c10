"""Time ``dfa_epoch_int8`` on the card, phase by phase, against another
version of its source.

    python -m repro_torch.kernels.time_dfa_epoch [--against FILE.cu]

For each of ``chip_smoke.py``'s six ``dfa_epoch_int8`` cases: the
kernel's device time (torch.profiler) and the wrapper's host-paced time
(CUDA events over back-to-back calls), each result held exactly to
``ref.dfa_int8_epoch``; and each CTA's time between its block barriers,
from a copy of the source built with ``clock64()`` stamps after the
kernel's entry, after every ``__syncthreads();`` and at its end (the
median over CTAs and runs, in SM cycles, each phase named by the source
lines it spans). ``--against`` builds an older source of the kernel with
the same C interface (for example one taken out of git history into
``build/``) and times it the same way in the same run, in turns. Prints
one JSON line per version and case. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.online_sgd_int8 import dfa_epoch_int8

# (tag, (din, h1, h2, dout), S, B, layers, all at the rails)
CASES = [(f"serve_B64_S8_layer{l}", (1, 32, 32, 1), 8, 64, [l], False)
         for l in (0, 1, 2)]
CASES += [("serve_B64_S8_mixed", (1, 32, 32, 1), 8, 64, [0, 1, 2], False),
          ("rails_B8_S512", (1, 8, 8, 1), 512, 8, [0, 1, 2], True),
          ("wide_B16_S32", (5, 16, 12, 3), 32, 16, [0, 1, 2], False)]
STAMPS = 32                 # stamps a CTA may write
STAMP = ("{ if (threadIdx.x == 0 && g_phase_stamps) g_phase_stamps["
         "(size_t)blockIdx.x * %d + %d] = clock64(); }")


def case_inputs(dims, S, B, seed, layers, extreme):
    """The operands of ``chip_smoke.py``'s case, on the card."""
    rng = np.random.default_rng(seed)
    din, h1, h2, dout = dims

    def ints(lo, hi, shape, dtype):
        a = (rng.choice([lo, hi], shape) if extreme
             else rng.integers(lo, hi + 1, shape))
        return torch.from_numpy(a.astype(dtype)).cuda()

    blim = 2 ** 22 if extreme else 2 ** 15
    ylim = 2 ** 21 if extreme else 2 ** 15
    ws = tuple(ints(-127, 127, (B,) + s, np.int8)
               for s in ((din, h1), (h1, h2), (h2, dout)))
    bs = tuple(ints(-blim, blim, (B, n), np.int32) for n in (h1, h2, dout))
    xq = ints(-127, 127, (B, S, din), np.int8)
    yal = ints(-ylim, ylim, (B, S, dout), np.int32)
    fb = tuple(ints(-127, 127, (dout, h), np.int8) for h in (h1, h2))
    dither = tuple(torch.from_numpy(
        rng.random((B,) + s).astype(np.float32)).cuda()
        for s in ((din, h1), (h1, h2), (h2, dout)))
    scales = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -9, 2.0 ** -4 / S,
                           2.0 ** -8, 2.0 ** -9, 2.0 ** -10,
                           2.0 ** -6, 2.0 ** -7, 2.0 ** -8],
                          dtype=torch.float32, device="cuda")
    lay = torch.tensor([layers[i % len(layers)] for i in range(B)],
                       dtype=torch.int32, device="cuda")
    return ws, bs, xq, yal, lay, fb, dither, scales


def stamped(src: str):
    """The source with phase stamps: after the kernel's entry, after each
    ``__syncthreads();`` of its body and at its end (after one more
    barrier). Returns (source, the phases as "lines a-b" of ``src``)."""
    m = re.search(r"__global__[^;{]*dfa_epoch_int8_kernel\s*\(", src)
    start = src.index("{", m.end())
    depth = 0
    for end in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            break
    body = src[start + 1:end]
    line = src[:start + 1].count("\n") + 1
    bounds = [line] + [line + body[:b.start()].count("\n")
                       for b in re.finditer(r"__syncthreads\(\);", body)]
    bounds.append(src[:end].count("\n") + 1)
    parts = body.split("__syncthreads();")
    out = [STAMP % (STAMPS, 0), parts[0]]
    for k, part in enumerate(parts[1:], 1):
        out += ["__syncthreads(); " + STAMP % (STAMPS, k), part]
    out.append("__syncthreads(); " + STAMP % (STAMPS, len(parts)) + "\n")
    text = src[:start + 1] + "".join(out) + src[end:]
    head = text.rfind("#include")
    head = text.index("\n", head) + 1
    text = (text[:head] + "__device__ long long* g_phase_stamps;\n"
            + text[head:] + '\nextern "C" int dfa_set_stamps(void* p) {\n'
            "  return (int)cudaMemcpyToSymbol(g_phase_stamps, &p, "
            "sizeof(p));\n}\n")
    return text, [f"lines {a}-{b}" for a, b in zip(bounds, bounds[1:])]


def build_lib(source: str, tag: str):
    digest = hashlib.sha256(source.encode()).hexdigest()[:16]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"dfa_timing_{tag}-{digest}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        cu.write_text(source)
        run = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                              str(so), str(cu)], capture_output=True,
                             text=True)
        if run.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}:\n{run.stdout}"
                             f"{run.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.dfa_epoch_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def device_us(fn, calls=40, windows=5):
    """Mean device time of the dfa kernel per launch the profiler recorded
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
               and "dfa_epoch_int8" in ev.key and ev.count]
        if evs:
            return (sum(ev.self_device_time_total for ev in evs)
                    / sum(ev.count for ev in evs))
    raise SystemExit("time_dfa_epoch: the profiler saw no kernel")


def host_us(fn, calls=200, passes=7):
    """Median over passes of the CUDA-event time per call of ``calls``
    back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(passes):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / calls)
    return statistics.median(times)


class Version:
    """One source of the kernel, built plain and stamped."""

    def __init__(self, tag, source, plain=True):
        self.tag = tag
        self.lib = build_lib(source, tag) if plain else None
        text, self.phases = stamped(source)
        self.stamped = build_lib(text, tag + "_stamped")
        self.stamped.dfa_set_stamps.argtypes = [ctypes.c_void_p]

    def call(self, lib, args):
        """A closure launching ``lib`` on ``args`` into fresh outputs."""
        ws, bs, xq, yal, lay, fb, dither, scales = args
        B, S, din = xq.shape
        dims = (B, S, din, ws[0].shape[2], ws[1].shape[2], ws[2].shape[2])
        outs = ([torch.empty_like(t) for t in (*ws, *bs)]
                + [torch.empty(B, device="cuda")])
        ptrs = [t.data_ptr() for t in (xq, yal, *ws, *bs, *fb, *dither,
                                       scales, lay, *outs)]

        def run():
            err = lib.dfa_epoch_int8_launch(
                *ptrs, *dims, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"{self.tag}: cudaError {err}")
        return run, outs

    def split(self, args, runs=20):
        B = args[2].shape[0]
        buf = torch.zeros(B, STAMPS, dtype=torch.int64, device="cuda")
        self.stamped.dfa_set_stamps(buf.data_ptr())
        run, _ = self.call(self.stamped, args)
        n = len(self.phases) + 1
        meds = []
        for _ in range(runs):
            buf.fill_(-1)
            run()
            torch.cuda.synchronize()
            st = buf[:, :n].cpu().numpy().astype(np.int64)
            # a barrier inside a branch this CTA did not take leaves its
            # stamp unwritten: that phase takes 0 and the next one its time
            for k in range(1, n):
                st[:, k] = np.where(st[:, k] < 0, st[:, k - 1], st[:, k])
            meds.append(np.median(np.diff(st, axis=1), axis=0))
        self.stamped.dfa_set_stamps(None)
        cycles = np.median(np.array(meds), axis=0)
        return {name: float(c) for name, c in zip(self.phases, cycles)}


def exact(outs, args):
    ww, wb, wl = ref.dfa_int8_epoch(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(outs[:6], ww + wb))
    rel = ((outs[6].double() - wl.double()).abs()
           / wl.double().abs().clamp_min(1e-30)).max().item()
    return same and rel <= 1e-6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path,
                    help="another source of csrc/dfa_epoch_int8.cu")
    args_ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_dfa_epoch: needs a CUDA device")
    # this version's plain launches go through its wrapper
    this = Version("this", (build.CSRC / "dfa_epoch_int8.cu").read_text(),
                   plain=False)
    other = (Version("against", args_ns.against.read_text())
             if args_ns.against else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for i, (tag, dims, S, B, layers, extreme) in enumerate(CASES):
        args = case_inputs(dims, S, B, 100 + i, layers, extreme)
        versions = [v for v in (other, this, this, other) if v]
        dev = {}
        for v in versions:
            if v is this:
                fn = lambda: dfa_epoch_int8(*args)          # noqa: E731
            else:
                fn, _ = v.call(v.lib, args)
            dev.setdefault(v.tag, []).append(device_us(fn))
        for v in (other, this):
            if v is None:
                continue
            if v is this:
                ws, bs, loss = dfa_epoch_int8(*args)
                outs = [*ws, *bs, loss]
            else:
                run, outs = v.call(v.lib, args)
                run()
            row = {"version": v.tag, "case": tag, "B": B, "S": S,
                   "dims": list(dims), "layers": layers,
                   "exact": exact(outs, args),
                   "device_us": statistics.mean(dev[v.tag]),
                   "device_us_runs": dev[v.tag],
                   "phase_cycles": v.split(args), "nvidia_smi": smi}
            if v is this:
                row["wrapper_host_us"] = host_us(
                    lambda: dfa_epoch_int8(*args))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
