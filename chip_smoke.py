#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card, its power limit, and the fp32 matmul flags (full
   fp32, no TF32) the sine MLP's parity needs;
2. build: the CUDA kernel (``nvcc``, sm_90a) and the Triton kernel are
   built from this checkout's sources, at the same time;
3. kernels: each kernel against its plain PyTorch version on the same
   CUDA tensors, at the serving shapes and at harder ones, timed with
   CUDA events (median of repeats) beside its bound and, for SGD, the
   one PyTorch call that computes the same function;
4. serve fp32: 512 requests through ``AdaptationServer`` with the
   ``serve --mode adapt`` defaults, launch counters set to 0 just before
   and read just after; 32 requests held against the port on the CPU;
5. serve TIFeD: the same through the int8 route (support 8, k_max 6);
   adapted weights exact against the CPU;
6. profile: device busy share of one fp32 drain (torch.profiler).

Then the kernels line, the card's ``nvidia-smi`` name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure is a
traceback and a non-zero exit; without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # fp32 outside the tensor cores
INT8_OPS_PER_S = 1979e12       # int8 tensor-core peak, dense
PASSES = 7                     # timing repeats; the median is kept

SUPPORT, QUERY, K_MAX, SLOTS, STEPS_PER_TICK = 10, 20, 10, 64, 5
T_SUPPORT, T_K_MAX = 8, 6
N_REQUESTS, N_HELD = 512, 32


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, iters):
    """Median over PASSES of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(PASSES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernel_device_us(torch, prof):
    """Device time of the CUDA kernels in a profile (microseconds). Only
    events on the device are summed: an operator's row also carries the
    time of the kernels it launched, and would count them twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == cuda)


def device_ms(torch, fn, calls=20):
    """Mean device time of the kernels one call of ``fn`` launches,
    from torch.profiler: the GPU's own time, without the host's."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = kernel_device_us(torch, prof)
    check(us > 0, "the profiler saw no device time")
    return us / calls / 1e3


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- inputs -------------------------------------------------------------------

def tifed_case(torch, np, dims, S, B, seed, layers, dev, extreme=False):
    """B slots of random (or all-rails) integer operands of one epoch."""
    rng = np.random.default_rng(seed)
    din, h1, h2, dout = dims

    def ints(lo, hi, shape, dtype):
        a = (rng.choice([lo, hi], shape) if extreme
             else rng.integers(lo, hi + 1, shape))
        return torch.from_numpy(a.astype(dtype)).to(dev)

    blim = 2 ** 22 if extreme else 2 ** 15
    ylim = 2 ** 21 if extreme else 2 ** 15
    ws = tuple(ints(-127, 127, (B,) + s, np.int8)
               for s in ((din, h1), (h1, h2), (h2, dout)))
    bs = tuple(ints(-blim, blim, (B, n), np.int32) for n in (h1, h2, dout))
    xq = ints(-127, 127, (B, S, din), np.int8)
    yal = ints(-ylim, ylim, (B, S, dout), np.int32)
    fb = tuple(ints(-127, 127, (dout, h), np.int8) for h in (h1, h2))
    dither = tuple(torch.from_numpy(
        rng.random((B,) + s).astype(np.float32)).to(dev)
        for s in ((din, h1), (h1, h2), (h2, dout)))
    scales = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -9, 2.0 ** -4 / S,
                           2.0 ** -8, 2.0 ** -9, 2.0 ** -10,
                           2.0 ** -6, 2.0 ** -7, 2.0 ** -8],
                          dtype=torch.float32, device=dev)
    lay = torch.tensor([layers[i % len(layers)] for i in range(B)],
                       dtype=torch.int32, device=dev)
    return ws, bs, xq, yal, lay, fb, dither, scales


def dfa_bytes_ops(args):
    """Bytes the epoch must move (each input read once, each output
    written once; only the selected layer's dither plane is needed) and
    the integer operations it must do, for these inputs."""
    ws, bs, xq, yal, lay, fb, dither, scales = args
    B, S, din = xq.shape
    h1, h2, dout = ws[0].shape[2], ws[1].shape[2], ws[2].shape[2]
    nbytes = lambda t: t.numel() * t.element_size()          # noqa: E731
    sizes = (din * h1, h1 * h2, h2 * dout)
    layers = lay.cpu().tolist()
    moved = (nbytes(xq) + nbytes(yal) + nbytes(scales) + nbytes(lay)
             + sum(nbytes(f) for f in fb)
             + 2 * (sum(nbytes(w) for w in ws) + sum(nbytes(b) for b in bs))
             + 4 * B + sum(4 * sizes[min(max(l, 0), 2)] for l in layers))
    forward = 2 * S * sum(sizes)
    ops = 0
    for l in layers:
        l = min(max(l, 0), 2)
        H = (h1, h2, dout)[l]
        delta = 2 * S * H * dout if l < 2 else 0
        ops += forward + delta + 2 * S * sizes[l]
    return moved, ops


# -- phases -------------------------------------------------------------------

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "torch.backends.cuda.matmul.allow_tf32 must be False")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision must be 'highest'")
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision()})
    return name, smi


def phase_build(torch, build, ops):
    """nvcc in a thread while Triton compiles its kernel."""
    out = {}

    def nvcc():
        t0 = time.perf_counter()
        out["report"] = build.build(["dfa_epoch_int8"])["dfa_epoch_int8"]
        out["nvcc_s"] = time.perf_counter() - t0

    th = threading.Thread(target=nvcc)
    th.start()
    t0 = time.perf_counter()
    p = torch.zeros(16, device="cuda")
    ops.online_sgd(p, p, 0.0)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    th.join()
    check("nvcc_s" in out, "nvcc build did not finish")
    ptxas = [ln.strip() for ln in out["report"].splitlines()
             if "registers" in ln or "spill" in ln]
    build.load("dfa_epoch_int8")
    emit({"phase": "build", "nvcc_s": round(out["nvcc_s"], 3),
          "triton_first_call_s": round(triton_s, 3), "ptxas": ptxas})


def phase_kernels(torch, np, ops, ref):
    dev = torch.device("cuda")
    rows = {}
    g = torch.Generator(device="cpu").manual_seed(0)
    lr = 0.01
    # online_sgd: the serving shape, then flat 2^24 in fp32 and bf16
    for tag, shape, dtype, tol in (
            ("serve_64x1153_fp32", (SLOTS, 1153), torch.float32, 1e-6),
            ("flat_2^24_fp32", (1 << 24,), torch.float32, 1e-6),
            ("flat_2^24_bf16", (1 << 24,), torch.bfloat16, 1e-2)):
        p = torch.randn(shape, generator=g).to(dev, dtype)
        gr = torch.randn(shape, generator=g).to(dev, dtype)
        got = ops.online_sgd(p, gr, lr)
        want = ref.online_sgd(p, gr, lr)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        err = (got.float() - want.float()).abs().max().item()
        iters = 200 if p.numel() < 1e6 else 20
        n = p.numel()
        moved = 3 * n * p.element_size()
        bound = 1e3 * max(moved / HBM_BYTES_PER_S, 2 * n / FP32_OPS_PER_S)
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
               "tol": tol, "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: ops.online_sgd(p, gr, lr), iters),
               "device_ms": device_ms(torch,
                                      lambda: ops.online_sgd(p, gr, lr)),
               "plain_ms": cuda_ms(torch, lambda: ref.online_sgd(p, gr, lr),
                                   iters),
               "library_ms": cuda_ms(
                   torch, lambda: torch.add(p, gr, alpha=-lr), iters),
               "bound_ms": bound,
               "bound_by": ("bytes" if moved / HBM_BYTES_PER_S
                            >= 2 * n / FP32_OPS_PER_S else "operations")}
        rows[f"online_sgd/{tag}"] = row
        emit({"phase": "kernel", "kernel": "online_sgd", "case": tag, **row})

    # dfa_epoch_int8: the serving shape for each layer and mixed, the
    # S = 512 all-rails envelope, and din > 1 / dout > 1
    cases = [(f"serve_B64_S8_layer{l}", (1, 32, 32, 1), 8, SLOTS, [l], False)
             for l in (0, 1, 2)]
    cases += [("serve_B64_S8_mixed", (1, 32, 32, 1), 8, SLOTS, [0, 1, 2],
               False),
              ("rails_B8_S512", (1, 8, 8, 1), 512, 8, [0, 1, 2], True),
              ("wide_B16_S32", (5, 16, 12, 3), 32, 16, [0, 1, 2], False)]
    for i, (tag, dims, S, B, layers, extreme) in enumerate(cases):
        args = tifed_case(torch, np, dims, S, B, 100 + i, layers, dev,
                          extreme)
        gw, gb, gl = ops.dfa_epoch_int8(*args)
        ww, wb, wl = ref.dfa_int8_epoch(*args)
        torch.cuda.synchronize()
        err = 0.0
        for a, b in zip(gw + gb, ww + wb):
            check(a.dtype == b.dtype, f"dfa {tag}: dtype {a.dtype}")
            err = max(err, (a.long() - b.long()).abs().max().item())
        check(err == 0, f"dfa {tag}: weights/biases differ by {err}")
        torch.testing.assert_close(gl, wl, rtol=1e-6, atol=0)
        rel = ((gl.double() - wl.double()).abs()
               / wl.double().abs().clamp_min(1e-30)).max().item()
        moved, nops = dfa_bytes_ops(args)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, nops / INT8_OPS_PER_S
        row = {"B": B, "S": S, "dims": list(dims), "layers": layers,
               "max_abs_err": err, "loss_max_rel_err": rel,
               "ms": cuda_ms(torch, lambda: ops.dfa_epoch_int8(*args), 100),
               "device_ms": device_ms(torch,
                                      lambda: ops.dfa_epoch_int8(*args)),
               "plain_ms": cuda_ms(torch, lambda: ref.dfa_int8_epoch(*args),
                                   10),
               "library_ms": None, "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved, "int_ops": nops}
        rows[f"dfa_epoch_int8/{tag}"] = row
        emit({"phase": "kernel", "kernel": "dfa_epoch_int8", "case": tag,
              **row})
    return rows


def make_requests(np, n, support, query, k_max, seed):
    """Seeded sine requests, drawn as ``launch/serve.py`` draws them."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 5.0, n)
    b = rng.uniform(0.0, np.pi, n)
    reqs = []
    for i in range(n):
        sx = rng.uniform(-5, 5, (support, 1)).astype(np.float32)
        qx = rng.uniform(-5, 5, (query, 1)).astype(np.float32)
        k = int(rng.integers(1, k_max + 1))
        reqs.append({"sx": sx, "sy": np.float32(a[i] * np.sin(sx + b[i])),
                     "qx": qx, "qy": np.float32(a[i] * np.sin(qx + b[i])),
                     "k": k})
    return reqs


def serve(server, reqs):
    """Submit ``reqs``, drain, and return the results in request order."""
    rids = [server.submit(r["sx"], r["sy"], r["qx"], r["qy"], r["k"])
            for r in reqs]
    done = {res.rid: res for res in server.drain()}
    check(len(done) == len(rids), f"{len(done)} of {len(rids)} retired")
    return [done[rid] for rid in rids]


def phase_serve(torch, np, mods, name, adapter, phi, reqs, k_max, kernel,
                exact_params):
    MetricsTracker, AdaptationServer, ops = mods
    tracker = MetricsTracker()
    server = AdaptationServer(phi, adapter, slots=SLOTS, k_max=k_max,
                              steps_per_tick=STEPS_PER_TICK, metrics=tracker,
                              device="cuda")
    serve(server, reqs[:1])                 # warm-up
    server.reset()
    tracker = server.metrics = MetricsTracker()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = serve(server, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for rid, res in enumerate(got):
        check(res.steps == reqs[rid]["k"],
              f"{name}: request {rid} ran {res.steps} of {reqs[rid]['k']}")
        check(math.isfinite(res.query_loss),
              f"{name}: request {rid} query loss {res.query_loss}")
    check(counts[kernel] >= server.ticks * STEPS_PER_TICK,
          f"{name}: {counts[kernel]} {kernel} launches for {server.ticks} "
          f"ticks x {STEPS_PER_TICK}")

    # the first N_HELD requests, on the card and on the CPU port
    held = reqs[:N_HELD]
    on = {}
    for dev in ("cuda", "cpu"):
        s = AdaptationServer(phi, adapter, slots=SLOTS, k_max=k_max,
                             steps_per_tick=STEPS_PER_TICK,
                             return_params=True, device=dev)
        on[dev] = serve(s, held)
    worst = 0.0
    for rid in range(N_HELD):
        g, c = on["cuda"][rid], on["cpu"][rid]
        check(g.steps == c.steps, f"{name}: request {rid} steps differ")
        for leaf in c.params:
            if exact_params:
                check(np.array_equal(g.params[leaf], c.params[leaf]),
                      f"{name}: request {rid} {leaf} not exact vs CPU")
            else:
                np.testing.assert_allclose(g.params[leaf], c.params[leaf],
                                           rtol=1e-5, atol=1e-5)
            worst = max(worst, float(np.abs(g.params[leaf]
                                            - c.params[leaf]).max()))
        for q in (g.query_loss, got[rid].query_loss):
            np.testing.assert_allclose(q, c.query_loss, rtol=1e-5, atol=1e-5)
    lat = tracker.percentiles("serve.latency_ms")
    row = {"phase": f"serve_{name}", "requests": len(got),
           "slots": SLOTS, "k_max": k_max,
           "steps_per_tick": STEPS_PER_TICK, "ticks": server.ticks,
           "wall_s": wall, "req_per_s": len(got) / wall,
           "latency_ms": lat, "launches": counts,
           "mean_query_loss": float(np.mean([r.query_loss
                                             for r in got])),
           "held_vs_cpu": {"requests": N_HELD,
                           "params_max_abs_diff": worst,
                           "params": "exact" if exact_params else "1e-5"}}
    emit(row)
    return row


def phase_profile(torch, np, mods, adapter, phi, reqs):
    """Share of one fp32 drain's wall time the device spends in
    kernels (sum of CUDA kernel self time over the profiled window)."""
    MetricsTracker, AdaptationServer, ops = mods
    server = AdaptationServer(phi, adapter, slots=SLOTS, k_max=K_MAX,
                              steps_per_tick=STEPS_PER_TICK, device="cuda")
    serve(server, reqs[:SLOTS])
    server.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve(server, reqs[:4 * SLOTS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {ev.key: ev.self_device_time_total
               for ev in prof.key_averages()
               if ev.device_type == cuda and ev.self_device_time_total > 0}
    dev_us = sum(by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile_fp32", "requests": 4 * SLOTS,
          "wall_ms": 1e3 * wall,
          "device_busy_ms": dev_us / 1e3,
          "device_idle_share": 1 - dev_us / 1e6 / wall,
          "kernels_launched": sum(ev.count for ev in prof.key_averages()
                                  if ev.device_type == cuda),
          "top_device_ms": [[k[:80], v / 1e3] for k, v in top]})


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on the GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: the port's sources are not under "
                         f"{SRC}; run this script from a checkout")
    sys.path.insert(0, str(SRC))

    import functools

    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.core.strategies import tifed_requantize
    from repro_torch.kernels import build, ops, ref
    from repro_torch.metering import MetricsTracker
    from repro_torch.models.paper_nets import (init_paper_model,
                                               paper_model_loss)
    from repro_torch.serving import (AdaptationServer, Fp32Adapter,
                                     TifedAdapter)

    t_start = time.perf_counter()
    name, smi = phase_device(torch)
    phase_build(torch, build, ops)
    rows = phase_kernels(torch, np, ops, ref)

    mods = (MetricsTracker, AdaptationServer, ops)
    phi = init_paper_model(SINE_MLP, torch.Generator().manual_seed(0), "cpu")
    fp32 = Fp32Adapter(loss_fn=functools.partial(paper_model_loss, SINE_MLP))
    reqs = make_requests(np, N_REQUESTS, SUPPORT, QUERY, K_MAX, seed=0)
    s_fp32 = phase_serve(torch, np, mods, "fp32", fp32, phi, reqs, K_MAX,
                         "online_sgd", exact_params=False)

    phi_q = tifed_requantize(phi)
    tifed = TifedAdapter(support=T_SUPPORT, k_max=T_K_MAX)
    t_reqs = make_requests(np, N_REQUESTS, T_SUPPORT, QUERY, T_K_MAX, seed=1)
    s_tifed = phase_serve(torch, np, mods, "tifed", tifed, phi_q, t_reqs,
                          T_K_MAX, "dfa_epoch_int8", exact_params=True)
    phase_profile(torch, np, mods, fp32, phi, reqs)

    sgd = rows["online_sgd/serve_64x1153_fp32"]
    dfa = rows["dfa_epoch_int8/serve_B64_S8_mixed"]
    kernels = [
        {"name": "online_sgd", "route": "triton",
         "source": "src/repro_torch/kernels/online_sgd.py",
         "replaces": "src/repro/kernels/online_sgd.py:36",
         "launches": s_fp32["launches"]["online_sgd"],
         **{k: sgd[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}},
        {"name": "dfa_epoch_int8", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dfa_epoch_int8.cu",
         "replaces": "src/repro/kernels/online_sgd_int8.py:120",
         "launches": s_tifed["launches"]["dfa_epoch_int8"],
         **{k: dfa[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}},
    ]
    emit({"total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
