#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line, in this order:

1. device: the card, its power limit, the fp32 matmul flags (full fp32,
   no TF32) the parity checks need, and cuDNN's flags as found; the
   conv nets' forward and gradients on the card within 1e-5 of the CPU
   under those flags (the port's convolutions run in fp32 with
   deterministic algorithms whatever the global flags say);
2. build: the CUDA kernels (``nvcc``, sm_90a, one process per source:
   ``online_sgd`` (with ``online_sgd_momentum``), ``dfa_epoch_int8``,
   ``meta_update``, ``ssd_scan``, ``flash_decode``) are built from this
   checkout's sources, all at the same time;
3. kernels: each kernel against its plain PyTorch version on the same
   CUDA tensors, at the shapes the main paths give it and at harder
   ones, timed with CUDA events (median of repeats) and the profiler
   beside its bound and the one PyTorch call that computes the same
   function, where there is one (host-paced and on the device);
   ``online_sgd`` bit for bit at the quickstart's (1, 1153), the serving
   (64, 1153) and flat 2^24 in fp32 and bf16; ``online_sgd_momentum``
   bit for bit at 1,153, (64, 1153) and flat 2^24 in fp32 and bf16,
   beside ``torch._fused_sgd_``; ``dfa_epoch_int8`` exact
   (the loss within 1e-6) at the serving shape for each layer and mixed,
   the S = 512 rails, dims (5, 16, 12, 3) and the round engine's TIFeD
   epoch (B = 64, S = 32, the sine MLP), the last and the serving shape
   also through the generic instantiation, timed beside it; ``ssd_scan``
   at the JAX package's test shapes, the LM path's and a 16-chunk
   sequence (its bound at the tensor cores' TF32 rate, three products
   for each fp32 one), at the last two also its three kernels, each
   against its plain phase, and its third at every heads-a-block
   setting; ``online_sgd`` and ``meta_update`` also at mamba2-130m's
   two flat buffers, and bit for bit at the conv nets' phi (20,612 and
   112,709) and KWS Reptile c4's (4, 20,612) cohort; ``meta_update`` (one
   fused multiply-add, as the JAX engine's jitted interpolation) bit for
   bit at every size it runs: 1,153, the LM's two buffers, 2^24 in fp32
   and bf16 and the conv nets';
   ``flash_decode`` at the JAX package's 24 test cases, at the decode
   path's shape (tinyllama at batch 8 and cache 2048, bf16) at L = 1, 64,
   128, 320, 577, 640 and 2048 and with a window, with their mean over
   the L = 1 ... 640 of a decode wave (``path_run_mean``), and at the
   32k fp32 shape of ``benchmarks/kernels_bench.py``, beside
   ``scaled_dot_product_attention``, within 3e-4 (fp32) or 2e-2 (bf16)
   relative and that times min(1, max |want|) absolute; at the path and
   32k shapes also the device-L route (L an int32 on the card, as the
   decode graph launches it), bit-equal to the host-int call, with its
   own ``path_run_mean_devL``;
4. serve decode reduced: ``serve --mode decode --arch tinyllama-1.1b
   --reduced`` (4 requests, batch 2, 16 + 16 tokens, cache 64) on the
   card and on the CPU from the same init: every step's logits within
   1e-4, the same tokens, 128 ``flash_decode`` launches and no other;
   the step built once (``decode_build``: trace_count 1, capture seconds,
   graph nodes) and replayed;
5. serve decode tinyllama-1.1b: full width and depth, bf16, random
   weights from seed 0, 16 requests at batch 8, 512 + 128 tokens, cache
   2048, the step built once and replayed 1,280 times: finite logits,
   28,160 ``flash_decode`` launches, tokens/s, step time and peak
   memory; then the same weights in fp32, 16 teacher-forced steps at
   batch 2 on the card and on the CPU (within 1e-3 of the largest
   logit), and the bf16 choices held near the fp32 maximum;
6. profile decode: 16 replays of the full-width decode step under
   torch.profiler: idle share, kernels per step, top kernels,
   ``flash_decode``'s share; then a 64 + 32-token wave of tinyllama-1.1b
   replayed against the same step run eagerly (for phase 20);
7. serve fp32: 512 requests through ``AdaptationServer`` with the
   ``serve --mode adapt`` defaults, launch counters set to 0 just before
   and read just after, the tick built (captured) once; 32 requests held
   against the port on the CPU;
8. serve TIFeD: the same through the int8 route (support 8, k_max 6);
   adapted weights exact against the CPU;
9. profile: device busy share of one fp32 drain (torch.profiler);
10. train TinyReptile: the quickstart's 600-round run, launch counters
    set to 0 just before and read just after, the round built (captured)
    once, checked against the random init; a 60-round run of the same
    configuration against the port on the CPU;
11. train Reptile: the train launcher's ``--strategy reptile`` defaults
    (64 clients, 20 rounds), in-process, against the CPU;
12. train baselines: FedAvg, FedSGD and Transfer at the launcher
    defaults, and TinyReptile with 8 straggling clients, against the CPU;
    each train run's round built once, with its capture time and graph
    size;
13. profile train: device busy share of 60 TinyReptile rounds;
14. fleet tifed: the train launcher's ``--strategy tifed`` defaults (64
    clients, support 32, 8 integer epochs, 20 rounds) on the card and on
    the CPU: the integer params and bytes exact, the int8 loss within
    1e-6, one build, 160 ``dfa_epoch_int8`` launches (one an epoch for
    the whole cohort, the kernel's S = 32 instantiation), rounds/s;
15. fleet partial: TinyReptile at 64 clients on
    ``PartialCommChannel(0.25)``, the mask fixed and rotating, 200
    rounds each (bills exact), the first 60 against the CPU (1e-4);
16. fleet pool: the sine MLP's TinyReptile over a persistent
    ``ClientPool`` of 100,000 devices (vectorized sampler), a cohort of
    64 under ``DiurnalAvailability(24)`` with
    ``BufferedAggregation(16, flush_staleness=8)``, 500 rounds (the pool
    state equal to a host replay of the plan, the first 60 rounds
    against the CPU), then 1,000,000 devices with their state in host
    slabs for 50 rounds against the CPU (pool state exact, 1e-4); one
    build each, launches as reckoned (the flush's ``meta_update`` every
    round); ``profile_fleet``: 20 replayed pooled rounds under the
    profiler (idle share, kernels a round, top kernels);
17. fleet kws: the port's KWS example with its persistent fleet
    (``--pool-size 1000 --availability markov --buffer-size 4``, 200
    rounds) on the card and on the CPU: accuracy within one query
    sample, the pool state and bills exact;
18. paper models: Table I (params, fp32 size), Table II
    (``algorithm_memory_report`` at S = 32, equal to the JAX package's)
    and Tables III-IV (one client's TinyReptile against Reptile update
    at S = 32, eager and built once) for the three paper models;
19. fig4 conv: Fig. 4 on Omniglot 5-way and KWS 4-way (TinyReptile and
    serial Reptile 120 rounds, Reptile at 4 clients 30), rounds/s,
    accuracy after adaptation beside the random init's and chance, each
    round built once, launches exact; KWS TinyReptile above 0.35 at the
    JAX package's test setting; each net on the card against the CPU
    (1e-4); a profile of 20 replayed Omniglot TinyReptile rounds;
20. graphs vs eager: the captured round (TinyReptile, Reptile and FedAvg
    at 8 clients, the int8 wire, the pooled and buffered sine round,
    TIFeD at 64 clients, Omniglot TinyReptile, KWS Reptile at 4
    clients), tick (fp32, TIFeD) and decode step (phase 6's wave: every
    step's logits and the tokens) against the same round, tick and step
    run eagerly on the card, bit for bit, launch counts equal;
21. train LM reduced: the LM launcher (``--arch mamba2 --reduced``) on
    the card and on the CPU from the same init, rows and params within
    1e-4, ``comm_mb`` exact, launches as reckoned;
22. train LM mamba2-130m: full width and depth, bf16, ``--rounds 6
    --batch 8 --seq 2048 --k-inner 4``: finite losses, the client adapts
    (mean last inner loss below the first), launches as reckoned,
    rounds/s, tokens/s and peak device memory;
23. profile LM: two full-width rounds under torch.profiler: idle share,
    top kernels, the shares of ``ssd_scan`` (its three kernels) and of
    its plain backward;
24. ckpt resume (after phase 17): crash and resume on the card, snapshots
    every 4 rounds, for TinyReptile at 64 clients (16 rounds), TIFeD at
    the launcher's defaults (alpha 1 annealed, 16 rounds), the pooled
    fleet (100,000 devices, diurnal check-ins, FedBuff(16, deadline 8),
    40 rounds) on the card and in host slabs under Markov check-ins:
    each run crashed right after its round-4 snapshot and resumed equals
    the uninterrupted one exactly (params, history, bills, pool state),
    each config's round built once across all three; the async writer's
    files equal a synchronous run's; a run resumed past its horizon (16
    -> 24) equals a 24-round run;
25. ckpt sigkill: a child process runs the TinyReptile case with the
    async writer and is SIGKILLed after its first durable snapshot; its
    resume here equals the uninterrupted card run exactly;
26. ckpt overhead: the quickstart's 600 rounds without and with a
    snapshot every 10 rounds, timed in turns: rounds/s of each, their
    ratio (the JAX package's target is under 5%; reported, not gated),
    and a snapshot's milliseconds on the training and writer threads.

Then the kernels line, the card's ``nvidia-smi`` name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure is a
traceback and a non-zero exit; without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import functools
import io
import itertools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # TF32 tensor-core peak, dense
INT8_OPS_PER_S = 1979e12       # int8 tensor-core peak, dense
BF16_OPS_PER_S = 989e12        # bf16 tensor-core peak, dense
PASSES = 7                     # timing repeats; the median is kept

SUPPORT, QUERY, K_MAX, SLOTS, STEPS_PER_TICK = 10, 20, 10, 64, 5
T_SUPPORT, T_K_MAX = 8, 6
N_REQUESTS, N_HELD = 512, 32
# the round engine's TIFeD: the train launcher's --strategy tifed defaults
# (64 clients, support 32, 8 epochs, 20 rounds); its dfa_epoch_int8 row
TIFED_CLIENTS, TIFED_SUPPORT, TIFED_EPOCHS = 64, 32, 8
ENGINE_DFA = "engine_B64_S32_mixed"

# examples/quickstart.py's TinyReptile run and eval protocol
TR_ROUNDS, TR_CHECK_ROUNDS, TR_SUPPORT = 600, 60, 32
TR_EVAL = dict(num_tasks=10, support=8, k_steps=8, lr=0.02, query=64)
PHI_BYTES = 1153 * 4           # one fp32 copy of the sine MLP on the wire

# ssd_scan: tests/test_kernels.py's three shapes, then the LM path's
# (B, H, nc, Q, P, N) at --batch 8 --seq 2048 --k-inner 4: 2 sequences
# of 8 chunks of 256 per inner step, mamba2-130m's 24 heads of 64 and
# state 128; then one 4,096-token sequence (16 chunks)
SSD_SHAPES = (("test_1x2x2x16x64x16", (1, 2, 2, 16, 64, 16)),
              ("test_2x3x4x32x64x32", (2, 3, 4, 32, 64, 32)),
              ("test_1x24x2x64x64x128", (1, 24, 2, 64, 64, 128)),
              ("path_2x24x8x256x64x128", (2, 24, 8, 256, 64, 128)),
              ("nc16_1x24x16x256x64x128", (1, 24, 16, 256, 64, 128)))
# 2e-4 is the JAX package's tolerance for the scan (tests/test_kernels.py);
# it holds at the path's shape too: the outputs stay below about 25, the
# in-chunk sums are damped by exp(sum dA), and both versions sum fp32
# products in orders that differ by a few ulp of those magnitudes
SSD_TOL = 2e-4
# heads a chunk-outputs block owns: the settings held and timed at the
# large shapes, beside ssd_scan.heads_per_block's choice
SSD_HEAD_GROUPS = (1, 2, 3, 4, 5, 6, 8, 12, 24)
# the LM launcher's runs: the reduced config against the CPU, then
# mamba2-130m at full width and depth
LM_REDUCED = ["--arch", "mamba2", "--reduced", "--rounds", "4", "--seq", "64",
              "--batch", "4", "--k-inner", "2"]
LM_FULL = ["--arch", "mamba2-130m", "--rounds", "6", "--batch", "8",
           "--seq", "2048", "--k-inner", "4"]
LM_PROFILE_ROUNDS = 2
# mamba2-130m's parameters: the bf16 group and the fp32 group (dt_bias,
# A_log and D of 24 layers), the two flat buffers of every update
LM_BF16, LM_FP32 = 128_981_760, 1_728

# flash_decode, as (B, H, Kv, hd, S): tests/test_kernels.py's three shapes
# (each at its four (L, window) cases and both dtypes, its tolerances),
# the decode path's (tinyllama-1.1b at --batch 8 --cache-len 2048) in
# bf16, and benchmarks/kernels_bench.py's 32k cache in fp32
FD_TEST_SHAPES = ((1, 4, 4, 64, 512), (2, 8, 2, 64, 1024),
                  (1, 8, 1, 128, 2048))
FD_PATH, FD_32K = (8, 32, 4, 64, 2048), (4, 8, 4, 64, 32768)
# the path shape's (L, window) rows: a decode wave of 512 + 128 steps
# passes through L = 1 ... 640 (the rows up to 640 give path_run_mean),
# then the cache's full 2,048 and a window
PATH_CASES = ((1, 0), (64, 0), (128, 0), (320, 0), (577, 0), (640, 0),
              (2048, 0), (1024, 256))
PATH_RUN = (1, 640)
# the kernel is held at tol x min(1, max |want|) absolute and tol relative:
# at the path's L = 2,048 the softmax is nearly flat, |out| is some 0.03,
# and a fixed 2e-2 would be two thirds of a typical value; the library
# call, whose time only is used, keeps the fixed tolerance
FD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}
# the serve launcher's decode runs: the reduced config against the CPU,
# then tinyllama-1.1b at full width and depth (TinyLlama's context is
# 2,048 tokens)
DECODE_REDUCED = ["--mode", "decode", "--arch", "tinyllama-1.1b",
                  "--reduced", "--requests", "4", "--batch", "2",
                  "--prompt-len", "16", "--max-new", "16", "--cache-len",
                  "64"]
DECODE_FULL = ["--mode", "decode", "--arch", "tinyllama-1.1b", "--requests",
               "16", "--batch", "8", "--prompt-len", "512", "--max-new",
               "128", "--cache-len", "2048"]
TINYLLAMA_PARAMS = 1_100_048_384
# the fp32 stretch at full width: 16 teacher-forced steps at batch 2, the
# card (full fp32 matmuls) against the CPU within 1e-3 of the largest
# |logit|: fp32 sums over d_model 2048 and d_ff 5632 in other orders,
# through 22 layers
CHECK_STEPS, CHECK_BATCH, CHECK_TOL = 16, 2, 1e-3
# a bf16 greedy choice may differ from the fp32 argmax where two logits
# are closer than bf16's rounding through 22 layers; its fp32 logit is
# held within 2^-4 of the largest fp32 |logit| (16 bf16 steps) of the max
BF16_CHOICE_TOL = 2 ** -4
DECODE_PROFILE_STEPS, DECODE_PROFILE_AT = 16, 512
# graphs_vs_eager's decode wave: tinyllama-1.1b at full width and depth,
# 8 prompts of 64 tokens and 32 new, cache 2048, replayed against eager
DECODE_GRAPH = dict(batch=8, prompt_len=64, max_new=32, cache_len=2048)

# the fleet phases: TinyMetaFed's partial wire on TinyReptile at 64
# clients; the persistent pool of tests/test_pool_scale.py (100,000 sine
# devices, vectorized sampler) under diurnal check-ins with a FedBuff
# buffer, then 1,000,000 devices with their state in host slabs; the
# KWS example's persistent fleet, at its defaults (200 rounds)
PARTIAL_ROUNDS, PARTIAL_CLIENTS, PARTIAL_FRACTION = 200, 64, 0.25
# the card is held to the CPU over the first FLEET_CHECK_ROUNDS of a long
# sine run, as the quickstart's 600 rounds are over 60: past some 100
# rounds a 64-client TinyReptile run amplifies fp32 reordering (the
# card's GEMMs against the CPU's) beyond 1e-4; the long run's bills and
# pool state are held exactly all the same
FLEET_CHECK_ROUNDS = 60
POOL_SIZE, POOL_BIG, POOL_COHORT = 100_000, 1_000_000, 64
POOL_ROUNDS, POOL_BIG_ROUNDS, FLEET_PROFILE_ROUNDS = 500, 50, 20
POOL_BUFFER, POOL_DEADLINE, POOL_PERIOD = 16, 8, 24
KWS_FLEET = ["--pool-size", "1000", "--availability", "markov",
             "--buffer-size", "4"]
CKPT_EVERY, CKPT_EVAL_EVERY, CKPT_ROUNDS, CKPT_PAST = 4, 8, 16, 24
CKPT_POOL_ROUNDS = 40
OVERHEAD_EVERY, OVERHEAD_PAIRS = 10, 3

# the paper models' parameters (Table I): the sine MLP and the conv nets
# KWS_CONV and OMNIGLOT_CONV, whose flat phi and (4, P) Reptile c4 cohort
# the kernel rows take
PAPER_PARAMS = {"sine_mlp": 1_153, "kws_conv": 20_612,
                "omniglot_conv": 112_709}
# paper Table II as the JAX package's metering/memory.py gives it at S = 32
# (algorithm_memory_report, run with the JAX package; constants here)
TABLE2 = {
    "sine_mlp": {"model": "sine_mlp", "params": 1153, "param_bytes": 4612,
                 "reptile_bytes": 17928, "tinyreptile_bytes": 5140,
                 "reduction_factor": 3.4879377431906615,
                 "fits_arduino_256kb_reptile": True,
                 "fits_arduino_256kb_tinyreptile": True},
    "kws_conv": {"model": "kws_conv", "params": 20612, "param_bytes": 82448,
                 "reptile_bytes": 1020064, "tinyreptile_bytes": 141172,
                 "reduction_factor": 7.225682146601309,
                 "fits_arduino_256kb_reptile": False,
                 "fits_arduino_256kb_tinyreptile": True},
    "omniglot_conv": {"model": "omniglot_conv", "params": 112709,
                      "param_bytes": 450836, "reptile_bytes": 3274024,
                      "tinyreptile_bytes": 625324,
                      "reduction_factor": 5.235724200574422,
                      "fits_arduino_256kb_reptile": False,
                      "fits_arduino_256kb_tinyreptile": False}}
# Tables III-IV (benchmarks/table34_round_time.py): one client's update,
# TinyReptile against Reptile with 8 epochs, at S = 32
T34_S, T34_EPOCHS = 32, 8
# Fig. 4 (benchmarks/fig4_omniglot_kws.py): 120 rounds of TinyReptile and
# of serial Reptile, 30 of Reptile at 4 clients, one eval at the end
FIG4_ROUNDS, FIG4_C4_ROUNDS, FIG4_CLIENTS = 120, 30, 4
FIG4_KW = dict(alpha=1.0, beta=0.01, support=16, seed=4)
FIG4_EVAL = dict(num_tasks=6, support=16, k_steps=8, lr=0.01, query=32)
# tests/test_core_algorithms.py::test_kws_tasks_learnable: KWS TinyReptile,
# 60 rounds, seed 6, the init from seed 1, must beat 0.35 (chance 0.25)
KWS_GATE = dict(rounds=60, alpha=1.0, beta=0.01, support=16, seed=6)
KWS_GATE_EVAL = dict(num_tasks=5, support=8, k_steps=8, lr=0.01, query=32)
KWS_GATE_MIN = 0.35
# the conv runs on the card against the CPU: TinyReptile rounds of each
# net, KWS Reptile c4 rounds; then the profiled Omniglot rounds
CONV_CHECK_ROUNDS, CONV_CHECK_C4_ROUNDS, CONV_PROFILE_ROUNDS = 10, 4, 20


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
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


def device_ms(torch, fn, key="device_ms", calls=20, windows=3,
              max_windows=10, match=None):
    """Mean device time of one call of ``fn``, from torch.profiler: the
    GPU's own time, without the host's, over ``windows`` windows of
    2 x ``calls`` calls each. Only events on the device are summed (an
    operator's row also carries the time of the kernels it launched).

    The tracer loses device events now and then: a window may record
    none, or only some launches of a kernel. So each kernel (by its full
    name) counts at its mean time over the launches recorded, times its
    launches per call: the most any window recorded, over 2 x ``calls``,
    rounded up; while no window has recorded anything, more windows are
    opened, up to ``max_windows``. Only kernels whose name holds
    ``match`` count, where it is given. Returns ``{key: ms, key +
    "_traced": share}``, the share being the launches recorded over
    those reckoned, and with ``match`` also ``kernels_per_call``, the
    launches a call so reckoned, summed over the kernels counted."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    n = 2 * calls
    time_us, count, per_call = ({} for _ in range(3))
    opened = 0
    while opened < windows or (not count and opened < max_windows):
        opened += 1
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_type == cuda and ev.count and (
                    match is None or match in ev.key):
                k = ev.key
                time_us[k] = time_us.get(k, 0) + ev.self_device_time_total
                count[k] = count.get(k, 0) + ev.count
                per_call[k] = max(per_call.get(k, 0), -(-ev.count // n))
    check(count, f"the profiler saw no device time in {opened} windows")
    ms = sum(time_us[k] / count[k] * per_call[k] for k in count) / 1e3
    out = {key: ms, key + "_traced": sum(count.values())
           / (opened * n * sum(per_call.values()))}
    if match is not None:
        out["kernels_per_call"] = sum(per_call.values())
    return out


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

def phase_device(torch, np):
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "torch.backends.cuda.matmul.allow_tf32 must be False")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision must be 'highest'")
    cudnn = torch.backends.cudnn
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision(),
          "cudnn_version": cudnn.version(),
          "cudnn_allow_tf32": cudnn.allow_tf32,
          "cudnn_deterministic": cudnn.deterministic,
          "cudnn_benchmark": cudnn.benchmark,
          "conv_fp32": conv_fp32_check(torch, np)})
    return name, smi


def conv_fp32_check(torch, np):
    """The conv nets' forward and gradients on the card against the CPU,
    with cuDNN's global flags as this process found them (TF32 allowed
    by default): the port's convolutions set their own flags (full
    fp32, deterministic algorithms) for the forward and the backward, so
    they agree within 1e-5 of the largest value. Then the second layer
    on a random input, as one plain ``F.conv2d`` under the global flags
    and as the port's ``_Conv``, each against the CPU."""
    import torch.nn.functional as F

    from repro_torch.configs.paper_models import KWS_CONV, OMNIGLOT_CONV
    from repro_torch.models import paper_nets

    with paper_nets._fp32_cudnn():
        c = torch.backends.cudnn
        inside = {"allow_tf32": c.allow_tf32, "deterministic": c.deterministic,
                  "benchmark": c.benchmark, "enabled": c.enabled}
    check(inside == {"allow_tf32": False, "deterministic": True,
                     "benchmark": False, "enabled": True},
          f"the port's conv scope sets {inside}")
    out = {"port_conv_flags": inside}
    for cfg in (KWS_CONV, OMNIGLOT_CONV):
        params = paper_nets.init_paper_model(
            cfg, torch.Generator().manual_seed(0), "cpu")
        r = np.random.default_rng(1)
        x = torch.from_numpy(r.standard_normal((64,) + cfg.input_shape)
                             .astype(np.float32))
        y = torch.from_numpy(r.integers(0, cfg.num_outputs, 64)
                             .astype(np.int32))
        got = {}
        for dev in ("cpu", "cuda"):
            p = {k: v.detach().to(dev).requires_grad_()
                 for k, v in params.items()}
            logits = paper_nets.paper_model_apply(cfg, p, x.to(dev))
            paper_nets.paper_model_loss(cfg, p, {"x": x.to(dev),
                                                 "y": y.to(dev)}).backward()
            got[dev] = (logits.detach().cpu(),
                        {k: v.grad.cpu() for k, v in p.items()})
        scale = got["cpu"][0].abs().max().item()
        err = (got["cuda"][0] - got["cpu"][0]).abs().max().item()
        gerr = max((got["cuda"][1][k] - g).abs().max().item()
                   / max(g.abs().max().item(), 1e-30)
                   for k, g in got["cpu"][1].items())
        check(err <= 1e-5 * scale and gerr <= 1e-5,
              f"{cfg.name}: the conv net on the card is {err} (of {scale}) "
              f"from the CPU, its gradients {gerr} relative: not fp32")
        # the second layer (32 or 64 input channels) on a random input:
        # one plain F.conv2d under the global flags, and the port's _Conv
        h, w, c = paper_nets.conv_shapes(cfg)[0]
        x1 = F.pad(torch.from_numpy(r.standard_normal((64, c, h, w))
                                    .astype(np.float32)),
                   paper_nets.same_pads(w) + paper_nets.same_pads(h))
        w1 = params["conv1"].permute(3, 2, 0, 1).contiguous()
        b1 = torch.zeros(w1.shape[0])
        want = F.conv2d(x1, w1, b1, stride=2)
        layer1 = {}
        for how, conv in (("global_flags", lambda a, b, c: F.conv2d(
                a, b, c, stride=2)), ("port", lambda a, b, c:
                                      paper_nets._Conv.apply(a, b, c, 1))):
            got1 = conv(x1.cuda(), w1.cuda(), b1.cuda()).cpu()
            layer1[f"{how}_conv1_max_abs_err"] = (got1 - want).abs().max() \
                .item()
        check(layer1["port_conv1_max_abs_err"] <= 1e-5
              * want.abs().max().item(),
              f"{cfg.name}: the port's conv1 is not fp32: {layer1}")
        out[cfg.name] = {
            "logits_max_abs_err": err, "logits_max_abs": scale,
            "grad_max_rel_err": gerr, **layer1,
            "conv1_max_abs": want.abs().max().item()}
    return out


def phase_build(build):
    """One nvcc per CUDA source, all started at once."""
    sources = ["online_sgd", "dfa_epoch_int8", "meta_update", "ssd_scan",
               "flash_decode"]
    t0 = time.perf_counter()
    reports = build.build(sources)
    nvcc_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in rep.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, rep in reports.items()}
    for name in sources:
        build.load(name)
    emit({"phase": "build", "nvcc_s": round(nvcc_s, 3), "ptxas": ptxas})


def phase_kernels(torch, np, ops, ref):
    from repro_torch.kernels.online_sgd_int8 import \
        dfa_epoch_int8_generic as generic

    dev = torch.device("cuda")
    rows = {}
    g = torch.Generator(device="cpu").manual_seed(0)
    lr = 0.01
    # online_sgd: the quickstart's client (19,208 of its launches), the
    # serving shape, then flat 2^24 in fp32 and bf16; bit for bit
    for tag, shape, dtype in (
            ("quickstart_1x1153_fp32", (1, 1153), torch.float32),
            ("serve_64x1153_fp32", (SLOTS, 1153), torch.float32),
            ("flat_2^24_fp32", (1 << 24,), torch.float32),
            ("flat_2^24_bf16", (1 << 24,), torch.bfloat16)):
        p = torch.randn(shape, generator=g).to(dev, dtype)
        gr = torch.randn(shape, generator=g).to(dev, dtype)
        got = ops.online_sgd(p, gr, lr)
        want = ref.online_sgd(p, gr, lr)
        check(torch.equal(got, want), f"online_sgd {tag}: not bit-exact")
        err = (got.float() - want.float()).abs().max().item()
        iters = 200 if p.numel() < 1e6 else 20
        n = p.numel()
        moved = 3 * n * p.element_size()
        bound = 1e3 * max(moved / HBM_BYTES_PER_S, 2 * n / FP32_OPS_PER_S)
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
               "tol": "exact", "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: ops.online_sgd(p, gr, lr), iters),
               **device_ms(torch, lambda: ops.online_sgd(p, gr, lr)),
               "plain_ms": cuda_ms(torch, lambda: ref.online_sgd(p, gr, lr),
                                   iters),
               "library_ms": cuda_ms(
                   torch, lambda: torch.add(p, gr, alpha=-lr), iters),
               **device_ms(torch, lambda: torch.add(p, gr, alpha=-lr),
                           "library_device_ms"),
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
              ("wide_B16_S32", (5, 16, 12, 3), 32, 16, [0, 1, 2], False),
              # the round engine's TIFeD epoch: the launcher's 64 clients
              # at support 32, the sine MLP; its own instantiation
              (ENGINE_DFA, (1, 32, 32, 1), TIFED_SUPPORT, TIFED_CLIENTS,
               [0, 1, 2], False)]
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
               **device_ms(torch, lambda: ops.dfa_epoch_int8(*args)),
               "plain_ms": cuda_ms(torch, lambda: ref.dfa_int8_epoch(*args),
                                   10),
               "library_ms": None, "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved, "int_ops": nops}
        if tag in (ENGINE_DFA, "serve_B64_S8_mixed"):
            # the specialized instantiation against the generic one on
            # the same operands, in this call (bit-equal first)
            ggw, ggb, ggl = generic(*args)
            check(all(torch.equal(a, b) for a, b in zip(ggw + ggb, gw + gb))
                  and torch.equal(ggl, gl),
                  f"dfa {tag}: the generic instantiation differs")
            row["generic_ms"] = cuda_ms(torch, lambda: generic(*args), 100)
            row.update(device_ms(torch, lambda: generic(*args),
                                 "generic_device_ms"))
        if tag == ENGINE_DFA:
            row["serve_B64_S8_mixed_device_ms"] = rows[
                "dfa_epoch_int8/serve_B64_S8_mixed"]["device_ms"]
        rows[f"dfa_epoch_int8/{tag}"] = row
        emit({"phase": "kernel", "kernel": "dfa_epoch_int8", "case": tag,
              **row})

    # meta_update: the training shape (phi of the sine MLP), then flat
    # 2^24 in fp32 and bf16, each at alpha 0, 0.37, 0.55 and 1 (one
    # fused multiply-add, bit for bit); timed at 0.37
    for tag, n, dtype in (
            ("train_1153_fp32", 1153, torch.float32),
            ("flat_2^24_fp32", 1 << 24, torch.float32),
            ("flat_2^24_bf16", 1 << 24, torch.bfloat16)):
        w = torch.randn(n, generator=g).to(dev, dtype)
        wh = torch.randn(n, generator=g).to(dev, dtype)
        err = 0.0
        for a in (0.0, 0.37, 0.55, 1.0):
            alpha = torch.tensor([a], device=dev)
            got = ops.meta_update(w, wh, alpha)
            want = ref.meta_update(w, wh, alpha)
            check(got.dtype == dtype, f"meta_update {tag}: {got.dtype}")
            check(torch.equal(got, want),
                  f"meta_update {tag} alpha {a}: not bit-exact")
            err = max(err, (got.float() - want.float()).abs().max().item())
        alpha = torch.tensor([0.37], device=dev)
        iters = 200 if n < 1e6 else 20
        moved = 3 * n * w.element_size()
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, 3 * n / FP32_OPS_PER_S
        row = {"n": n, "dtype": str(dtype).split(".")[1], "tol": "exact",
               "alphas": [0.0, 0.37, 0.55, 1.0], "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: ops.meta_update(w, wh, alpha),
                             iters),
               **device_ms(torch, lambda: ops.meta_update(w, wh, alpha)),
               "plain_ms": cuda_ms(
                   torch, lambda: ref.meta_update(w, wh, alpha), iters),
               "library_ms": cuda_ms(
                   torch, lambda: torch.lerp(w, wh, 0.37), iters),
               **device_ms(torch, lambda: torch.lerp(w, wh, 0.37),
                           "library_device_ms"),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rows[f"meta_update/{tag}"] = row
        emit({"phase": "kernel", "kernel": "meta_update", "case": tag,
              **row})

    # online_sgd and meta_update at the conv nets' shapes: phi of KWS and
    # of Omniglot (a TinyReptile client's step, the server update), and
    # the (4, P) cohort of KWS Reptile c4 (its clients' step); bit for bit,
    # meta_update at alpha 0, 0.37 and 1
    lr, alpha = 0.01, torch.tensor([0.37], device=dev)
    for tag, shape in (("kws_20612_fp32", (PAPER_PARAMS["kws_conv"],)),
                       ("omniglot_112709_fp32",
                        (PAPER_PARAMS["omniglot_conv"],)),
                       ("kws_c4_4x20612_fp32",
                        (FIG4_CLIENTS, PAPER_PARAMS["kws_conv"]))):
        a = torch.randn(shape, generator=g).to(dev)
        b = torch.randn(shape, generator=g).to(dev)
        n = a.numel()
        for kernel, fn, plain, library, nops in (
                ("online_sgd", lambda: ops.online_sgd(a, b, lr),
                 lambda: ref.online_sgd(a, b, lr),
                 lambda: torch.add(a, b, alpha=-lr), 2 * n),
                ("meta_update", lambda: ops.meta_update(a, b, alpha),
                 lambda: ref.meta_update(a, b, alpha),
                 lambda: torch.lerp(a, b, 0.37), 3 * n)):
            if kernel == "meta_update":
                for x in (0.0, 1.0):
                    at = torch.tensor([x], device=dev)
                    check(torch.equal(ops.meta_update(a, b, at),
                                      ref.meta_update(a, b, at)),
                          f"meta_update {tag} alpha {x}: not bit-exact")
            got, want = fn(), plain()
            check(torch.equal(got, want), f"{kernel} {tag}: not bit-exact")
            moved = 3 * n * 4
            t_bytes, t_ops = moved / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
            row = {"shape": list(shape), "dtype": "float32", "tol": "exact",
                   "max_abs_err": 0.0,
                   "ms": cuda_ms(torch, fn, 200),
                   **device_ms(torch, fn),
                   "plain_ms": cuda_ms(torch, plain, 200),
                   "library_ms": cuda_ms(torch, library, 200),
                   **device_ms(torch, library, "library_device_ms"),
                   "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": moved}
            rows[f"{kernel}/{tag}"] = row
            emit({"phase": "kernel", "kernel": kernel, "case": tag, **row})

    # online_sgd_momentum: the same sizes; m is fp32 whatever p's dtype;
    # bit for bit
    lr, mu = 0.05, 0.9
    for tag, shape, dtype in (
            ("train_1153_fp32", (1153,), torch.float32),
            ("serve_64x1153_fp32", (SLOTS, 1153), torch.float32),
            ("flat_2^24_fp32", (1 << 24,), torch.float32),
            ("flat_2^24_bf16", (1 << 24,), torch.bfloat16)):
        p = torch.randn(shape, generator=g).to(dev, dtype)
        gr = torch.randn(shape, generator=g).to(dev, dtype)
        m = torch.randn(shape, generator=g).to(dev)
        gp, gm = ops.online_sgd_momentum(p, gr, m, lr, mu)
        wp, wm = ref.online_sgd(p, gr, lr, m=m, momentum=mu)
        check(torch.equal(gm, wm) and torch.equal(gp, wp),
              f"online_sgd_momentum {tag}: not bit-exact")
        err = max((gp.float() - wp.float()).abs().max().item(),
                  (gm - wm).abs().max().item())
        n = p.numel()
        iters = 200 if n < 1e6 else 20
        moved = n * (3 * p.element_size() + 2 * 4)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, 4 * n / FP32_OPS_PER_S
        if dtype == torch.float32 and hasattr(torch, "_fused_sgd_"):
            # torch.optim.SGD(momentum=mu, fused=True)'s one call, in
            # place on copies
            lp, lg, lm = p.clone(), gr.clone(), m.clone()

            def fused():
                torch._fused_sgd_(
                    [lp], [lg], [lm], weight_decay=0.0, momentum=mu, lr=lr,
                    dampening=0.0, nesterov=False, maximize=False,
                    is_first_step=False)
            library = {"library_ms": cuda_ms(torch, fused, iters),
                       **device_ms(torch, fused, "library_device_ms")}
        else:
            # no one call keeps m fp32 beside bf16 p
            library = {"library_ms": None, "library_device_ms": None}
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
               "tol": "exact", "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: ops.online_sgd_momentum(
                   p, gr, m, lr, mu), iters),
               **device_ms(torch, lambda: ops.online_sgd_momentum(
                   p, gr, m, lr, mu)),
               "plain_ms": cuda_ms(torch, lambda: ref.online_sgd(
                   p, gr, lr, m=m, momentum=mu), iters),
               **library,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved}
        rows[f"online_sgd_momentum/{tag}"] = row
        emit({"phase": "kernel", "kernel": "online_sgd_momentum",
              "case": tag, **row})
    return rows


def ssd_inputs(torch, np, shape, seed, dev):
    """The JAX package's test inputs for the scan, from a NumPy seed."""
    B, H, nc, Q, P, N = shape
    r = np.random.default_rng(seed)
    arrays = (r.standard_normal((B, H, nc, Q, P)),
              -np.abs(r.standard_normal((B, H, nc, Q))) * 0.1,
              r.standard_normal((B, nc, Q, N)) * 0.3,
              r.standard_normal((B, nc, Q, N)) * 0.3)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in arrays)


def ssd_bytes_ops(shape):
    """fp32 operations the scan needs and the bytes it must move (xd, dA,
    Bm, Cm read once, y written once). L is zero above the diagonal, so
    the two in-chunk products count only the Q (Q + 1) / 2 causal pairs:
    C B^T once per (b, c), as the heads share it, and the masked product
    per (b, h, c); the two state products are dense, per (b, h, c)."""
    B, H, nc, Q, P, N = shape
    causal = Q * (Q + 1)                # 2 ops for each of Q (Q + 1) / 2 pairs
    ops = B * nc * causal * N + B * H * nc * (causal * P + 4 * Q * N * P)
    moved = 4 * (2 * B * H * nc * Q * P + B * H * nc * Q + 2 * B * nc * Q * N)
    return ops, moved


def ssd_phases(torch, ref, ssd_module, args):
    """ssd_scan's three kernels, each on its plain phase's inputs, held
    to that phase (2e-4; the cumsum 1e-5) and timed on the device (its
    own kernel only: state_pass also copies its input first); then
    chunk_outputs at every setting of SSD_HEAD_GROUPS, held and timed
    the same way."""
    xd, dA, Bm, Cm = args
    st, cs = ref.ssd_chunk_states(xd, dA, Bm)
    s_in = ref.ssd_state_pass(st, cs)[0]
    out = {}
    for name, fn, want, kernel in (
            ("chunk_states", lambda: ssd_module.chunk_states(xd, dA, Bm),
             (st, cs), "ssd_scan_states"),
            ("state_pass", lambda: (ssd_module.state_pass(st, cs),), (s_in,),
             "ssd_scan_pass"),
            ("chunk_outputs",
             lambda: (ssd_module.chunk_outputs(xd, cs, Bm, Cm, s_in),),
             (ref.ssd_chunk_outputs(xd, cs, Bm, Cm, s_in),),
             "ssd_scan_outputs")):
        got = fn()
        torch.cuda.synchronize()
        errs = []
        for g, w in zip(got, want):
            tol = 1e-5 if g.shape == cs.shape else SSD_TOL
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
            errs.append((g - w).abs().max().item())
        out[name] = {"max_abs_err": max(errs),
                     **device_ms(torch, fn, calls=5, match=kernel)}
    want = ref.ssd_chunk_outputs(xd, cs, Bm, Cm, s_in)
    by_heads = {}
    for hg in SSD_HEAD_GROUPS:
        fn = lambda: ssd_module.chunk_outputs(xd, cs, Bm, Cm, s_in, hg=hg)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)
        by_heads[hg] = {"max_abs_err": (got - want).abs().max().item(),
                        **device_ms(torch, fn, calls=5,
                                    match="ssd_scan_outputs")}
    out["chunk_outputs_by_heads_per_block"] = by_heads
    return out


def phase_kernels_lm(torch, np, ops, ref, rows):
    """ssd_scan at the test shapes, the path's and a 16-chunk sequence
    (with its device kernels a call, heads a block and dynamic shared
    memory per block; at the two large shapes also its three kernels,
    each held to its plain phase and timed); online_sgd and meta_update
    at the LM shape (mamba2-130m's two flat buffers)."""
    from repro_torch.kernels import ssd_scan as ssd_module

    smem_bytes = ssd_module._bind()["smem"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    for i, (tag, shape) in enumerate(SSD_SHAPES):
        args = ssd_inputs(torch, np, shape, 40 + i, dev)
        got = ops.ssd_scan(*args)
        want = ref.ssd_scan(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)
        err = (got - want).abs().max().item()
        # every fp32 product is three TF32 tensor-core products (3xTF32)
        nops, moved = ssd_bytes_ops(shape)
        t_ops, t_bytes = 3 * nops / TF32_OPS_PER_S, moved / HBM_BYTES_PER_S
        big = shape[3] >= 256
        row = {"shape_BHncQPN": list(shape), "tol": SSD_TOL,
               "max_abs_err": err, "y_max_abs": want.abs().max().item(),
               "heads_per_block": ssd_module.heads_per_block(*shape[:4], sms),
               "ms": cuda_ms(torch, lambda: ops.ssd_scan(*args),
                             5 if big else 50),
               **device_ms(torch, lambda: ops.ssd_scan(*args),
                           calls=5 if big else 20, match="ssd_scan"),
               "plain_ms": cuda_ms(torch, lambda: ref.ssd_scan(*args),
                                   3 if big else 20),
               "library_ms": None,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "ops_type": "3xtf32", "fp32_ops": nops, "tf32_ops": 3 * nops,
               "bytes": moved, "smem_bytes": smem_bytes(*shape[3:]),
               "tf32_bound_ms": 1e3 * max(nops / TF32_OPS_PER_S, t_bytes),
               "fp32_ffma_bound_ms": 1e3 * max(nops / FP32_OPS_PER_S,
                                               t_bytes)}
        check(row["kernels_per_call"] == ssd_module.KERNELS_PER_CALL,
              f"ssd_scan {tag}: the profiler reckons "
              f"{row['kernels_per_call']} kernels a call, not "
              f"{ssd_module.KERNELS_PER_CALL}")
        if big:
            row["phases"] = ssd_phases(torch, ref, ssd_module, args)
        rows[f"ssd_scan/{tag}"] = row
        emit({"phase": "kernel", "kernel": "ssd_scan", "case": tag, **row})

    gen = torch.Generator(device="cuda").manual_seed(1)
    alpha = torch.tensor([0.37], device=dev)
    for tag, n, dtype in (("lm_bf16_128981760", LM_BF16, torch.bfloat16),
                          ("lm_fp32_1728", LM_FP32, torch.float32)):
        a, b = (torch.randn(n, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        iters = 20 if n > 1e6 else 200
        moved = 3 * n * a.element_size()
        for kernel, fn, plain, library, nops in (
                ("online_sgd", lambda: ops.online_sgd(a, b, 0.02),
                 lambda: ref.online_sgd(a, b, 0.02),
                 lambda: torch.add(a, b, alpha=-0.02), 2 * n),
                ("meta_update", lambda: ops.meta_update(a, b, alpha),
                 lambda: ref.meta_update(a, b, alpha),
                 lambda: torch.lerp(a, b, 0.37), 3 * n)):
            got, want = fn(), plain()
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{kernel} {tag}: not bit-exact")
            t_bytes, t_ops = moved / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
            row = {"n": n, "dtype": str(dtype).split(".")[1], "tol": "exact",
                   "max_abs_err": (got.float() - want.float()).abs().max()
                   .item(),
                   "ms": cuda_ms(torch, fn, iters),
                   **device_ms(torch, fn),
                   "plain_ms": cuda_ms(torch, plain, iters),
                   "library_ms": cuda_ms(torch, library, iters),
                   **device_ms(torch, library, "library_device_ms"),
                   "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            rows[f"{kernel}/{tag}"] = row
            emit({"phase": "kernel", "kernel": kernel, "case": tag, **row})
        del a, b
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
    check(server.trace_count == 1 and server._tick_step.graph is not None,
          f"{name}: the tick was built {server.trace_count} times")

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
           "trace_count": server.trace_count,
           "capture_s": server._tick_step.capture_s,
           "graph_nodes": server._tick_step.nodes,
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


def compare_runs(np, got, want, tol=1e-4):
    """A card run against the same run on the CPU: params and history
    floats within ``tol``, bytes and history keys exact. Returns the
    largest param difference."""
    worst = 0.0
    for k, v in want["params"].items():
        a, b = got["params"][k].cpu().numpy(), v.numpy()
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=k)
        worst = max(worst, float(np.abs(a - b).max()))
    for key in ("comm_bytes", "per_client_bytes"):
        check(got.get(key) == want.get(key), f"{key} differs from the CPU")
    check(len(got["history"]) == len(want["history"]), "history length")
    for ge, we in zip(got["history"], want["history"]):
        check(set(ge) == set(we), f"history keys {set(ge)} vs {set(we)}")
        for k, v in we.items():
            if isinstance(v, int):
                check(ge[k] == v, f"history {k}: {ge[k]} vs {v}")
            else:
                np.testing.assert_allclose(ge[k], v, rtol=tol, atol=tol,
                                           err_msg=k)
    return worst


def timed_run(torch, ops, fn):
    """``fn()`` on the card with the launch counters set to 0 just
    before and read just after; returns (result, wall seconds, counts)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, ops.launch_counts()


def built_round(engine):
    """The timed run's round: built (captured) once. The runner cache is
    cleared before a timed run, so its runner is the cache's one entry
    and its one program holds the capture."""
    (runner,) = engine._RUNNER_CACHE._entries.values()
    check(runner.trace_count == 1,
          f"the round was built {runner.trace_count} times")
    (prog,) = runner._programs.values()
    check(prog.step.graph is not None, "the round was not captured")
    return {"trace_count": runner.trace_count,
            "capture_s": prog.step.capture_s, "graph_nodes": prog.step.nodes}


def phase_train_tinyreptile(torch, np, tm):
    core, ops, loss, phi = tm["core"], tm["ops"], tm["loss"], tm["phi"]
    base = core.evaluate_init(loss, {k: v.cuda() for k, v in phi.items()},
                              tm["SineTasks"](), np.random.default_rng(7),
                              **TR_EVAL)["query_loss"]
    kw = dict(alpha=1.0, beta=0.02, support=TR_SUPPORT, seed=1,
              eval_kwargs=TR_EVAL)

    def run(rounds, device):
        return core.tinyreptile_train(loss, phi, tm["SineTasks"](),
                                      rounds=rounds, eval_every=rounds,
                                      device=device, **kw)

    core.clear_runner_cache()
    out, wall, counts = timed_run(torch, ops,
                                  lambda: run(TR_ROUNDS, "cuda"))
    graph = built_round(tm["engine"])
    q = out["history"][-1]["query_loss"]
    check(math.isfinite(q) and q < base / 2,
          f"trained query MSE {q} is not below half the random init's "
          f"{base}")
    check(counts["meta_update"] == TR_ROUNDS,
          f"{counts['meta_update']} meta_update launches, {TR_ROUNDS} rounds")
    want_sgd = TR_ROUNDS * TR_SUPPORT + TR_EVAL["k_steps"]
    check(counts["online_sgd"] == want_sgd,
          f"{counts['online_sgd']} online_sgd launches, expected {want_sgd}")
    check(out["comm_bytes"] == TR_ROUNDS * 2 * PHI_BYTES, "comm_bytes")
    worst = compare_runs(np, run(TR_CHECK_ROUNDS, "cuda"),
                         run(TR_CHECK_ROUNDS, "cpu"))
    row = {"phase": "train_tinyreptile", "rounds": TR_ROUNDS,
           "support": TR_SUPPORT, "wall_s": wall,
           "rounds_per_s": TR_ROUNDS / wall, "launches": counts, **graph,
           "query_loss": q, "random_init_query_loss": base,
           "comm_bytes": out["comm_bytes"],
           "vs_cpu": {"rounds": TR_CHECK_ROUNDS, "tol": 1e-4,
                      "params_max_abs_diff": worst}}
    emit(row)
    return row


def launcher_run(torch, np, tm, argv, name):
    """The train launcher in-process on the card (its row is printed),
    then on the CPU; returns this phase's row."""
    tl, ops = tm["train"], tm["ops"]
    tm["core"].clear_runner_cache()
    (row, out), wall, counts = timed_run(
        torch, ops, lambda: tl.run_engine_strategy(tl.parse_args(argv)))
    graph = built_round(tm["engine"])
    _, want = tl.run_engine_strategy(tl.parse_args(argv + ["--device",
                                                           "cpu"]))
    worst = compare_runs(np, out, want)
    q = out["history"][-1]["query_loss"]
    check(math.isfinite(q), f"{name}: query loss {q}")
    return {"run": name, "argv": argv, "rounds": row["rounds"],
            "clients": row["clients"], "wall_s": wall,
            "rounds_per_s": row["rounds"] / wall, "launches": counts,
            **graph, "query_loss": q, "comm_bytes": out.get("comm_bytes"),
            "vs_cpu_params_max_abs_diff": worst}


def phase_train_reptile(torch, np, tm):
    row = launcher_run(torch, np, tm, ["--strategy", "reptile"],
                       "reptile_c64")
    rounds, clients = row["rounds"], row["clients"]
    check(row["comm_bytes"] == rounds * clients * 2 * PHI_BYTES,
          f"comm_bytes {row['comm_bytes']}")
    check(row["launches"]["meta_update"] == rounds, "meta_update launches")
    want_sgd = rounds * tm["train"].EPOCHS + \
        tm["train"].EVAL_KWARGS["k_steps"]
    check(row["launches"]["online_sgd"] == want_sgd,
          f"{row['launches']['online_sgd']} online_sgd launches, "
          f"expected {want_sgd}")
    emit({"phase": "train_reptile_c64", **row})
    return row


def phase_train_baselines(torch, np, tm):
    runs = [launcher_run(torch, np, tm, ["--strategy", s], s)
            for s in ("fedavg", "fedsgd", "transfer")]
    core, loss, phi = tm["core"], tm["loss"], tm["phi"]
    ev = tm["train"].EVAL_KWARGS

    def straggle(device):
        return core.tinyreptile_train(
            loss, phi, tm["SineTasks"](), rounds=20, beta=0.02,
            support=TR_SUPPORT, clients_per_round=8,
            sampling=core.StragglerSampling(0.5), eval_every=20,
            eval_kwargs=ev, device=device)

    core.clear_runner_cache()
    out, wall, counts = timed_run(torch, tm["ops"],
                                  lambda: straggle("cuda"))
    check(counts["meta_update"] == 20, "meta_update launches")
    runs.append({"run": "tinyreptile_c8_straggler0.5", "rounds": 20,
                 "clients": 8, "wall_s": wall, "rounds_per_s": 20 / wall,
                 "launches": counts, **built_round(tm["engine"]),
                 "query_loss": out["history"][-1]["query_loss"],
                 "comm_bytes": out["comm_bytes"],
                 "vs_cpu_params_max_abs_diff": compare_runs(
                     np, out, straggle("cpu"))})
    for r in runs:
        check(r["launches"]["online_sgd"] > 0,
              f"{r['run']}: no online_sgd launch")
    emit({"phase": "train_baselines", "runs": runs})
    return runs


def phase_profile_train(torch, tm):
    """Device busy share of TR_CHECK_ROUNDS TinyReptile rounds, after a
    run of the same config has built (captured) its round."""
    core, loss, phi = tm["core"], tm["loss"], tm["phi"]

    def run():
        return core.tinyreptile_train(loss, phi, tm["SineTasks"](),
                                      rounds=TR_CHECK_ROUNDS, beta=0.02,
                                      support=TR_SUPPORT, seed=1,
                                      device="cuda")

    run()
    # the device's activity only: the host-side op events of some 50k
    # launches would take longer to summarise than the run itself
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {ev.key: (ev.self_device_time_total, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == cuda and ev.self_device_time_total > 0}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile_train", "rounds": TR_CHECK_ROUNDS,
          "wall_ms": 1e3 * wall, "device_busy_ms": dev_us / 1e3,
          "device_idle_share": 1 - dev_us / 1e6 / wall,
          "kernels_launched": sum(c for _, c in by_name.values()),
          "top_device_ms": [[k[:80], t / 1e3, c] for k, (t, c) in top]})


def phase_fleet_tifed(torch, np, tm):
    """The train launcher's ``--strategy tifed`` at its defaults on the
    card and on the CPU: integer params exact, bytes exact, the int8
    loss within 1e-6, the eval within 1e-4; one build; every epoch of
    the cohort one ``dfa_epoch_int8`` launch."""
    tl, ops = tm["train"], tm["ops"]
    argv = ["--strategy", "tifed"]
    tm["core"].clear_runner_cache()
    (row, out), wall, counts = timed_run(
        torch, ops, lambda: tl.run_engine_strategy(tl.parse_args(argv)))
    graph = built_round(tm["engine"])
    _, want = tl.run_engine_strategy(tl.parse_args(argv + ["--device",
                                                           "cpu"]))
    rounds, clients = row["rounds"], row["clients"]
    check((rounds, clients) == (20, TIFED_CLIENTS),
          f"tifed launcher defaults: {rounds} rounds, {clients} clients")
    for k, v in want["params"].items():
        check(torch.equal(out["params"][k].cpu(), v),
              f"fleet_tifed: integer param {k} differs from the CPU")
    for key in ("comm_bytes", "per_client_bytes"):
        check(out[key] == want[key], f"fleet_tifed: {key}")
    check(out["comm_bytes"] == rounds * clients * 2 * PAPER_PARAMS[
        "sine_mlp"], f"fleet_tifed: comm_bytes {out['comm_bytes']}")
    (ge,), (we,) = out["history"], want["history"]
    loss_rel = abs(ge["inner_loss"] - we["inner_loss"]) / abs(
        we["inner_loss"])
    check(loss_rel <= 1e-6, f"fleet_tifed: inner loss {ge['inner_loss']} "
          f"vs {we['inner_loss']}")
    check(abs(ge["query_loss"] - we["query_loss"]) <= 1e-4 * max(
        1.0, abs(we["query_loss"])), "fleet_tifed: query loss")
    want_counts = {"dfa_epoch_int8": rounds * TIFED_EPOCHS,
                   "meta_update": rounds,
                   "online_sgd": tl.EVAL_KWARGS["k_steps"]}
    check_launches("fleet_tifed", counts, want_counts)
    emit({"phase": "fleet_tifed", "argv": argv, "rounds": rounds,
          "clients": clients, "support": tl.SUPPORT, "epochs": TIFED_EPOCHS,
          "wall_s": wall, "rounds_per_s": rounds / wall, "launches": counts,
          **graph, "query_loss": ge["query_loss"],
          "inner_loss": ge["inner_loss"], "inner_loss_rel_vs_cpu": loss_rel,
          "comm_bytes": out["comm_bytes"], "params_vs_cpu": "exact"})
    return {"fleet_tifed": counts}


def phase_fleet_partial(torch, np, tm):
    """TinyReptile at 64 clients on PartialCommChannel(0.25), the mask
    fixed and rotating: PARTIAL_ROUNDS rounds each on the card (bills
    exact, launches as reckoned), and the same config's first
    FLEET_CHECK_ROUNDS on the card and on the CPU (params within 1e-4,
    bills exact)."""
    core, loss, phi = tm["core"], tm["loss"], tm["phi"]
    rows, paths = [], {}
    for rotate in (False, True):
        channel = core.PartialCommChannel(fraction=PARTIAL_FRACTION,
                                          rotate=rotate)

        def run(rounds, device, channel=channel):
            return core.tinyreptile_train(
                loss, phi, tm["SineTasks"](), rounds=rounds, beta=0.02,
                support=TR_SUPPORT, clients_per_round=PARTIAL_CLIENTS,
                seed=5, channel=channel, eval_every=rounds,
                eval_kwargs=TR_EVAL, device=device)

        name = f"fleet_partial_{'rotating' if rotate else 'fixed'}"
        core.clear_runner_cache()
        out, wall, counts = timed_run(
            torch, tm["ops"], lambda: run(PARTIAL_ROUNDS, "cuda"))
        graph = built_round(tm["engine"])
        want_bytes = sum(2 * PARTIAL_CLIENTS * channel.payload_bytes_at(
            phi, r) for r in range(PARTIAL_ROUNDS))
        check(out["comm_bytes"] == want_bytes == sum(
            out["per_client_bytes"]),
            f"{name}: comm_bytes {out['comm_bytes']} vs {want_bytes}")
        check_launches(name, counts, {
            "online_sgd": PARTIAL_ROUNDS * TR_SUPPORT + TR_EVAL["k_steps"],
            "meta_update": PARTIAL_ROUNDS})
        q = out["history"][-1]["query_loss"]
        check(math.isfinite(q), f"{name}: query loss {q}")
        worst = compare_runs(np, run(FLEET_CHECK_ROUNDS, "cuda"),
                             run(FLEET_CHECK_ROUNDS, "cpu"))
        rows.append({"run": name, "fraction": PARTIAL_FRACTION,
                     "rotation_period": (channel.rotation_period if rotate
                                         else None),
                     "rounds": PARTIAL_ROUNDS, "clients": PARTIAL_CLIENTS,
                     "wall_s": wall, "rounds_per_s": PARTIAL_ROUNDS / wall,
                     "launches": counts, **graph, "query_loss": q,
                     "comm_bytes": out["comm_bytes"],
                     "full_wire_bytes": PARTIAL_ROUNDS * PARTIAL_CLIENTS * 2
                     * PHI_BYTES,
                     "vs_cpu": {"rounds": FLEET_CHECK_ROUNDS, "tol": 1e-4,
                                "params_max_abs_diff": worst}})
        paths[name] = counts
    emit({"phase": "fleet_partial", "runs": rows})
    return paths


def pool_run(tm, size, rounds, residency, device):
    """The sine MLP's TinyReptile over a fresh vectorized pool of ``size``
    devices: a cohort of POOL_COHORT under diurnal check-ins, a FedBuff
    buffer with a staleness deadline, one eval at the end."""
    core = tm["core"]
    pool = core.ClientPool(tm["SineTasks"](), size, seed=2,
                           sampler="vectorized", residency=residency)
    return core.tinyreptile_train(
        tm["loss"], tm["phi"], tm["SineTasks"](), rounds=rounds, beta=0.02,
        support=TR_SUPPORT, clients_per_round=POOL_COHORT, seed=2,
        sampling=core.DiurnalAvailability(period=POOL_PERIOD,
                                          sampler="vectorized"),
        pool=pool, buffered=core.BufferedAggregation(
            POOL_BUFFER, flush_staleness=POOL_DEADLINE),
        eval_every=rounds, eval_kwargs=TR_EVAL, device=device)


def replay_pool_state(np, tm, size, rounds):
    """``pool_run``'s identity state replayed on the host from its plan
    alone (the pool draws its data from its own streams, so the run's
    generator serves the plan only): last_seen, staleness, checkins."""
    core = tm["core"]
    policy = core.DiurnalAvailability(period=POOL_PERIOD,
                                      sampler="vectorized")
    rng = np.random.default_rng(2)
    last = np.full(size, -1, np.int64)
    stale = np.zeros(size, np.int64)
    seen = np.zeros(size, np.int64)
    for start, end in core.plan_blocks(rounds, rounds, 512)[0]:
        plan = policy.plan_pool_schedule(rng, start, end, POOL_COHORT,
                                         TR_SUPPORT, size)
        for j, r in enumerate(range(start, end)):
            m = plan["cohort"][j][plan["participation"][j]]
            stale[m] = r - last[m]
            last[m] = r
            seen[m] += 1
    return {"last_seen": last, "staleness": stale, "checkins": seen}


def phase_fleet_pool(torch, np, tm):
    """The persistent pool on the card: POOL_SIZE devices resident on the
    card for POOL_ROUNDS rounds (the pool state equal to a host replay of
    the plan, bills exact, one build, launches as reckoned: every round,
    no-show or not, replays the whole round, its 32 online_sgd and the
    FedBuff flush's meta_update), its first FLEET_CHECK_ROUNDS against
    the CPU, then POOL_BIG devices with their state in host slabs for
    POOL_BIG_ROUNDS against the CPU (pool state exact, params within
    1e-4); then FLEET_PROFILE_ROUNDS replayed rounds under the profiler."""
    core = tm["core"]
    rows, paths = [], {}
    for name, size, rounds, residency, check_rounds in (
            ("fleet_pool", POOL_SIZE, POOL_ROUNDS, "device",
             FLEET_CHECK_ROUNDS),
            ("fleet_pool_host", POOL_BIG, POOL_BIG_ROUNDS, "host",
             POOL_BIG_ROUNDS)):
        core.clear_runner_cache()
        out, wall, counts = timed_run(
            torch, tm["ops"],
            lambda: pool_run(tm, size, rounds, residency, "cuda"))
        graph = built_round(tm["engine"])
        ps = out["pool_state"]
        for k, v in replay_pool_state(np, tm, size, rounds).items():
            check(np.array_equal(ps[k], v),
                  f"{name}: pool state {k} differs from the plan's replay")
        checkins = int(ps["checkins"].sum())
        check(out["comm_bytes"] == 2 * PHI_BYTES * checkins,
              f"{name}: comm_bytes against {checkins} check-ins")
        check_launches(name, counts, {
            "online_sgd": rounds * TR_SUPPORT + TR_EVAL["k_steps"],
            "meta_update": rounds})
        got = (out if check_rounds == rounds else
               pool_run(tm, size, check_rounds, residency, "cuda"))
        want = pool_run(tm, size, check_rounds, residency, "cpu")
        worst = compare_runs(np, got, want)
        for k, v in want["pool_state"].items():
            check(np.array_equal(np.asarray(got["pool_state"][k]),
                                 np.asarray(v)),
                  f"{name}: pool state {k} differs from the CPU")
        seen = ps["checkins"] > 0
        rows.append({"run": name, "pool_size": size, "residency": residency,
                     "rounds": rounds, "cohort": POOL_COHORT,
                     "wall_s": wall, "rounds_per_s": rounds / wall,
                     "launches": counts, **graph,
                     "query_loss": out["history"][-1]["query_loss"],
                     "checkins": checkins,
                     "devices_seen": int(seen.sum()),
                     "staleness_max": int(ps["staleness"].max()),
                     "flushes": ps["flushes"],
                     "buffered_pending": ps["buffered_pending"],
                     "comm_bytes": out["comm_bytes"],
                     "pool_state_vs_replay": "exact",
                     "vs_cpu": {"rounds": check_rounds, "tol": 1e-4,
                                "params_max_abs_diff": worst,
                                "pool_state": "exact"}})
        paths[name] = counts
    rows.append(profile_fleet(torch, tm))
    emit({"phase": "fleet_pool", "runs": rows})
    return paths


def profile_fleet(torch, tm):
    """FLEET_PROFILE_ROUNDS pooled, buffered rounds (POOL_SIZE devices),
    after a run of the same config has built (captured) the round, under
    torch.profiler (device activity only): idle share, kernels a round,
    top kernels."""
    run = functools.partial(pool_run, tm, POOL_SIZE, FLEET_PROFILE_ROUNDS,
                            "device", "cuda")
    tm["core"].clear_runner_cache()
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    (runner,) = tm["engine"]._RUNNER_CACHE._entries.values()
    check(runner.trace_count == 1, "the profiled pooled round was built "
          "again")
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {ev.key: (ev.self_device_time_total, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == cuda and ev.self_device_time_total > 0}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    n = sum(c for _, c in by_name.values())
    return {"run": "profile_fleet", "rounds": FLEET_PROFILE_ROUNDS,
            "replayed": True, "wall_ms": 1e3 * wall,
            "round_ms": 1e3 * wall / FLEET_PROFILE_ROUNDS,
            "device_busy_ms": dev_us / 1e3,
            "device_idle_share": 1 - dev_us / 1e6 / wall,
            "kernels_per_round": n / FLEET_PROFILE_ROUNDS,
            "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                           for k, (t, c) in top]}


def phase_fleet_kws(torch, np, tm):
    """The port's KWS example with its persistent fleet (KWS_FLEET) on
    the card and on the CPU, its printout kept out of this script's:
    each run's accuracy within one query sample of the CPU's, the pool
    state and bills exact."""
    kws = tm["kws"]
    tm["core"].clear_runner_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        got, wall, counts = timed_run(
            torch, tm["ops"], lambda: kws.main(KWS_FLEET + ["--device",
                                                            "cuda"]))
        out = {"cuda": got, "cpu": kws.main(KWS_FLEET + ["--device", "cpu"])}
    one = 1.0 / (kws.EVAL["num_tasks"] * kws.EVAL["query"])
    accs = {}
    for run in ("tinyreptile", "fleet"):
        g, w = (out[d][run]["history"][-1]["query_metric"]
                for d in ("cuda", "cpu"))
        check(abs(g - w) <= one + 1e-9,
              f"fleet_kws {run}: accuracy {g} on the card, {w} on the CPU")
        accs[run] = {"cuda": g, "cpu": w}
    fleet, ref = out["cuda"]["fleet"], out["cpu"]["fleet"]
    for key in ("comm_bytes", "per_client_bytes"):
        check(fleet[key] == ref[key], f"fleet_kws: {key}")
    for k, v in ref["pool_state"].items():
        check(np.array_equal(np.asarray(fleet["pool_state"][k]),
                             np.asarray(v)), f"fleet_kws: pool state {k}")
    ps = fleet["pool_state"]
    rounds = kws.parse_args(KWS_FLEET).rounds
    check(counts["meta_update"] == 2 * rounds,
          f"fleet_kws: {counts['meta_update']} meta_update launches")
    emit({"phase": "fleet_kws", "argv": KWS_FLEET, "rounds": rounds,
          "wall_s": wall, "launches": counts, "accuracy": accs,
          "one_sample": one, "random_init": out["cuda"]["random_init"],
          "checkins": int(ps["checkins"].sum()),
          "devices_seen": int((ps["checkins"] > 0).sum()),
          "flushes": ps["flushes"],
          "buffered_pending": ps["buffered_pending"],
          "comm_bytes": fleet["comm_bytes"]})
    return {"fleet_kws": counts}


def same_run(torch, np, got, want, tag):
    """Two runs equal exactly: params, history rows (compared with ==:
    a row that went through a snapshot's JSON keeps its floats), bills
    and the pool state."""
    for k, v in want["params"].items():
        check(torch.equal(got["params"][k], v), f"{tag}: param {k} differs")
    check(got["history"] == want["history"],
          f"{tag}: history {got['history']} vs {want['history']}")
    for key in ("comm_bytes", "per_client_bytes"):
        check(got.get(key) == want.get(key), f"{tag}: {key} differs")
    check(("pool_state" in got) == ("pool_state" in want), f"{tag}: pool")
    for k, v in want.get("pool_state", {}).items():
        a, b = np.asarray(got["pool_state"][k]), np.asarray(v)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"{tag}: pool state {k} differs")


def ckpt_launches(name, rounds, start, tl):
    """The launches a run of ``ckpt_cases`` makes from round ``start``:
    per round ``TR_SUPPORT`` online_sgd (one a step for the cohort) or
    ``TIFED_EPOCHS`` dfa_epoch_int8, and one meta_update (a buffered run
    computes its flush every round); each eval past ``start`` adds its
    finetuning steps."""
    every = CKPT_POOL_ROUNDS // 2 if "pool" in name else CKPT_EVAL_EVERY
    evals = sum(1 for r in range(start + 1, rounds + 1) if r % every == 0)
    n = rounds - start
    if name.startswith("tifed"):
        return {"dfa_epoch_int8": n * TIFED_EPOCHS, "meta_update": n,
                "online_sgd": evals * tl.EVAL_KWARGS["k_steps"]}
    return {"online_sgd": n * TR_SUPPORT + evals * TR_EVAL["k_steps"],
            "meta_update": n}


def ckpt_cases(tm):
    """The crash/resume cases on the card, each ``run(**ckpt)`` one
    run_federated call with fresh pool and policy objects: TinyReptile
    at the launcher's 64 clients, TIFeD at the launcher's defaults
    (alpha 1 annealed), and the pooled fleet on the card and in host
    slabs."""
    core, tl = tm["core"], tm["train"]
    sine = tm["SineTasks"]

    def tinyreptile(rounds=CKPT_ROUNDS, anneal=True, **ckpt):
        return core.run_federated(
            tm["phi"], sine(), core.TinyReptileStrategy(tm["loss"]),
            rounds=rounds, clients_per_round=TIFED_CLIENTS,
            support=TR_SUPPORT, beta=0.02, seed=11, anneal=anneal,
            eval_every=CKPT_EVAL_EVERY, eval_kwargs=TR_EVAL, device="cuda",
            **ckpt)

    def tifed(**ckpt):
        return core.run_federated(
            tm["phi"], sine(), core.TifedStrategy(tm["nets"].relu_mlp_loss,
                                                  epochs=TIFED_EPOCHS),
            rounds=CKPT_ROUNDS, clients_per_round=TIFED_CLIENTS,
            support=TIFED_SUPPORT, beta=0.02, seed=0,
            eval_every=CKPT_EVAL_EVERY,
            eval_kwargs=dict(tl.EVAL_KWARGS, lr=tl.TIFED_EVAL_LR),
            channel=core.CommChannel("int8", quantize=False),
            device="cuda", **ckpt)

    def fleet(residency, markov):
        def run(**ckpt):
            pool = core.ClientPool(sine(), POOL_SIZE, seed=2,
                                   sampler="vectorized", residency=residency)
            sampling = (core.MarkovAvailability(sampler="vectorized")
                        if markov else core.DiurnalAvailability(
                            period=POOL_PERIOD, sampler="vectorized"))
            return core.run_federated(
                tm["phi"], sine(), core.TinyReptileStrategy(tm["loss"]),
                rounds=CKPT_POOL_ROUNDS, clients_per_round=POOL_COHORT,
                support=TR_SUPPORT, beta=0.02, seed=2, sampling=sampling,
                pool=pool, buffered=core.BufferedAggregation(
                    POOL_BUFFER, flush_staleness=POOL_DEADLINE),
                eval_every=CKPT_POOL_ROUNDS // 2, eval_kwargs=TR_EVAL,
                device="cuda", **ckpt)
        return run

    return {"tinyreptile_c64": (tinyreptile, CKPT_ROUNDS),
            "tifed_c64": (tifed, CKPT_ROUNDS),
            "pool_diurnal_fedbuff": (fleet("device", False),
                                     CKPT_POOL_ROUNDS),
            "pool_host_markov_fedbuff": (fleet("host", True),
                                         CKPT_POOL_ROUNDS)}


def snapshot_files(np, d):
    """Each snapshot's arrays by step (``__extra__`` included)."""
    from repro_torch.checkpoint import list_checkpoints
    out = {}
    for path in list_checkpoints(d):
        with np.load(path) as z:
            out[int(Path(path).stem[5:])] = {k: z[k] for k in z.files}
    return out


def phase_ckpt_resume(torch, np, tm):
    """Crash and resume on the card: for each case an uninterrupted run
    (snapshots by the async writer, each block following its snapshot at
    once), a run crashed right after its round-4 snapshot
    (``ckpt_async=False``) and its resume, all with ckpt_every 4 in one
    process: the resumed run equals the uninterrupted one exactly
    (params, history, bills, pool state), and the config's round was
    built once. The async writer's files equal those a synchronous run
    writes, and a run resumed past its horizon (16 -> 24 rounds, no
    annealing) equals a 24-round run."""
    from repro_torch.testing import faults

    core, engine = tm["core"], tm["engine"]
    rows, paths, refs = [], {}, {}
    for name, (run, rounds) in ckpt_cases(tm).items():
        core.clear_runner_cache()
        with tempfile.TemporaryDirectory() as d:
            ck = dict(ckpt_every=CKPT_EVERY)
            ref, ref_wall, _ = timed_run(
                torch, tm["ops"], lambda: run(ckpt_dir=f"{d}/ref", **ck))
            try:
                with faults.crash_at_round(CKPT_EVERY):
                    run(ckpt_dir=f"{d}/ck", ckpt_async=False, **ck)
                check(False, f"ckpt_resume {name}: the crash never fired")
            except faults.SimulatedPreemption:
                pass
            res, wall, counts = timed_run(
                torch, tm["ops"],
                lambda: run(ckpt_dir=f"{d}/ck", resume=True, **ck))
            same_run(torch, np, res, ref, f"ckpt_resume {name}")
            check_launches(f"ckpt_resume {name}", counts, ckpt_launches(
                name, rounds, CKPT_EVERY, tm["train"]))
            row = {"run": name, "rounds": rounds, "ckpt_every": CKPT_EVERY,
                   "crash_after": CKPT_EVERY,
                   "uninterrupted_wall_s": ref_wall, "resume_wall_s": wall,
                   "launches": counts, **built_round(engine),
                   "cache": core.runner_cache_stats(),
                   "vs_uninterrupted": "exact"}
            if name == "tinyreptile_c64":
                run(ckpt_dir=f"{d}/sync", ckpt_async=False, **ck)
                want = snapshot_files(np, f"{d}/sync")
                got = snapshot_files(np, f"{d}/ref")
                check(sorted(got) == sorted(want),
                      f"ckpt_resume: snapshots {sorted(got)} vs "
                      f"{sorted(want)}")
                for step, arrays in want.items():
                    for k, v in arrays.items():
                        check(np.array_equal(got[step][k], v),
                              f"ckpt_resume: async snapshot {step} {k} "
                              f"differs from the synchronous one")
                row["async_snapshots_vs_sync"] = sorted(want)
                refs[name] = ref
            if "pool" in name:
                ps = res["pool_state"]
                row.update(pool_size=POOL_SIZE,
                           checkins=int(ps["checkins"].sum()),
                           flushes=ps["flushes"])
        rows.append(row)
        paths[f"ckpt_resume_{name}"] = counts

    # past the horizon: 16 rounds, resumed to 24, against 24 from round 0
    tiny = ckpt_cases(tm)["tinyreptile_c64"][0]
    core.clear_runner_cache()
    with tempfile.TemporaryDirectory() as d:
        ck = dict(ckpt_every=CKPT_EVERY, anneal=False)
        tiny(ckpt_dir=f"{d}/ck", ckpt_async=False, **ck)
        res, wall, counts = timed_run(torch, tm["ops"], lambda: tiny(
            rounds=CKPT_PAST, ckpt_dir=f"{d}/ck", resume=True, **ck))
        want = tiny(rounds=CKPT_PAST, ckpt_dir=f"{d}/fresh", **ck)
        same_run(torch, np, res, want, "ckpt_resume past_horizon")
        check_launches("ckpt_resume past_horizon", counts, ckpt_launches(
            "tinyreptile", CKPT_PAST, CKPT_ROUNDS, tm["train"]))
        rows.append({"run": "past_horizon", "rounds": [CKPT_ROUNDS,
                                                       CKPT_PAST],
                     "resume_wall_s": wall, "launches": counts,
                     **built_round(engine), "vs_fresh": "exact"})
    paths["ckpt_resume_past_horizon"] = counts
    emit({"phase": "ckpt_resume", "runs": rows})
    return paths, refs["tinyreptile_c64"]


#: the SIGKILL child: the TinyReptile case with the async writer, each
#: durable snapshot announced; the writer then holds (a slow disk), so
#: the kill lands while the run is still going however fast the card is
CKPT_CHILD = """
import functools, sys, time
import torch
sys.path.insert(0, sys.argv[2])
from repro_torch import core
from repro_torch.checkpoint import ckpt
from repro_torch.configs.paper_models import SINE_MLP
from repro_torch.data import SineTasks
from repro_torch.models.paper_nets import init_paper_model, paper_model_loss
from repro_torch.testing import faults
phi = init_paper_model(SINE_MLP, torch.Generator().manual_seed(0), "cpu")
kw = {kw}
with faults.announce_snapshots():
    announce = ckpt._post_save_hook
    def hold(step):
        announce(step)
        time.sleep(600)
    ckpt._post_save_hook = hold
    core.run_federated(phi, SineTasks(), core.TinyReptileStrategy(
        functools.partial(paper_model_loss, SINE_MLP)), ckpt_dir=sys.argv[1],
        device="cuda", **kw)
"""


def phase_ckpt_sigkill(torch, np, tm, ref):
    """A real preemption on the card: a child process (started with
    ``subprocess``, so it shares no CUDA context) runs the TinyReptile
    case with the async writer and is SIGKILLed right after its first
    durable snapshot; its kernels were built by this process, so it
    builds none. This process resumes from whatever is on disk and must
    equal the uninterrupted card run exactly."""
    from repro_torch.kernels import build
    from repro_torch.testing import faults

    kw = dict(rounds=CKPT_ROUNDS, clients_per_round=TIFED_CLIENTS,
              support=TR_SUPPORT, beta=0.02, seed=11,
              eval_every=CKPT_EVAL_EVERY, eval_kwargs=TR_EVAL,
              ckpt_every=CKPT_EVERY)
    libs = sorted(build.BUILD_DIR.glob("*.so"))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rc, out = faults.kill_after_snapshot(
            [sys.executable, "-c", CKPT_CHILD.format(kw=kw), d, str(SRC)],
            n=1, timeout=300)
        child_s = time.perf_counter() - t0
        check(rc is not None and rc != 0,
              f"ckpt_sigkill: the child exited {rc}, not killed:\n{out}")
        check(faults.SNAPSHOT_TAG in out, "ckpt_sigkill: no snapshot line")
        check(sorted(build.BUILD_DIR.glob("*.so")) == libs,
              "ckpt_sigkill: the child built kernels")
        from repro_torch.checkpoint import list_checkpoints
        on_disk = [Path(p).name for p in list_checkpoints(d)]
        tm["core"].clear_runner_cache()
        res, wall, counts = timed_run(
            torch, tm["ops"], lambda: ckpt_cases(tm)["tinyreptile_c64"][0](
                ckpt_dir=d, resume=True, ckpt_every=CKPT_EVERY))
    same_run(torch, np, res, ref, "ckpt_sigkill")
    start = max(int(Path(p).stem[5:]) for p in on_disk)
    check_launches("ckpt_sigkill", counts, ckpt_launches(
        "tinyreptile", CKPT_ROUNDS, start, tm["train"]))
    emit({"phase": "ckpt_sigkill", "child_rc": rc, "child_s": child_s,
          "snapshots_on_disk": on_disk,
          "announced": [ln for ln in out.splitlines()
                        if faults.SNAPSHOT_TAG in ln],
          "resume_wall_s": wall, "launches": counts,
          **built_round(tm["engine"]), "vs_uninterrupted": "exact"})
    return {"ckpt_sigkill_resume": counts}


def phase_ckpt_overhead(torch, np, tm):
    """What snapshots cost: the quickstart-shaped 600-round TinyReptile
    run without and with ckpt_every 10 (the async writer), both built
    first, then timed in turns; rounds/s of each, their ratio, and with
    a tracker attached to one more snapshotting run, the milliseconds of
    a snapshot on the training thread (device copies and the submit) and
    on the writer's. The JAX package's target is under 5% at every 10
    rounds; this is reported, not gated. The two runs' params are equal
    (snapshots change the block cuts, not the rounds)."""
    core = tm["core"]

    def run(d=None, tracker=None):
        return core.run_federated(
            tm["phi"], tm["SineTasks"](),
            core.TinyReptileStrategy(tm["loss"]), rounds=TR_ROUNDS,
            support=TR_SUPPORT, beta=0.02, seed=1, eval_every=TR_ROUNDS,
            eval_kwargs=TR_EVAL, ckpt_dir=d, ckpt_every=OVERHEAD_EVERY,
            tracker=tracker, device="cuda")

    core.clear_runner_cache()
    walls = {"base": [], "ckpt": []}
    with tempfile.TemporaryDirectory() as d:
        base, ckpt = run(), run(f"{d}/warm")           # build both rounds
        same_run(torch, np, ckpt, base, "ckpt_overhead: ckpt vs base")
        for i in range(OVERHEAD_PAIRS):
            for kind in ("base", "ckpt"):
                _, wall, _ = timed_run(torch, tm["ops"], lambda: run(
                    f"{d}/{kind}{i}" if kind == "ckpt" else None))
                walls[kind].append(wall)
        tracker = tm["MetricsTracker"]()
        run(f"{d}/traced", tracker)
    rate = {k: TR_ROUNDS / statistics.median(v) for k, v in walls.items()}
    snap = tracker.observations["ckpt.snapshot_ms"]
    write = tracker.observations["ckpt.write_ms"]
    check(len(snap) == len(write) == TR_ROUNDS // OVERHEAD_EVERY,
          f"ckpt_overhead: {len(snap)} snapshots, {len(write)} writes")
    emit({"phase": "ckpt_overhead", "rounds": TR_ROUNDS,
          "ckpt_every": OVERHEAD_EVERY, "pairs": OVERHEAD_PAIRS,
          "walls_s": walls, "rounds_per_s": rate,
          "ckpt_over_base": rate["ckpt"] / rate["base"],
          "overhead": 1 - rate["ckpt"] / rate["base"],
          "reference_target": "< 0.05 at ckpt_every 10 (not gated)",
          "snapshots": len(snap),
          "snapshot_ms_training_thread": {
              "median": statistics.median(snap), "max": max(snap)},
          "write_ms_writer_thread": {
              "median": statistics.median(write), "max": max(write)},
          "params_vs_base": "exact"})


def phase_paper_models(torch, np, tm):
    """Paper Tables I-IV on the card. Table I: each model's parameters
    from its init and its fp32 size. Table II: ``algorithm_memory_report``
    at S = 32, equal to the JAX package's dicts. Tables III-IV: one
    client's update (``client_update``, as the round engine runs it) of
    TinyReptile against Reptile with 8 epochs at S = 32, on the support
    set ``benchmarks/table34_round_time.py`` draws, timed with CUDA events
    (median of PASSES), eagerly and built once (captured, replayed); the
    built update's result equals the eager one bit for bit."""
    core, graphs, nets = tm["core"], tm["graphs"], tm["nets"]
    from repro_torch.bridge import FlatLayout
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.data import KWSTasks, OmniglotTasks, SineTasks
    from repro_torch.metering import algorithm_memory_report

    dists = {"sine_mlp": SineTasks(), "kws_conv": KWSTasks(),
             "omniglot_conv": OmniglotTasks()}
    rng = np.random.default_rng(0)
    beta = 0.01
    table1, table2, table34 = {}, {}, {}
    for name, cfg in PAPER_MODELS.items():
        params = nets.init_paper_model(cfg, torch.Generator().manual_seed(0),
                                       "cuda")
        n = nets.param_count(params)
        check(n == PAPER_PARAMS[name], f"{name}: {n} parameters")
        table1[name] = {"params": n, "fp32_kb": n * 4 / 1024}
        mem = algorithm_memory_report(cfg, support=32)
        check(mem == TABLE2[name], f"{name}: Table II {mem}")
        table2[name] = {k: mem[k] for k in ("reptile_bytes",
                                            "tinyreptile_bytes",
                                            "reduction_factor")}

        loss = tm["loss_of"](cfg)
        sup = dists[name].sample_task(rng).support_batch(rng, T34_S)
        batch = {k: torch.from_numpy(np.asarray(v)[None]).cuda()
                 for k, v in sup.items()}
        layout = FlatLayout.of(params)
        phi = layout.pack(params)
        row = {}
        for strat, key in ((core.TinyReptileStrategy(loss), "tinyreptile"),
                           (core.ReptileStrategy(loss, epochs=T34_EPOCHS),
                            "reptile")):
            def update():
                return strat.client_update(layout, phi, batch, beta)[0]

            out = torch.empty_like(phi)[None]
            step = graphs.GraphStep(lambda: out.copy_(update()),
                                    torch.device("cuda"))
            step()                                   # run, then capture
            torch.cuda.synchronize()
            check(torch.equal(out, update()),
                  f"{name} {key}: the built update differs from eager")
            row[key] = {"eager_ms": cuda_ms(torch, update, 3),
                        "built_ms": cuda_ms(torch, step, 10),
                        "graph_nodes": step.nodes,
                        "capture_s": step.capture_s}
        for how in ("eager", "built"):
            row[f"reptile_over_tinyreptile_{how}"] = (
                row["reptile"][f"{how}_ms"] / row["tinyreptile"][f"{how}_ms"])
        table34[name] = row
    emit({"phase": "paper_models", "support_table2": 32,
          "support_table34": T34_S, "epochs_table34": T34_EPOCHS,
          "table1": table1, "table2": table2, "table34": table34})


def fig4_runs(tm, cfg, dist, phi, ev):
    """Fig. 4's three runs of one net, by name: (run, rounds, clients,
    epochs a round, or None for the stream)."""
    core, loss = tm["core"], tm["loss_of"](cfg)
    common = dict(eval_kwargs=ev, **FIG4_KW)
    return {
        "tinyreptile": (lambda dev: core.tinyreptile_train(
            loss, phi, dist, rounds=FIG4_ROUNDS, eval_every=FIG4_ROUNDS,
            device=dev, **common), FIG4_ROUNDS, 1, None),
        "reptile_serial": (lambda dev: core.reptile_train(
            loss, phi, dist, rounds=FIG4_ROUNDS, epochs=8,
            eval_every=FIG4_ROUNDS, device=dev, **common), FIG4_ROUNDS, 1,
            8),
        "reptile_c4": (lambda dev: core.reptile_train(
            loss, phi, dist, rounds=FIG4_C4_ROUNDS, epochs=8,
            clients_per_round=FIG4_CLIENTS, eval_every=FIG4_C4_ROUNDS,
            device=dev, **common), FIG4_C4_ROUNDS, FIG4_CLIENTS, 8)}


def phase_fig4_conv(torch, np, tm):
    """Paper Fig. 4 on the card (``benchmarks/fig4_omniglot_kws.py``'s
    setting): Omniglot 5-way and KWS 4-way, TinyReptile and serial
    Reptile for 120 rounds, batched Reptile for 30 rounds at 4 clients,
    alpha 1, beta 0.01, support 16, seed 4, one eval at the end with the
    accuracy metric. Each run's launch counters are set to 0 just before
    it and read just after, its round built once; beside it the random
    init's accuracy on the same eval clients and chance. Then the JAX
    test's KWS gate, each net's run against the CPU, and a profile of
    Omniglot TinyReptile rounds."""
    core, ops, nets, dists = tm["core"], tm["ops"], tm["nets"], tm["dists"]
    rows, paths = {}, {}
    for tag, name, chance in (("omniglot5", "omniglot_conv", 0.2),
                              ("kws4", "kws_conv", 0.25)):
        cfg = tm["cfgs"][name]
        phi = nets.init_paper_model(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        ev = dict(FIG4_EVAL, metric_fn=tm["acc_of"](cfg))
        base = core.evaluate_init(
            tm["loss_of"](cfg), {k: v.cuda() for k, v in phi.items()},
            dists[name], np.random.default_rng(10_000 + FIG4_ROUNDS - 1),
            **ev)
        rows[tag] = {"chance": chance, "random_init": base}
        for run_name, (run, rounds, clients, epochs) in fig4_runs(
                tm, cfg, dists[name], phi, ev).items():
            core.clear_runner_cache()
            out, wall, counts = timed_run(torch, ops, lambda: run("cuda"))
            graph = built_round(tm["engine"])
            steps = FIG4_KW["support"] if epochs is None else epochs
            check_launches(f"fig4 {tag} {run_name}", counts, {
                "online_sgd": rounds * steps + FIG4_EVAL["k_steps"],
                "meta_update": rounds})
            last = out["history"][-1]
            check(math.isfinite(last["query_loss"])
                  and 0 <= last["query_metric"] <= 1,
                  f"fig4 {tag} {run_name}: {last}")
            check(out["comm_bytes"] == rounds * clients * 2 * 4
                  * PAPER_PARAMS[name], f"fig4 {tag} {run_name}: comm_bytes")
            rows[tag][run_name] = {
                "rounds": rounds, "clients": clients, "wall_s": wall,
                "rounds_per_s": rounds / wall, **graph, "launches": counts,
                "query_metric": last["query_metric"],
                "query_loss": last["query_loss"],
                "comm_bytes": out["comm_bytes"]}
            paths[f"fig4_{tag}_{run_name}"] = counts

    # the JAX package's own threshold, at its test's setting
    kws = tm["cfgs"]["kws_conv"]
    phi = nets.init_paper_model(kws, torch.Generator().manual_seed(1), "cpu")
    core.clear_runner_cache()
    out, wall, counts = timed_run(torch, ops, lambda: core.tinyreptile_train(
        tm["loss_of"](kws), phi, dists["kws_conv"],
        eval_every=KWS_GATE["rounds"], device="cuda",
        eval_kwargs=dict(KWS_GATE_EVAL, metric_fn=tm["acc_of"](kws)),
        **KWS_GATE))
    acc = out["history"][-1]["query_metric"]
    check(acc > KWS_GATE_MIN, f"KWS TinyReptile accuracy {acc} is not above "
                              f"{KWS_GATE_MIN} at the JAX test's setting")
    check_launches("fig4 kws gate", counts, {
        "online_sgd": KWS_GATE["rounds"] * KWS_GATE["support"]
        + KWS_GATE_EVAL["k_steps"], "meta_update": KWS_GATE["rounds"]})
    rows["kws_gate"] = {**KWS_GATE, "eval": KWS_GATE_EVAL,
                        "query_metric": acc, "min": KWS_GATE_MIN,
                        "wall_s": wall, **built_round(tm["engine"])}
    paths["fig4_kws_gate"] = counts

    # the card against the CPU from the same init, params within 1e-4
    vs_cpu = {}
    for name in ("omniglot_conv", "kws_conv"):
        cfg = tm["cfgs"][name]
        phi = nets.init_paper_model(cfg, torch.Generator().manual_seed(2),
                                    "cpu")
        checks = [("tinyreptile", lambda dev: core.tinyreptile_train(
            tm["loss_of"](cfg), phi, dists[name],
            rounds=CONV_CHECK_ROUNDS, device=dev, **FIG4_KW))]
        if name == "kws_conv":
            checks.append(("reptile_c4", lambda dev: core.reptile_train(
                tm["loss_of"](cfg), phi, dists[name],
                rounds=CONV_CHECK_C4_ROUNDS, epochs=8,
                clients_per_round=FIG4_CLIENTS, device=dev, **FIG4_KW)))
        for run_name, run in checks:
            vs_cpu[f"{name}_{run_name}"] = compare_runs(np, run("cuda"),
                                                        run("cpu"))
    rows["vs_cpu"] = {"tol": 1e-4, "rounds": CONV_CHECK_ROUNDS,
                      "c4_rounds": CONV_CHECK_C4_ROUNDS,
                      "params_max_abs_diff": vs_cpu}
    rows["profile_omniglot_tinyreptile"] = profile_conv(torch, tm)
    emit({"phase": "fig4_conv", **rows})
    return paths


def profile_conv(torch, tm):
    """CONV_PROFILE_ROUNDS Omniglot TinyReptile rounds, after a run of
    the same config has built (captured) its round, under torch.profiler
    (device activity only): the idle share, kernels a round, top kernels
    and the convolutions' share of busy time."""
    core, cfg = tm["core"], tm["cfgs"]["omniglot_conv"]
    phi = tm["nets"].init_paper_model(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
    loss = tm["loss_of"](cfg)     # one loss: one cached runner, one build

    def run():
        return core.tinyreptile_train(
            loss, phi, tm["dists"]["omniglot_conv"],
            rounds=CONV_PROFILE_ROUNDS, device="cuda", **FIG4_KW)

    core.clear_runner_cache()
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    (runner,) = tm["engine"]._RUNNER_CACHE._entries.values()
    check(runner.trace_count == 1, "the profiled conv round was built again")
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {ev.key: (ev.self_device_time_total, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == cuda and ev.self_device_time_total > 0}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    conv_us = sum(t for k, (t, _) in by_name.items()
                  if any(s in k.lower() for s in ("conv", "cudnn", "wgrad",
                                                  "dgrad", "fprop")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    n = sum(c for _, c in by_name.values())
    return {"rounds": CONV_PROFILE_ROUNDS, "replayed": True,
            "wall_ms": 1e3 * wall,
            "round_ms": 1e3 * wall / CONV_PROFILE_ROUNDS,
            "device_busy_ms": dev_us / 1e3,
            "device_idle_share": 1 - dev_us / 1e6 / wall,
            "kernels_per_round": n / CONV_PROFILE_ROUNDS,
            "conv_kernels_share_of_busy": conv_us / dev_us,
            "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                           for k, (t, c) in top]}


@contextlib.contextmanager
def uncaptured(graphs):
    """Every ``GraphStep`` call runs its function eagerly on the card:
    the uncaptured round and tick the graphs are held to."""
    capture = graphs.GraphStep._warm_up_and_capture
    graphs.GraphStep._warm_up_and_capture = lambda self: self.fn()
    try:
        yield
    finally:
        graphs.GraphStep._warm_up_and_capture = capture


def conv_graph_runs(torch, tm):
    """graphs_vs_eager's conv rounds: Omniglot TinyReptile (20 rounds)
    and KWS Reptile at 4 clients (10 rounds), Fig. 4's settings, an eval
    with the accuracy metric every 10 rounds."""
    core, nets, dists = tm["core"], tm["nets"], tm["dists"]
    out = {}
    for key, name, rounds, extra in (
            ("omniglot_tinyreptile", "omniglot_conv", 20, None),
            ("kws_reptile_c4", "kws_conv", 10,
             dict(epochs=8, clients_per_round=FIG4_CLIENTS))):
        cfg = tm["cfgs"][name]
        phi = nets.init_paper_model(cfg, torch.Generator().manual_seed(3),
                                    "cpu")
        kw = dict(rounds=rounds, eval_every=10, device="cuda",
                  eval_kwargs=dict(FIG4_EVAL, metric_fn=tm["acc_of"](cfg)),
                  **FIG4_KW)
        train = core.reptile_train if extra else core.tinyreptile_train
        out[key] = (lambda train=train, cfg=cfg, phi=phi, name=name, kw=kw,
                    extra=extra: train(tm["loss_of"](cfg), phi, dists[name],
                                       **kw, **(extra or {})))
    return out


def phase_graphs(torch, np, tm, serves, extra, conv_runs):
    """The captured round and tick, replayed, against the same round and
    tick run eagerly on the card: params, histories, served results and
    launch counts equal, bit for bit. The round: TinyReptile (the
    quickstart's client, 40 rounds), Reptile and FedAvg at 8 clients,
    TinyReptile on the int8 wire, the pooled and buffered sine round (40
    rounds, its pool state too), TIFeD at 64 clients (20 rounds), and
    the conv nets' ``conv_runs``; the
    tick: 128 fp32 and 128 TIFeD requests at the serve phases' settings.
    Each with its capture time and graph size."""
    core, ops, graphs, loss, phi = (tm["core"], tm["ops"], tm["graphs"],
                                    tm["loss"], tm["phi"])
    ev = tm["train"].EVAL_KWARGS
    common = dict(beta=0.02, support=TR_SUPPORT, seed=4, eval_every=20,
                  device="cuda")
    runs = {
        "tinyreptile": lambda: core.tinyreptile_train(
            loss, phi, tm["SineTasks"](), rounds=40, eval_kwargs=TR_EVAL,
            **common),
        "reptile_c8": lambda: core.reptile_train(
            loss, phi, tm["SineTasks"](), rounds=20, clients_per_round=8,
            eval_kwargs=ev, **common),
        "fedavg_c8": lambda: core.fedavg_train(
            loss, phi, tm["SineTasks"](), rounds=20, clients_per_round=8,
            eval_kwargs=ev, **common),
        "tinyreptile_int8_wire": lambda: core.tinyreptile_train(
            loss, phi, tm["SineTasks"](), rounds=40, eval_kwargs=TR_EVAL,
            channel=core.CommChannel("int8"), **common),
        # the fleet: the pooled, buffered sine round (a fresh pool each
        # run) and TIFeD's integer round at the launcher's cohort
        "pooled_buffered_sine": lambda: pool_run(tm, POOL_SIZE, 40,
                                                 "device", "cuda"),
        "tifed_c64": lambda: core.tifed_train(
            phi, tm["SineTasks"](), rounds=20, support=TIFED_SUPPORT,
            clients_per_round=TIFED_CLIENTS, seed=4, eval_every=20,
            eval_kwargs=dict(ev, lr=tm["train"].TIFED_EVAL_LR),
            device="cuda"), **conv_runs}
    rows = {}
    for name, run in runs.items():
        core.clear_runner_cache()
        got, _, counts = timed_run(torch, ops, run)
        info = built_round(tm["engine"])
        core.clear_runner_cache()
        with uncaptured(graphs):
            want, _, eager = timed_run(torch, ops, run)
        core.clear_runner_cache()
        check(counts == eager, f"graphs {name}: launches {counts} vs {eager}")
        check(all(torch.equal(got["params"][k], v)
                  for k, v in want["params"].items()),
              f"graphs {name}: the captured round's params differ")
        check(got["history"] == want["history"],
              f"graphs {name}: the captured round's history differs")
        for k, v in want.get("pool_state", {}).items():
            check(np.array_equal(np.asarray(got["pool_state"][k]),
                                 np.asarray(v)),
                  f"graphs {name}: the captured round's pool state differs")
        rows[name] = {**info, "launches": counts, "bit_equal": True}
    AdaptationServer = serves["server"]
    for name, (adapter, p, reqs, k_max) in serves["routes"].items():
        def drain():
            server = AdaptationServer(p, adapter, slots=SLOTS, k_max=k_max,
                                      steps_per_tick=STEPS_PER_TICK,
                                      return_params=True, device="cuda")
            return server, serve(server, reqs[:128])

        (server, got), _, counts = timed_run(torch, ops, drain)
        with uncaptured(graphs):
            (_, want), _, eager = timed_run(torch, ops, drain)
        check(server.trace_count == 1, f"graphs {name}: trace_count")
        check(counts == eager, f"graphs {name}: launches {counts} vs {eager}")
        for g, w in zip(got, want):
            check((g.steps, g.query_loss) == (w.steps, w.query_loss)
                  and all(np.array_equal(g.params[k], w.params[k])
                          for k in w.params),
                  f"graphs {name}: request {g.rid} differs from the "
                  f"uncaptured tick")
        rows[name] = {"trace_count": server.trace_count,
                      "capture_s": server._tick_step.capture_s,
                      "graph_nodes": server._tick_step.nodes,
                      "launches": counts, "bit_equal": True}
    emit({"phase": "graphs_vs_eager", **rows, **extra})


def lm_launches(args):
    """Launches one LM launcher run must make: one ssd_scan per layer per
    inner step, one online_sgd per dtype group per step, one meta_update
    per dtype group per round (the backward takes the plain gradient and
    recomputes nothing through the kernel)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    groups = 1 if cfg.dtype == "float32" else 2      # bf16 beside fp32
    return {"ssd_scan": args.rounds * args.k_inner * cfg.num_layers,
            "online_sgd": args.rounds * args.k_inner * groups,
            "meta_update": args.rounds * groups}


def check_launches(name, counts, want):
    for k, v in want.items():
        check(counts[k] == v, f"{name}: {counts[k]} {k} launches, "
                              f"expected {v}")
    check(all(counts[k] == 0 for k in counts if k not in want),
          f"{name}: unexpected launches {counts}")


def phase_train_lm_reduced(torch, np, tm):
    """The reduced mamba2 LM launcher on the card, then on the CPU, from
    the same seeded init: rows and final params within 1e-4, comm exact."""
    tl, ops, bridge = tm["train"], tm["ops"], tm["bridge"]
    args = tl.parse_args(LM_REDUCED)
    (rows, summary, phi), wall, counts = timed_run(
        torch, ops, lambda: tl.run_lm(args))
    want_rows, _, want_phi = tl.run_lm(tl.parse_args(LM_REDUCED + [
        "--device", "cpu"]))
    check_launches("train_lm_reduced", counts, lm_launches(args))
    check(len(rows) == len(want_rows), "row count")
    worst_row = 0.0
    for got, want in zip(rows, want_rows):
        check(got["comm_mb"] == want["comm_mb"], f"comm_mb {got} vs {want}")
        check(got["alpha"] == want["alpha"], f"alpha {got} vs {want}")
        for k in ("loss", "inner_first", "inner_last", "client"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
            worst_row = max(worst_row, abs(got[k] - want[k]))
    worst = 0.0
    got_leaves = bridge.flatten_tree(phi)
    for path, want in bridge.flatten_tree(want_phi).items():
        a, b = got_leaves[path].float().cpu().numpy(), want.float().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))
        worst = max(worst, float(np.abs(a - b).max()))
    row = {"phase": "train_lm_reduced", "argv": LM_REDUCED, "wall_s": wall,
           "launches": counts, "comm_mb": summary["comm_mb"],
           "rows": rows, "vs_cpu": {"tol": 1e-4, "rows_max_abs_diff": worst_row,
                                    "params_max_abs_diff": worst}}
    emit(row)
    return row


def phase_train_lm_full(torch, np, tm):
    """mamba2-130m at full width and depth, bf16, through the launcher."""
    tl, ops = tm["train"], tm["ops"]
    args = tl.parse_args(LM_FULL)
    torch.cuda.reset_peak_memory_stats()
    (rows, summary, phi), wall, counts = timed_run(
        torch, ops, lambda: tl.run_lm(args))
    check_launches("train_lm_mamba2_130m", counts, lm_launches(args))
    for r in rows:
        for k in ("loss", "inner_first", "inner_last"):
            check(math.isfinite(r[k]), f"round {r['round']} {k} = {r[k]}")
    first = statistics.mean(r["inner_first"] for r in rows)
    last = statistics.mean(r["inner_last"] for r in rows)
    check(last < first, f"no client adaptation: mean inner_last {last} >= "
                        f"mean inner_first {first}")
    counts_by_dtype = {}
    for _, leaf in tm["bridge"].tree_leaves(phi):
        key = str(leaf.dtype).split(".")[1]
        counts_by_dtype[key] = counts_by_dtype.get(key, 0) + leaf.numel()
    check(counts_by_dtype == {"bfloat16": LM_BF16, "float32": LM_FP32},
          f"parameter counts {counts_by_dtype}")
    tokens = args.rounds * args.batch * args.seq
    rounds_s = sum(r["dt_s"] for r in rows)
    row = {"phase": "train_lm_mamba2_130m", "argv": LM_FULL,
           "params": counts_by_dtype, "wall_s": wall,
           "rounds_per_s": args.rounds / wall, "tokens_per_s": tokens / wall,
           "rounds_only_s": rounds_s,
           "rounds_only_tokens_per_s": tokens / rounds_s,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "comm_mb": summary["comm_mb"],
           "mean_inner_first": first, "mean_inner_last": last,
           "rows": rows}
    emit(row)
    return row, phi


def phase_profile_lm(torch, np, tm, phi):
    """Two full-width rounds of the LM step (the launcher's per-round
    work: K inner steps, one interpolation, one read of the losses)
    under torch.profiler, twice. Device activity alone: the device's idle
    share, the top kernels and ssd_scan's share. Host ops too (which slow
    the host, so no idle share is read there): the share of the plain
    backward of ssd_chunked, the device time of the kernels launched
    inside its profiler range."""
    tl, mamba2 = tm["train"], tm["mamba2"]
    from repro_torch.configs import get_arch
    from repro_torch.data import LMClientStream
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.steps import make_meta_train_step, microbatch

    args = tl.parse_args(LM_FULL)
    model = build_model(get_arch(args.arch))
    step = make_meta_train_step(model, beta=args.beta)
    rng = np.random.default_rng(123)
    batches = []
    for cid in range(LM_PROFILE_ROUNDS):
        raw = microbatch(LMClientStream(model.cfg.vocab_size, cid).batch(
            rng, args.batch, args.seq), args.k_inner)
        batches.append({k: torch.from_numpy(v).cuda() for k, v in raw.items()})
    alpha = torch.tensor([0.5], device="cuda")
    bwd_range = mamba2.SSD_BACKWARD_RANGE
    cuda = torch.autograd.DeviceType.CUDA

    def profiled(activities):
        nonlocal phi
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for batch in batches:
                phi, m = step(phi, batch, alpha)
                m["loss"].item()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device rows: kernels and copies (the range's own span on the GPU
        # timeline, where the profiler adds one, is no work of its own)
        by_name = {ev.key: (ev.self_device_time_total, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == cuda and ev.self_device_time_total > 0
                   and ev.key != bwd_range}
        dev_us = sum(t for t, _ in by_name.values())
        check(dev_us > 0, "the profiler saw no device time")
        return prof, wall, by_name, dev_us

    act = torch.profiler.ProfilerActivity
    _, wall, by_name, dev_us = profiled([act.CUDA])
    ssd_by = {k: t for k, (t, _) in by_name.items() if "ssd_scan" in k}
    ssd_us = sum(ssd_by.values())
    check(ssd_us > 0, "the profiler saw no ssd_scan kernel")

    def kernel_us(ev):      # device time of the kernels launched under ev
        return (sum(k.duration for k in ev.kernels if k.name != bwd_range)
                + sum(kernel_us(child) for child in ev.cpu_children))

    prof, traced_wall, _, traced_dev_us = profiled([act.CPU, act.CUDA])
    bwd = [ev for ev in prof.events()
           if ev.name == bwd_range and ev.device_type != cuda]
    bwd_us, bwd_count = sum(kernel_us(ev) for ev in bwd), len(bwd)
    layers_steps = model.cfg.num_layers * LM_PROFILE_ROUNDS * args.k_inner
    check(bwd_count == layers_steps and 0 < bwd_us < traced_dev_us - ssd_us,
          f"the ssd_chunked backward ranges: {bwd_count} seen, "
          f"{bwd_us} us of device time against {traced_dev_us} us busy")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile_lm", "rounds": LM_PROFILE_ROUNDS,
          "wall_ms": 1e3 * wall, "device_busy_ms": dev_us / 1e3,
          "device_idle_share": 1 - dev_us / 1e6 / wall,
          "kernels_launched": sum(c for _, c in by_name.values()),
          "ssd_scan_ms": ssd_us / 1e3,
          "ssd_scan_share_of_busy": ssd_us / dev_us,
          "ssd_scan_ms_by_kernel": {k[:80]: t / 1e3
                                    for k, t in ssd_by.items()},
          "host_traced_wall_ms": 1e3 * traced_wall,
          "host_traced_device_busy_ms": traced_dev_us / 1e3,
          "ssd_backward_ms": bwd_us / 1e3, "ssd_backward_count": bwd_count,
          "ssd_backward_share_of_busy": bwd_us / traced_dev_us,
          "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                         for k, (t, c) in top]})


def fd_inputs(torch, np, shape, dtype, seed, dev):
    """q (B, H, hd) and the two caches (B, S, Kv, hd), standard normal from
    a NumPy seed, in ``dtype`` on ``dev``."""
    B, H, Kv, hd, S = shape
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal(s).astype(np.float32))
                 .to(dev, dtype)
                 for s in ((B, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))


def fd_bytes_ops(shape, L, window, elem):
    """Bytes the call must move (q read, the n attended K and V rows read,
    the output written) and its operations (q.k and p v: 4 B H n hd)."""
    B, H, Kv, hd, S = shape
    n = min(L, window) if window else L
    return 2 * B * n * Kv * hd * elem + 2 * B * H * hd * elem, \
        4 * B * H * n * hd


def phase_kernels_decode(torch, np, ops, ref, rows):
    """flash_decode against its plain version at each case, timed beside
    its bound and one scaled_dot_product_attention call on the same
    inputs (the attended slice of each cache, as views, enable_gqa)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    cases = [(f"test_{'x'.join(map(str, shape))}_{dt}_L{L}_w{w}", shape, dt,
              L, w)
             for shape in FD_TEST_SHAPES for dt in ("float32", "bfloat16")
             for L, w in ((shape[-1] // 2, 0), (shape[-1], 0), (1, 0),
                          (shape[-1] // 2, 128))]
    cases += [(f"path_8x32x4x64x2048_bfloat16_L{L}_w{w}", FD_PATH,
               "bfloat16", L, w)
              for L, w in PATH_CASES]
    cases.append(("32k_4x8x4x64x32768_float32_L32768_w0", FD_32K, "float32",
                  32768, 0))
    inputs = {}
    for i, (tag, shape, dt, L, w) in enumerate(cases):
        if (shape, dt) not in inputs:
            q, k, v = fd_inputs(torch, np, shape, getattr(torch, dt), 60 + i,
                                dev)
            # the decode path reads a different layer's cache at every
            # call (22 x 16.8 MB at this shape), so its rows time calls
            # that cycle over 8 copies, 134 MB, past the 50 MB L2
            n = 8 if shape == FD_PATH else 1
            inputs = {(shape, dt): (q, [(k, v)] + [(k.clone(), v.clone())
                                                   for _ in range(n - 1)])}
        q, kvs = inputs[(shape, dt)]
        k, v = kvs[0]
        got = ops.flash_decode(q, k, v, L, window=w)
        want = ref.flash_decode(q, k, v, L, window=w)
        lo = max(0, L - w) if w else 0
        B, H, Kv, hd, S = shape
        views = itertools.cycle([(q.view(B, H, 1, hd),
                                  kc[:, lo:L].transpose(1, 2),
                                  vc[:, lo:L].transpose(1, 2))
                                 for kc, vc in kvs])
        caches = itertools.cycle(kvs)
        lib = F.scaled_dot_product_attention(*next(views), enable_gqa=True)
        torch.cuda.synchronize()
        tol = FD_TOL[dt]
        check(got.dtype == q.dtype and got.shape == q.shape,
              f"flash_decode {tag}: {got.dtype} {tuple(got.shape)}")
        atol = tol * min(1.0, want.abs().max().item())
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=atol)
        torch.testing.assert_close(lib.reshape(B, H, hd).float(), want,
                                   rtol=tol, atol=tol)
        moved, nops = fd_bytes_ops(shape, L, w, q.element_size())
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = nops / (FP32_OPS_PER_S if dt == "float32"
                        else BF16_OPS_PER_S)
        big = moved > 1e8
        iters = 20 if big else 100
        row = {"shape_BHKvhdS": list(shape), "dtype": dt, "L": L,
               "window": w, "rtol": tol, "atol": atol,
               "max_abs_err": (got.float() - want).abs().max().item(),
               "ms": cuda_ms(torch, lambda: ops.flash_decode(
                   q, *next(caches), L, window=w), iters),
               **device_ms(torch, lambda: ops.flash_decode(
                   q, *next(caches), L, window=w)),
               "plain_ms": cuda_ms(torch, lambda: ref.flash_decode(
                   q, *next(caches), L, window=w), 5 if big else 20),
               "library_ms": cuda_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       *next(views), enable_gqa=True), iters),
               **device_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       *next(views), enable_gqa=True), "library_device_ms"),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": moved, "flop": nops}
        rows[f"flash_decode/{tag}"] = row
        emit({"phase": "kernel", "kernel": "flash_decode", "case": tag,
              **row})
        if shape not in (FD_PATH, FD_32K):
            continue
        # the device-L route, as the decode graph launches it: L an int32
        # on the card, one grid for every L; bit-equal to the host-int call
        length = torch.tensor([L], dtype=torch.int32, device=dev)
        got_d = ops.flash_decode(q, k, v, length, window=w)
        torch.cuda.synchronize()
        check(torch.equal(got_d, got),
              f"flash_decode {tag}: the device-L route differs from the "
              f"host-int call")
        row_d = {**row, "route": "device_L", "bit_equal_to_host_int": True,
                 "ms": cuda_ms(torch, lambda: ops.flash_decode(
                     q, *next(caches), length, window=w), iters),
                 **device_ms(torch, lambda: ops.flash_decode(
                     q, *next(caches), length, window=w))}
        rows[f"flash_decode/{tag}_devL"] = row_d
        emit({"phase": "kernel", "kernel": "flash_decode",
              "case": f"{tag}_devL", **row_d})

    # what a decode wave pays per call: every L in PATH_RUN once per layer,
    # each time linear between the path rows at L <= PATH_RUN[1]; for the
    # host-int route and the device-L route the decode graph launches
    grid = np.arange(PATH_RUN[0], PATH_RUN[1] + 1)
    for suffix in ("", "_devL"):
        path = sorted((r["L"], r) for key, r in rows.items()
                      if key.startswith("flash_decode/path_")
                      and key.endswith(f"_w0{suffix}")
                      and r["L"] <= PATH_RUN[1])
        Ls = [L for L, _ in path]
        row = {"shape_BHKvhdS": list(FD_PATH), "dtype": "bfloat16",
               "route": "device_L" if suffix else "host_int",
               "L_range": list(PATH_RUN), "from_L": Ls,
               **{k: float(np.interp(grid, Ls, [r[k] for _, r in path])
                           .mean())
                  for k in ("ms", "device_ms", "library_ms",
                            "library_device_ms", "bound_ms")}}
        rows[f"flash_decode/path_run_mean{suffix}"] = row
        emit({"phase": "kernel", "kernel": "flash_decode",
              "case": f"path_run_mean{suffix}", **row})
    return rows


def decode_steps(args):
    """Decode steps of one decode run: prompt_len + max_new per wave."""
    return -(-args.requests // args.batch) * (args.prompt_len + args.max_new)


def decode_launches(args):
    """flash_decode launches of one decode run: one per attention layer
    per decode step."""
    from repro_torch.configs import get_arch
    cfg = get_arch(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    return {"flash_decode": decode_steps(args) * cfg.num_layers}


def phase_serve_decode_reduced(torch, np, tm):
    """The reduced decode launcher on the card, then on the CPU, from the
    same seeded init: every step's logits within 1e-4, the same tokens."""
    serve, ops = tm["serve"], tm["ops"]
    args = serve.parse_args(DECODE_REDUCED)
    got, want, built = [], [], []
    (row, out), wall, counts = timed_run(torch, ops, lambda: serve.run_decode(
        args, on_logits=lambda lg: got.append(lg.cpu()),
        on_build=built.append))
    build = decode_build("serve_decode_reduced", built)
    cpu_row, cpu_out = serve.run_decode(
        serve.parse_args(DECODE_REDUCED + ["--device", "cpu"]),
        on_logits=lambda lg: want.append(lg.clone()))
    check_launches("serve_decode_reduced", counts, decode_launches(args))
    check(counts == row["kernel_launches"], "launch counts")
    check(len(got) == len(want) == decode_steps(args),
          f"{len(got)} and {len(want)} steps")
    worst = max((a - b).abs().max().item() for a, b in zip(got, want))
    check(worst <= 1e-4, f"logits differ from the CPU by {worst}")
    check(out == cpu_out, "generated tokens differ from the CPU")
    check(row["sample_output"] == cpu_row["sample_output"], "sample_output")
    for key in ("tokens_generated", "requests", "arch"):
        check(row[key] == cpu_row[key], key)
    res = {"phase": "serve_decode_reduced", "argv": DECODE_REDUCED,
           "wall_s": wall, "launches": counts, "row": row, "build": build,
           "vs_cpu": {"steps": len(got), "tol": 1e-4,
                      "logits_max_abs_diff": worst, "tokens": "equal"}}
    emit(res)
    return res


def decode_build(run, built):
    """The decode run's one build: a step captured once as a CUDA graph
    and replayed for every step of every wave. Printed on its own line
    before the run's; returns it."""
    check(len(built) == 1, f"{run}: {len(built)} decode runners")
    (runner,) = built
    check(runner.trace_count == 1 and runner.step.graph is not None,
          f"{run}: the decode step was built {runner.trace_count} times "
          f"or not captured")
    build = {"trace_count": runner.trace_count,
             "capture_s": runner.capture_s, "graph_nodes": runner.nodes}
    emit({"phase": "decode_build", "run": run, **build})
    return build


def teacher_forced(torch, model, params, tokens, dev):
    """Logits (fp32, on the CPU) of decoding ``tokens`` (B, T) one at a
    time from an empty cache of T."""
    B, T = tokens.shape
    cache = model.init_cache(B, T, device=dev)
    out = []
    with torch.no_grad():
        for t in range(T):
            logits, cache = model.decode_fn(params, {
                "tokens": torch.from_numpy(tokens[:, t:t + 1]).to(dev),
                "cache": cache, "cache_len": t})
            out.append(logits[:, 0].float().cpu())
    return torch.stack(out, dim=1)


def phase_serve_decode_full(torch, np, tm):
    """tinyllama-1.1b at full width and depth, bf16, through the decode
    launcher; then its weights in fp32 on the card against the CPU, and
    the bf16 model's greedy choices against the fp32 logits."""
    import dataclasses

    from repro_torch.models.transformer import build_model

    serve, ops, bridge = tm["serve"], tm["ops"], tm["bridge"]
    args = serve.parse_args(DECODE_FULL)
    cfg = tm["get_arch"](args.arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(args.seed), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in bridge.tree_leaves(params))
    check(n_params == TINYLLAMA_PARAMS, f"{n_params} parameters")
    finite, built, marks = [], [], []
    torch.cuda.reset_peak_memory_stats()
    (row, out), wall, counts = timed_run(torch, ops, lambda: serve.run_decode(
        args, params=params,
        on_logits=lambda lg: finite.append(torch.isfinite(lg).all()),
        on_build=lambda r: (built.append(r),
                            marks.append(time.perf_counter()))))
    # the launcher's clocked part: from the built step to the last sync
    decode_s = time.perf_counter() - marks[0]
    peak = torch.cuda.max_memory_allocated()
    build = decode_build("serve_decode_tinyllama_1_1b", built)
    del built
    check_launches("serve_decode_tinyllama_1_1b", counts,
                   decode_launches(args))
    steps = decode_steps(args)
    check(len(finite) == steps and bool(torch.stack(finite).all()),
          "a logit is not finite")
    check(len(out) == args.requests
          and all(len(o) == args.max_new for o in out), "outputs")

    # the same weights in fp32: the card against the CPU, teacher-forced
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = build_model(cfg32)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (CHECK_BATCH, CHECK_STEPS))
    p32 = bridge.unflatten_tree({path: t.float() for path, t in
                                 bridge.tree_leaves(params)})
    card = teacher_forced(torch, m32, p32, tokens, "cuda")
    p32 = bridge.unflatten_tree({path: t.cpu() for path, t in
                                 bridge.tree_leaves(p32)})
    t1 = time.perf_counter()
    cpu = teacher_forced(torch, m32, p32, tokens, "cpu")
    cpu_s = time.perf_counter() - t1
    del p32
    scale = cpu.abs().max().item()
    diff = (card - cpu).abs().max().item()
    check(diff <= CHECK_TOL * scale,
          f"fp32 card vs CPU: {diff} > {CHECK_TOL} x {scale}")
    # the bf16 model on the same tokens: each greedy choice's fp32 logit
    bf16 = teacher_forced(torch, model, params, tokens, "cuda")
    chosen = bf16.argmax(dim=-1, keepdim=True)
    gap = (cpu.max(dim=-1, keepdim=True).values
           - cpu.gather(-1, chosen)).max().item()
    check(gap <= BF16_CHOICE_TOL * scale,
          f"a bf16 choice is {gap} below the fp32 max ({scale} largest)")
    agree = (chosen[..., 0] == cpu.argmax(dim=-1)).float().mean().item()
    res = {"phase": "serve_decode_tinyllama_1_1b", "argv": DECODE_FULL,
           "params": n_params, "init_s": init_s, "wall_s": wall,
           "tok_per_s": row["tokens_generated"] / wall,
           "processed_tok_per_s": steps * args.batch / wall,
           "decode_steps": steps, "step_ms": 1e3 * wall / steps,
           "after_build": {"wall_s": decode_s,
                           "tok_per_s": row["tokens_generated"] / decode_s,
                           "step_ms": 1e3 * decode_s / steps},
           "max_memory_allocated_gb": peak / 1e9, "launches": counts,
           "row": row, "build": build,
           "fp32_vs_cpu": {"steps": CHECK_STEPS, "batch": CHECK_BATCH,
                           "tol_of_max": CHECK_TOL, "max_abs_logit": scale,
                           "logits_max_abs_diff": diff, "cpu_s": cpu_s},
           "bf16_choices": {"tol_of_max": BF16_CHOICE_TOL,
                            "worst_gap_to_fp32_max": gap,
                            "same_as_fp32_argmax": agree,
                            "bf16_vs_fp32_max_abs_diff": (bf16 - cpu).abs()
                            .max().item()}}
    emit(res)
    return res, model, params


def phase_profile_decode(torch, np, model, params):
    """DECODE_PROFILE_STEPS full-width decode steps at batch 8 from
    position DECODE_PROFILE_AT under torch.profiler, device activity
    only, each a replay of the decode runner's one captured step: the
    idle share, kernels per step, the top kernels and flash_decode's
    share of busy time; beside them the wrapper's launches and the
    flash_decode kernels the tracer recorded: one a launch, as a call is
    one kernel launch whether or not the KV axis is split, or fewer, since
    the tracer may lose device events (never more)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import DecodeRunner
    cfg = model.cfg
    B = 8
    runner = DecodeRunner(model, params, batch=B,
                          prompt_len=DECODE_PROFILE_AT
                          + DECODE_PROFILE_STEPS + 1,
                          cache_len=2048, max_new=0, device="cuda")
    runner.prompts.copy_(torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, tuple(runner.prompts.shape))))
    runner.build()
    runner.cursor.fill_(DECODE_PROFILE_AT)
    runner.step()                               # a replay before the window
    torch.cuda.synchronize()
    before = ops.launch_counts()["flash_decode"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_PROFILE_STEPS):
            runner.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()["flash_decode"] - before
    check(launches == DECODE_PROFILE_STEPS * cfg.num_layers,
          f"{launches} flash_decode launches in {DECODE_PROFILE_STEPS} "
          f"replayed steps")
    check(runner.trace_count == 1, "the profiled step was built again")
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {ev.key: (ev.self_device_time_total, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == cuda and ev.self_device_time_total > 0}
    dev_us = sum(t for t, _ in by_name.values())
    check(dev_us > 0, "the profiler saw no device time")
    fd_us = sum(t for k, (t, _) in by_name.items() if "flash_decode" in k)
    check(fd_us > 0, "the profiler saw no flash_decode kernel")
    fd_traced = sum(c for k, (_, c) in by_name.items() if "flash_decode" in k)
    check(fd_traced <= launches,
          f"{fd_traced} flash_decode kernels traced for {launches} launches: "
          f"a call must be one kernel launch")
    n_kernels = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile_decode", "steps": DECODE_PROFILE_STEPS,
          "batch": B, "from_position": DECODE_PROFILE_AT, "replayed": True,
          "graph_nodes": runner.nodes,
          "wall_ms": 1e3 * wall, "step_ms": 1e3 * wall / DECODE_PROFILE_STEPS,
          "device_busy_ms": dev_us / 1e3,
          "device_idle_share": 1 - dev_us / 1e6 / wall,
          "kernels_per_step": n_kernels / DECODE_PROFILE_STEPS,
          "flash_decode_ms": fd_us / 1e3,
          "flash_decode_share_of_busy": fd_us / dev_us,
          "flash_decode_launches": launches,
          "flash_decode_kernels_traced": fd_traced,
          "top_device": [[k[:80], t / 1e3, c, t / dev_us]
                         for k, (t, c) in top]})


def graphs_vs_eager_decode(torch, np, graphs, model, params):
    """A DECODE_GRAPH wave of tinyllama-1.1b through the decode runner,
    its step captured and replayed, against the same step run eagerly on
    the card: every step's logits and the tokens bit for bit, launch
    counts equal. Returns the graphs_vs_eager row."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import DecodeRunner
    prompts = torch.from_numpy(np.random.default_rng(11).integers(
        0, model.cfg.vocab_size,
        (DECODE_GRAPH["batch"], DECODE_GRAPH["prompt_len"])))

    def wave():
        runner = DecodeRunner(model, params, device="cuda", **DECODE_GRAPH)
        runner.build()
        logits = []
        (tokens, wall, counts) = timed_run(
            torch, ops, lambda: runner.wave(prompts, on_logits=logits.append))
        return runner, logits, tokens, wall, counts

    runner, got, got_tokens, wall, counts = wave()
    info = {"trace_count": runner.trace_count, "capture_s": runner.capture_s,
            "graph_nodes": runner.nodes}
    check(runner.trace_count == 1 and runner.step.graph is not None,
          "graphs decode: the step was not built once")
    del runner
    with uncaptured(graphs):
        _, want, want_tokens, eager_wall, eager = wave()
    steps = DECODE_GRAPH["prompt_len"] + DECODE_GRAPH["max_new"]
    check(counts == eager and counts["flash_decode"] == steps
          * model.cfg.num_layers,
          f"graphs decode: launches {counts} vs {eager}")
    check(got_tokens == want_tokens,
          "graphs decode: the replayed wave's tokens differ from eager")
    check(len(got) == len(want) == steps
          and all(torch.equal(a, b) for a, b in zip(got, want)),
          "graphs decode: the replayed wave's logits differ from eager")
    return {**info, **DECODE_GRAPH, "launches": counts, "bit_equal": True,
            "wall_s": wall, "eager_wall_s": eager_wall}


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

    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.core.strategies import tifed_requantize
    from repro_torch.kernels import build, ops, ref
    from repro_torch.metering import MetricsTracker
    from repro_torch.models.paper_nets import (init_paper_model,
                                               paper_model_loss)
    from repro_torch.serving import (AdaptationServer, Fp32Adapter,
                                     TifedAdapter)

    t_start = time.perf_counter()
    phase_device(torch, np)
    phase_build(build)
    rows = phase_kernels(torch, np, ops, ref)
    phase_kernels_lm(torch, np, ops, ref, rows)
    phase_kernels_decode(torch, np, ops, ref, rows)

    # the decode slice first: its paths are the newest
    from repro_torch import bridge, graphs
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_launcher

    dm = {"ops": ops, "bridge": bridge, "serve": serve_launcher,
          "get_arch": get_arch}
    s_dec_red = phase_serve_decode_reduced(torch, np, dm)
    s_dec, dec_model, dec_params = phase_serve_decode_full(torch, np, dm)
    phase_profile_decode(torch, np, dec_model, dec_params)
    g_dec = graphs_vs_eager_decode(torch, np, graphs, dec_model, dec_params)
    del dec_params

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

    from repro_torch import core
    from repro_torch.configs.paper_models import PAPER_MODELS
    from repro_torch.core import engine
    from repro_torch.data import KWSTasks, OmniglotTasks, SineTasks
    from repro_torch.examples import federated_keyword_spotting as kws
    from repro_torch.launch import train
    from repro_torch.models import mamba2, paper_nets

    tm = {"core": core, "ops": ops, "train": train, "SineTasks": SineTasks,
          "loss": functools.partial(paper_model_loss, SINE_MLP), "phi": phi,
          "bridge": bridge, "mamba2": mamba2, "engine": engine,
          "graphs": graphs, "nets": paper_nets, "cfgs": PAPER_MODELS,
          "kws": kws, "MetricsTracker": MetricsTracker,
          "dists": {"kws_conv": KWSTasks(), "omniglot_conv": OmniglotTasks()},
          "loss_of": lambda cfg: functools.partial(
              paper_nets.paper_model_loss, cfg),
          "acc_of": lambda cfg: functools.partial(
              paper_nets.paper_model_accuracy, cfg)}
    t_tiny = phase_train_tinyreptile(torch, np, tm)
    t_rep = phase_train_reptile(torch, np, tm)
    t_base = phase_train_baselines(torch, np, tm)
    phase_profile_train(torch, tm)
    fleet_paths = {**phase_fleet_tifed(torch, np, tm),
                   **phase_fleet_partial(torch, np, tm),
                   **phase_fleet_pool(torch, np, tm),
                   **phase_fleet_kws(torch, np, tm)}
    ckpt_paths, ckpt_ref = phase_ckpt_resume(torch, np, tm)
    ckpt_paths.update(phase_ckpt_sigkill(torch, np, tm, ckpt_ref))
    phase_ckpt_overhead(torch, np, tm)
    phase_paper_models(torch, np, tm)
    fig4_paths = phase_fig4_conv(torch, np, tm)
    phase_graphs(torch, np, tm, {
        "server": AdaptationServer,
        "routes": {"serve_fp32": (fp32, phi, reqs, K_MAX),
                   "serve_tifed": (tifed, phi_q, t_reqs, T_K_MAX)}},
                 {"decode_tinyllama_1_1b": g_dec}, conv_graph_runs(torch, tm))
    t_lm_red = phase_train_lm_reduced(torch, np, tm)
    t_lm, lm_phi = phase_train_lm_full(torch, np, tm)
    phase_profile_lm(torch, np, tm, lm_phi)
    del lm_phi


    # every main path's launches, each counted from 0 just before it
    paths = {"serve_fp32": s_fp32["launches"],
             "serve_tifed": s_tifed["launches"],
             "train_tinyreptile": t_tiny["launches"],
             "train_reptile_c64": t_rep["launches"],
             **{f"train_{r['run']}": r["launches"] for r in t_base},
             "train_lm_reduced": t_lm_red["launches"],
             "train_lm_mamba2_130m": t_lm["launches"],
             "serve_decode_reduced": s_dec_red["launches"],
             "serve_decode_tinyllama_1_1b": s_dec["launches"],
             **fig4_paths, **fleet_paths, **ckpt_paths}
    kernels = []
    for kernel, route, source, replaces, row in (
            ("online_sgd", "cuda", "src/repro_torch/kernels/csrc/online_sgd.cu",
             "src/repro/kernels/online_sgd.py:36",
             rows["online_sgd/serve_64x1153_fp32"]),
            ("dfa_epoch_int8", "cuda",
             "src/repro_torch/kernels/csrc/dfa_epoch_int8.cu",
             "src/repro/kernels/online_sgd_int8.py:120",
             rows["dfa_epoch_int8/serve_B64_S8_mixed"]),
            ("meta_update", "cuda",
             "src/repro_torch/kernels/csrc/meta_update.cu",
             "src/repro/kernels/meta_update.py:31",
             rows["meta_update/train_1153_fp32"]),
            ("online_sgd_momentum", "cuda",
             "src/repro_torch/kernels/csrc/online_sgd.cu",
             "src/repro/kernels/online_sgd.py:52",
             rows["online_sgd_momentum/train_1153_fp32"]),
            ("ssd_scan", "cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:61",
             rows["ssd_scan/path_2x24x8x256x64x128"]),
            ("flash_decode", "cuda",
             "src/repro_torch/kernels/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode.py:68",
             # the route the decode graph launches: L read on the device
             rows["flash_decode/path_8x32x4x64x2048_bfloat16_L2048_w0_devL"]
             )):
        by_path = {p: c[kernel] for p, c in paths.items() if c[kernel]}
        kernels.append(
            {"name": kernel, "route": route, "source": source,
             "replaces": replaces, "launches": sum(by_path.values()),
             "launches_by_path": by_path,
             **{k: row[k] for k in ("max_abs_err", "ms", "device_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
             "library_device_ms": row.get("library_device_ms"),
             **({"route_on_path": row["route"]} if "route" in row else {}),
             **({"kernels_per_call": row["kernels_per_call"]}
                if "kernels_per_call" in row else {}),
             **({"engine_shape": {
                 k: rows[f"dfa_epoch_int8/{ENGINE_DFA}"][k] for k in (
                     "B", "S", "dims", "ms", "device_ms", "generic_ms",
                     "generic_device_ms", "plain_ms", "bound_ms", "bound_by",
                     "max_abs_err", "loss_max_rel_err")}}
                if kernel == "dfa_epoch_int8" else {})})
    emit({"total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
