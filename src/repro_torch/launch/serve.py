"""Serving launchers of the port.

Two modes, picked by ``--mode``, with the JAX launcher's parse-time
check (flags of the other mode are rejected before any tensor work):

- ``decode`` (the default): batched autoregressive decoding of an LM:
  a dense, MoE or VLM one with a KV cache per layer, a Mamba2 one with
  its conv window and state, the hybrid with both, or the
  encoder-decoder whisper-tiny with a KV cache and a cross cache of
  ``encoder_tokens`` rows per decoder layer (zeros, as the JAX launcher
  leaves it: no encoder run fills it).
  Waves of ``--batch`` prompts fill the slots (the last wave padded with
  zero prompts), each prompt is fed through teacher-forced decode steps,
  then ``--max-new`` tokens are decoded greedily. Every attention
  application runs through the ``flash_decode`` kernel; the Mamba2 step
  and the experts are plain tensor ops, as in the JAX package. Under
  ``REPRO_OPT_RINGKV=1`` (``runtime/flags.py``, as for the JAX launcher)
  a sliding-window layer's cache is a ring of ``window`` rows;
  ``--cache-len`` stays the logical length. One JSON row with tokens/s:

      PYTHONPATH=src python -m repro_torch.launch.serve --mode decode \
          --arch tinyllama-1.1b --reduced --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve --mode decode \
          --arch mamba2-130m --reduced --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve --mode decode \
          --arch mixtral-8x22b --reduced --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve --mode decode \
          --arch whisper-tiny --reduced --device cpu

- ``adapt``: a continuous-batching ``serving.AdaptationServer`` over
  the sine-MLP meta-init sustains a ragged stream of client-adaptation
  requests (fp32 online SGD or int8 TIFeD epochs) and prints one JSON
  row with requests/sec and latency percentiles:

      PYTHONPATH=src python -m repro_torch.launch.serve --mode adapt \
          --strategy fp32 --requests 512 --slots 64 --k-max 10

Both run on the GPU; ``--device cpu`` runs the plain PyTorch path on the
CPU instead. The weights (the LM, or phi) are a fresh init from
``--seed`` drawn with torch's generator, which does not reproduce
``jax.random``'s init at the same seed (``run_decode(params=)`` takes
others; ``--ckpt-dir`` serves the phi of a round-state checkpoint that
``run_federated(ckpt_dir=...)`` of either package wrote, or of a bare
``save_checkpoint`` snapshot). Decode runs every registered LM.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import ALL_ARCHS, get_arch, list_archs

# flags that only make sense for one mode: (flag, argparse dest, default)
_DECODE_ONLY = (("--arch", "arch", None), ("--reduced", "reduced", False),
                ("--batch", "batch", 2), ("--prompt-len", "prompt_len", 8),
                ("--max-new", "max_new", 8), ("--cache-len", "cache_len", 64))
_ADAPT_ONLY = (("--strategy", "strategy", "fp32"), ("--slots", "slots", 64),
               ("--support", "support", 10), ("--k-max", "k_max", 10),
               ("--query", "query", 20),
               ("--steps-per-tick", "steps_per_tick", 5),
               ("--ckpt-dir", "ckpt_dir", None))


def decode_archs():
    """The architectures decode mode runs: every registered LM."""
    return tuple(a for a in list_archs() if a in ALL_ARCHS)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve an LM by batched greedy decoding (--mode decode) "
                    "or client-adaptation requests over the sine-MLP "
                    "meta-init (--mode adapt).")
    ap.add_argument("--mode", choices=("decode", "adapt"), default="decode")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the requests (NumPy, drawn as the JAX "
                         "launcher draws them) and of the fresh weights "
                         "(torch's generator: not the JAX package's init at "
                         "the same seed; --ckpt-dir serves a checkpoint's "
                         "phi instead)")
    # decode-mode flags
    ap.add_argument("--arch", default=None,
                    help="LM to decode with (one of "
                         f"{', '.join(decode_archs())})")
    ap.add_argument("--reduced", action="store_true",
                    help="the family's smoke config (2 layers, d_model "
                         "256, fp32)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=64)
    # adapt-mode flags
    ap.add_argument("--strategy", choices=("fp32", "tifed"), default="fp32")
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--support", type=int, default=10)
    ap.add_argument("--k-max", type=int, default=10)
    ap.add_argument("--query", type=int, default=20)
    ap.add_argument("--steps-per-tick", type=int, default=5)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and cross-validate before any tensor work: a decode flag on
    an adapt run (or the reverse) is a config mistake, not a silent
    default."""
    ap = build_parser()
    args = ap.parse_args(argv)
    wrong = _ADAPT_ONLY if args.mode == "decode" else _DECODE_ONLY
    for flag, dest, default in wrong:
        if getattr(args, dest) != default:
            ap.error(f"{flag} only applies with --mode "
                     f"{'adapt' if args.mode == 'decode' else 'decode'}")
    if args.requests < 1:
        ap.error(f"--requests must be >= 1, got {args.requests}")
    if args.mode == "decode":
        if args.arch is None:
            ap.error("--arch is required for --mode decode")
        if args.arch not in ALL_ARCHS:
            ap.error(f"--arch {args.arch!r} not in {sorted(ALL_ARCHS)}")
        for flag, v, least in (("--batch", args.batch, 1),
                               ("--prompt-len", args.prompt_len, 1),
                               ("--max-new", args.max_new, 0)):
            if v < least:
                ap.error(f"{flag} must be >= {least}, got {v}")
        if args.cache_len < args.prompt_len + args.max_new:
            ap.error(f"--cache-len {args.cache_len} cannot hold --prompt-len "
                     f"{args.prompt_len} + --max-new {args.max_new} tokens")
        return args
    if args.slots < 1:
        ap.error(f"--slots must be >= 1, got {args.slots}")
    if args.k_max < 1:
        ap.error(f"--k-max must be >= 1, got {args.k_max}")
    if args.steps_per_tick < 1:
        ap.error(f"--steps-per-tick must be >= 1, got "
                 f"{args.steps_per_tick}")
    if args.strategy == "fp32" and args.k_max > args.support:
        ap.error(f"--k-max {args.k_max} online steps need --support "
                 f">= k-max, got {args.support}")
    if args.strategy == "tifed" and args.support & (args.support - 1):
        ap.error(f"--support must be a power of two for tifed "
                 f"(bit-shift batch mean), got {args.support}")
    return args


def _device_name(dev):
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def decode_requests(runner, prompts, *, on_logits=None):
    """Greedy decoding of ``prompts`` (int arrays of one length) in waves
    of the runner's batch slots, as the JAX launcher's loop runs them: the
    last wave is padded with zero prompts, the prompt goes through
    teacher-forced decode steps, then ``max_new`` tokens are chosen by
    argmax, all slots in lockstep. Each wave is one copy of its prompts
    to the device, the runner's P + ``max_new`` steps (replays of its
    one build) and one read of the chosen tokens. ``on_logits(logits)``
    sees a copy of the (batch, 1, V) fp32 logits of every step. Returns
    (the generated tokens of each request, tokens generated counting the
    pad slots, as the JAX launcher counts them)."""
    import torch

    batch, prompt_len = runner.prompts.shape
    queue, outputs, tokens_out = list(prompts), [], 0
    while queue:
        wave, queue = queue[:batch], queue[batch:]
        n_real = len(wave)
        wave += [np.zeros(prompt_len, np.int64)] * (batch - n_real)
        gen = runner.wave(torch.from_numpy(np.stack(wave).astype(np.int64)),
                          on_logits=on_logits)
        outputs.extend(gen[:n_real])
        tokens_out += batch * runner.max_new
    return outputs, tokens_out


def run_decode(args, params=None, on_logits=None, on_build=None,
               model=None):
    """The decode mode's run: prints one JSON row with the JAX launcher's
    keys (``tokens_generated`` counts the pad slots, as there), then the
    device and the kernel launches, and returns (row, the generated
    tokens of each request). ``params`` (the port's tree on the device;
    ``bridge.lm_params_from_jax`` carries the JAX package's init over)
    replaces the seeded torch init, and ``model`` the one ``--arch``
    builds (a config of the same family cut to fewer layers, which a
    full-width run on one card needs for the largest models). The decode
    step is built once before the clock and the launch counters start
    (``runtime/steps.py::DecodeRunner``: on the card its first step
    runs, then it is captured as a CUDA graph, replayed at every later
    step); ``on_build(runner)`` sees the built runner (``trace_count``,
    ``capture_s``, ``nodes``)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime.steps import DecodeRunner

    dev = resolve_device(args.device)
    if model is None:
        cfg = get_arch(args.arch)
        model = build_model(cfg.reduced() if args.reduced else cfg)
    cfg = model.cfg
    if params is None:
        params = model.init(torch.Generator().manual_seed(args.seed), dev)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
               for _ in range(args.requests)]

    runner = DecodeRunner(model, params, batch=args.batch,
                          prompt_len=args.prompt_len,
                          cache_len=args.cache_len, max_new=args.max_new,
                          device=dev)
    runner.build()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if on_build is not None:
        on_build(runner)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outputs, tokens_out = decode_requests(runner, prompts,
                                          on_logits=on_logits)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    row = {"arch": cfg.name, "requests": args.requests,
           "tokens_generated": tokens_out, "wall_s": round(dt, 2),
           "tok_per_s": round(tokens_out / dt, 1),
           "sample_output": outputs[0][:8], "device": _device_name(dev),
           "kernel_launches": ops.launch_counts()}
    print(json.dumps(row, indent=1))
    return row, outputs


def run_adapt(args):
    import functools

    import torch

    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.core.strategies import tifed_requantize
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.metering import MetricsTracker
    from repro_torch.models.paper_nets import (init_paper_model,
                                               paper_model_loss)
    from repro_torch.serving import (AdaptationServer, Fp32Adapter,
                                     TifedAdapter)

    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    phi = init_paper_model(SINE_MLP, gen, dev)
    if args.strategy == "tifed":
        phi = tifed_requantize(phi)
        adapter = TifedAdapter(support=args.support, k_max=args.k_max)
    else:
        adapter = Fp32Adapter(
            loss_fn=functools.partial(paper_model_loss, SINE_MLP))
    if args.ckpt_dir is not None:
        from repro_torch.checkpoint import load_params
        phi = params_from_numpy(
            load_params(args.ckpt_dir, params_to_numpy(phi)), dev)

    tracker = MetricsTracker()
    server = AdaptationServer(phi, adapter, slots=args.slots,
                              k_max=args.k_max,
                              steps_per_tick=args.steps_per_tick,
                              metrics=tracker, device=dev)
    rng = np.random.default_rng(args.seed)
    a = rng.uniform(0.1, 5.0, args.requests)
    b = rng.uniform(0.0, np.pi, args.requests)

    def submit(i):
        sx = rng.uniform(-5, 5, (args.support, 1)).astype(np.float32)
        qx = rng.uniform(-5, 5, (args.query, 1)).astype(np.float32)
        k = int(rng.integers(1, args.k_max + 1))
        server.submit(sx, np.float32(a[i] * np.sin(sx + b[i])),
                      qx, np.float32(a[i] * np.sin(qx + b[i])), k)

    submit(0)
    server.drain()                    # warm-up: builds the kernels
    server.reset()
    tracker = MetricsTracker()
    server.metrics = tracker
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(args.requests):
        submit(i)
    results = server.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    row = {
        "mode": "adapt", "strategy": args.strategy,
        "device": _device_name(dev),
        "requests": len(results), "slots": args.slots,
        "k_max": args.k_max, "steps_per_tick": args.steps_per_tick,
        "wall_s": round(dt, 3),
        "req_per_s": round(len(results) / dt, 1),
        "ticks": server.ticks, "trace_count": server.trace_count,
        "kernel_launches": ops.launch_counts(),
        "latency_ms": {k: round(v, 3) for k, v in
                       tracker.percentiles("serve.latency_ms").items()},
        "mean_query_loss": round(
            float(np.mean([r.query_loss for r in results])), 5)}
    print(json.dumps(row, indent=1))
    return row


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "decode":
        run_decode(args)
    else:
        run_adapt(args)


if __name__ == "__main__":
    main()
