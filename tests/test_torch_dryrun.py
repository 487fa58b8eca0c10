"""The dry run and the sweep, ``launch/dryrun.py`` and ``launch/sweep.py``
of the port, against the JAX package's and against real runs.

The dry run traces a cell's step as rank 0 of a fake process group on
``meta`` tensors (the kernels' shape-only route, ``kernels/costs.py``).
Each trace runs in a subprocess, since a process group is global:

- the reduced tinyllama-1.1b, mixtral-8x22b and zamba2-1.2b cells of
  ``tests/test_torch_production_step.py`` (meta: K = 2 microbatches of 4
  x 24 tokens) and ``tests/test_torch_production_serve.py`` (joint and
  prefill on 4 x 24 tokens, decode of batch 4 over a cache of 32), fp32,
  4 layers, ``FSDP_THRESHOLD_BYTES`` at 100,000, traced on a fake (2, 2)
  ``("data", "model")`` group, against the same steps run for real by
  four gloo ranks on the CPU (``runtime/ranks.py``): every collective's
  count and bytes by the port's counters, every kernel's record and the
  FLOPs exactly equal, on every rank;
- ``probe_costs`` against a full-depth trace in probe mode, exactly;
- a dense cell's FLOPs against an analytic count;
- one 16 x 16 cell (tinyllama-1.1b decode_32k, through a one-cell sweep)
  OK, with its parameter and cache bytes a rank equal to
  ``launch/describe.py``'s and ``launch/specs.py::cache_chip_bytes``;
  a SKIP cell with the JAX package's reason; a second sweep reporting
  both cached.

Also: ``parse_collective_bytes``, ``model_flops_per_chip`` and the skip
matrix against the JAX package's, and every kernel wrapper's shape-only
route on fake and ``meta`` tensors.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

from repro_torch.launch import dryrun as D  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 100_000
ARCHS = ("tinyllama-1.1b", "mixtral-8x22b", "zamba2-1.2b")
STEPS = ("meta", "joint", "prefill", "decode")
K, MB, S = 2, 4, 24                # test_torch_production_step's SHAPE
SERVE_B, SEQ = 4, 32               # test_torch_production_serve's
MESH = ((2, 2), ("data", "model"))
PROBE_CASES = (("tinyllama-1.1b", "meta"), ("tinyllama-1.1b", "decode"),
               ("mixtral-8x22b", "meta"))


def _cfg(arch):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).reduced(), num_layers=4,
                               dtype="float32")


def _cell(step):
    """(InputShape, k_inner, the step's kind for ``build_step_and_args``)
    of a reduced cell."""
    from repro_torch.configs import InputShape
    return {"meta": (InputShape("meta", S, K * MB, "train"), K, "meta"),
            "joint": (InputShape("joint", S, SERVE_B, "train"), 1, "joint"),
            "prefill": (InputShape("prefill", S, SERVE_B, "prefill"), None,
                        "meta"),
            "decode": (InputShape("decode", SEQ, SERVE_B, "decode"), None,
                       "meta")}[step]


def _counts(t):
    return {"flops": t["flops"], "kernels": t["kernels"],
            "calls": t["calls"]}


def _fill(args):
    """Seeded values for ``build_step_and_args``'s empty CPU tensors:
    floats small normals, integers (tokens, labels, the cursor) 0."""
    gen = torch.Generator().manual_seed(0)
    from torch.utils._pytree import tree_flatten
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            if t.is_floating_point():
                t.copy_(0.02 * torch.randn(t.shape, generator=gen))
            else:
                t.zero_()


def _real_rank(rank):
    """One rank of four gloo ranks: each step of each arch's cells run on
    seeded inputs under a ``CostMode``; its counts."""
    from repro_torch.kernels.costs import CostMode
    from repro_torch.runtime import sharding as sh
    sh.FSDP_THRESHOLD_BYTES = THRESHOLD
    mesh = sh.make_mesh(*MESH, "cpu")
    out = {}
    for arch in ARCHS:
        for step in STEPS:
            shape, k, kind = _cell(step)
            fn, args, _ = D.build_step_and_args(_cfg(arch), shape, mesh,
                                                kind, k_inner=k,
                                                device="cpu")
            _fill(args)
            before = D.collective_counters()
            with CostMode() as cm:
                fn(*args)
            out[(arch, step)] = {"flops": cm.flops, "kernels": cm.kernels,
                                 "calls": D.collectives_since(before)}
    return out


def fake_side(out_path):
    """The reduced cells traced on a fake (2, 2) group, and the probes
    against full-depth probe-mode traces."""
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.flags import probe_scope
    sh.FSDP_THRESHOLD_BYTES = THRESHOLD
    res = {"traces": {}, "probes": {}}
    with D.fake_group(4):
        mesh = sh.make_mesh(*MESH, "cpu")
        for arch in ARCHS:
            for step in STEPS:
                shape, k, kind = _cell(step)
                res["traces"][(arch, step)] = _counts(
                    D.trace(_cfg(arch), shape, mesh, kind, k))
        for arch, step in PROBE_CASES:
            shape, _, kind = _cell(step)
            cfg = _cfg(arch)
            extrapolated, meta = D.probe_costs(cfg, shape, mesh, kind)
            with probe_scope(True):
                full = D._cost_row(D.trace(cfg, shape, mesh, kind))
            res["probes"][(arch, step)] = (extrapolated, full, meta)
        # a dense cell's FLOPs: tinyllama's prefill
        t = D.trace(_cfg("tinyllama-1.1b"), _cell("prefill")[0], mesh,
                    "meta")
        res["dense_prefill"] = {"flops": t["flops"],
                                "kernels": t["kernels"]}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _sweep(outdir, *cells):
    """``python -m repro_torch.launch.sweep`` on one 16 x 16 arch's
    shapes; its printed lines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--outdir",
         outdir, "--meshes", "single", *cells], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.runtime.ranks import run_ranks

    root = tmp_path_factory.mktemp("dryrun")
    fake_out = str(root / "fake.pkl")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")]))
    fake = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_dryrun as t; "
         f"t.fake_side({fake_out!r})"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    sweep_dir = str(root / "sweep")
    sweeps = {}

    def sweep_twice():
        try:
            cells = ("--archs", "tinyllama-1.1b", "--shapes",
                     "decode_32k,long_500k")
            sweeps["first"] = _sweep(sweep_dir, *cells)
            sweeps["again"] = _sweep(sweep_dir, *cells)
        except BaseException as e:                # raised below
            sweeps["error"] = e

    sweeping = threading.Thread(target=sweep_twice)
    try:
        sweeping.start()
        real = run_ranks(_real_rank, 4, str(root / "ranks"), device="cpu",
                         timeout=600)
        sweeping.join()
        _, err = fake.communicate(timeout=600)
        assert fake.returncode == 0, err[-3000:]
    finally:
        fake.kill()
    if "error" in sweeps:
        raise sweeps["error"]
    with open(fake_out, "rb") as f:
        traced = pickle.load(f)
    cells = {}
    for name in os.listdir(sweep_dir):
        with open(os.path.join(sweep_dir, name)) as f:
            cells[name] = json.load(f)
    return {"real": real, "fake": traced, "sweeps": sweeps, "cells": cells}


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_trace_counts_what_four_real_ranks_count(runs, arch, step):
    """The fake (2, 2) trace's collectives (count and bytes by group),
    kernel records (calls, FLOPs, bytes) and FLOPs equal every real
    rank's exactly."""
    want = runs["fake"]["traces"][(arch, step)]
    assert want["flops"] > 0 and want["calls"]["all_reduce"]["all_reduce"]
    for rank, got in enumerate(runs["real"]):
        assert got[(arch, step)] == want, (arch, step, rank)


def test_the_traces_reach_the_kernels(runs):
    traces = runs["fake"]["traces"]
    assert traces[("tinyllama-1.1b", "meta")]["kernels"]["online_sgd"][
        "calls"] == K
    assert traces[("tinyllama-1.1b", "meta")]["kernels"]["meta_update"][
        "calls"] == 1
    assert traces[("tinyllama-1.1b", "decode")]["kernels"]["flash_decode"][
        "calls"] == 4
    assert traces[("zamba2-1.2b", "prefill")]["kernels"]["ssd_scan"][
        "calls"] > 0
    assert traces[("tinyllama-1.1b", "decode")]["calls"]["merge"]["sum"] == 4


@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_costs_equal_the_full_depth_count(runs, case):
    extrapolated, full, meta = runs["fake"]["probes"][case]
    assert len(meta["probes"]) == (4 if case[1] == "meta" else 2)
    assert extrapolated == full


def test_a_dense_cells_flops_match_an_analytic_count(runs):
    """tinyllama's prefill on a (2, 2) rank: its rows of the batch, its
    heads, its part of d_ff and of the vocab; the blockwise attention
    over every (query, key) pair of its one block; the logits of the last
    token."""
    cfg = _cfg("tinyllama-1.1b")
    B, H, Kv = SERVE_B // 2, cfg.num_heads // 2, cfg.num_kv_heads // 2
    hd, d, f, V = cfg.resolved_head_dim, cfg.d_model, cfg.d_ff // 2, \
        cfg.vocab_size // 2
    T = B * S
    layer = (2 * T * d * (H + 2 * Kv) * hd          # q, k, v
             + 2 * 2 * B * H * S * S * hd           # q k^T, p v
             + 2 * T * H * hd * d                   # wo
             + 3 * 2 * T * d * f)                   # SwiGLU
    want = cfg.num_layers * layer + 2 * B * d * V
    got = runs["fake"]["dense_prefill"]
    assert got["kernels"] == {} and got["flops"] == want


def _report(runs, shape):
    return runs["cells"][f"tinyllama-1.1b__{shape}__16x16.json"]


def test_a_16x16_decode_cell_holds_the_plans_bytes(runs):
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch.describe import SINGLE_POD, chip_bytes
    from repro_torch.launch.specs import cache_chip_bytes
    cfg = get_arch("tinyllama-1.1b")
    rep = _report(runs, "decode_32k")
    assert rep["status"] == "OK" and rep["mesh"] == "16x16"
    assert rep["step"] == "decode" and rep["roofline"]["chips"] == 256
    assert rep["param_bytes_per_rank"] == chip_bytes(cfg, SINGLE_POD)
    assert rep["cache_bytes_per_rank"] == cache_chip_bytes(
        cfg, get_shape("decode_32k"), SINGLE_POD)
    assert rep["memory"]["alias_size_in_bytes"] == rep["cache_bytes_per_rank"]
    assert rep["kernels"]["flash_decode"]["calls"] == cfg.num_layers
    assert rep["collective_counts"]["all-reduce"] > 0
    assert rep["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    # decode's probes (one and two layers) hold the full count's FLOPs:
    # the per-layer layout changes only what FSDP gathers
    assert rep["probe_cost"]["flops"] == rep["cost"]["flops"]
    for key in ("hlo_lines", "collective_bytes_scanbody"):
        assert key not in rep


def test_a_skipped_cell_gives_the_jax_reason(runs):
    from repro.configs import get_arch, get_shape
    from repro.launch.dryrun import skip_reason
    rep = _report(runs, "long_500k")
    assert rep["status"] == "SKIP"
    assert rep["reason"] == skip_reason(get_arch("tinyllama-1.1b"),
                                        get_shape("long_500k"))


def test_a_second_sweep_reports_cached(runs):
    first, again = runs["sweeps"]["first"], runs["sweeps"]["again"]
    assert "done: 2/2 ok" in first and "done: 2/2 ok" in again
    assert again.count(" cached") == 2 and " cached" not in first
    assert "SKIP" in first and "OK" in first


def test_collective_parser_matches_the_jax_one():
    from repro.launch.dryrun import parse_collective_bytes as jax_parse
    texts = ['''
  %ag = bf16[8,128]{1,0} all-gather(%x), replica_groups={}
  %ar = (f32[64]{0}, f32[32]{0}) all-reduce(%a, %b), to_apply=%sum
  %cp = f32[16]{0} collective-permute(%y), source_target_pairs={{0,1}}
  %nothing = f32[4]{0} add(%p, %q)
''', '''
  %rs = bf16[4,1024]{1,0} reduce-scatter(%g), dimensions={0}
  %a2a = s32[2,3,5]{2,1,0} all-to-all(%t), dimensions={1}
  %ar.1 = u8[1048576]{0} all-reduce(%bytes), to_apply=%add
  %ar.2 = pred[7]{0} all-reduce(%flags), to_apply=%or
''', '''
  %ags = (bf16[2,64]{1,0}, bf16[16,64]{1,0}) all-gather-start(%x)
  %agd = bf16[16,64]{1,0} all-gather-done(%ags)
  %scalar = f64[] all-reduce(%s), to_apply=%sum
  %odd = c64[3]{0} collective-permute(%z), source_target_pairs={{1,0}}
''']
    for text in texts:
        assert D.parse_collective_bytes(text) == jax_parse(text)
    by, counts = D.parse_collective_bytes(texts[0])
    assert by["all-gather"] == 8 * 128 * 2
    assert by["all-reduce"] == 64 * 4 + 32 * 4
    assert counts["all-gather"] == 1 and counts["all-reduce"] == 1


def _cells():
    from repro_torch.launch.sweep import ARCHS as SWEEP_ARCHS
    from repro_torch.launch.sweep import SHAPES as SWEEP_SHAPES
    return [(a, s) for a in SWEEP_ARCHS for s in SWEEP_SHAPES]


@pytest.mark.parametrize("chips", [256, 512])
def test_model_flops_per_chip_is_the_jax_formula(chips):
    """``dryrun.py``'s useful-FLOPs numerator, from the JAX package's
    configs, for every sweep cell on both meshes."""
    from repro.configs import get_arch as jget_arch
    from repro.configs import get_shape as jget_shape
    from repro_torch.configs import get_arch, get_shape
    for arch, name in _cells():
        cfg, shape = jget_arch(arch), jget_shape(name)
        tokens = (shape.global_batch if shape.kind == "decode"
                  else shape.seq_len * shape.global_batch)
        mult = 6 if shape.kind == "train" else 2
        want = mult * cfg.active_param_count() * tokens / chips
        assert D.model_flops_per_chip(get_arch(arch), get_shape(name),
                                      chips) == want, (arch, name)


def test_skip_matrix_is_the_jax_one():
    from repro.configs import get_arch as jget_arch
    from repro.configs import get_shape as jget_shape
    from repro.launch.dryrun import skip_reason as jskip
    from repro_torch.configs import get_arch, get_shape
    skipped = 0
    for arch, name in _cells():
        want = jskip(jget_arch(arch), jget_shape(name))
        assert D.skip_reason(get_arch(arch), get_shape(name)) == want
        skipped += want is not None
    assert skipped == 5


def test_sweep_and_dryrun_parse_the_jax_flags():
    from repro_torch.launch import sweep
    assert sweep.ARCHS == __import__("repro.launch.sweep",
                                     fromlist=["ARCHS"]).ARCHS
    with pytest.raises(SystemExit):
        D.main(["--arch", "tinyllama-1.1b", "--shape", "decode_64k"])
    with pytest.raises(SystemExit):
        D.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                "--step", "adam"])


def test_skip_cells_run_without_a_group(capsys):
    """A SKIP cell starts no fake group: the JSON at once, exit 0."""
    D.main(["--arch", "whisper-tiny", "--shape", "long_500k",
            "--multi-pod"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["status"] == "SKIP" and rep["mesh"] == "2x16x16"
    assert not torch.distributed.is_initialized()


# -- the kernel wrappers' shape-only route ------------------------------------

def _wrapper_calls(make):
    """Each wrapper called on tensors from ``make(shape, dtype)``: (name,
    the outputs, the (shape, dtype) each output must have)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.online_sgd_int8 import dfa_epoch_int8
    f32, bf16, i8, i32 = (torch.float32, torch.bfloat16, torch.int8,
                          torch.int32)
    out = []
    p = make((3, 5), bf16)
    out.append(("online_sgd", ops.online_sgd(p, make((3, 5), bf16), 0.1),
                [((3, 5), bf16)]))
    out.append(("online_sgd_momentum", ops.online_sgd_momentum(
        p, make((3, 5), bf16), make((3, 5), f32), 0.1, 0.9),
        [((3, 5), bf16), ((3, 5), f32)]))
    out.append(("meta_update", ops.meta_update(
        make((7,), bf16), make((7,), f32), make((1,), f32)),
        [((7,), bf16)]))
    out.append(("client_mean", ops.client_mean(make((4, 6, 2), bf16),
                                               make((4,), f32)),
                [((6, 2), f32)]))
    out.append(("ssd_scan", ops.ssd_scan(
        make((2, 3, 2, 8, 4), f32), make((2, 3, 2, 8), f32),
        make((2, 2, 8, 4), f32), make((2, 2, 8, 4), f32)),
        [((2, 3, 2, 8, 4), f32)]))
    q, kc = make((2, 4, 64), bf16), make((2, 16, 2, 64), bf16)
    out.append(("flash_decode", ops.flash_decode(q, kc, kc, 9),
                [((2, 4, 64), bf16)]))
    out.append(("flash_decode", ops.flash_decode(
        q, kc, kc, make((1,), i32), offset=16, return_lse=True),
        [((2, 4, 64), f32), ((2, 4), f32)]))
    B, S_, din, h1, h2, dout = 2, 3, 4, 8, 8, 2
    ws = [make((B, din, h1), i8), make((B, h1, h2), i8),
          make((B, h2, dout), i8)]
    bs = [make((B, h1), i32), make((B, h2), i32), make((B, dout), i32)]
    fb = [make((dout, h1), i8), make((dout, h2), i8)]
    dither = [make((B, din, h1), f32), make((B, h1, h2), f32),
              make((B, h2, dout), f32)]
    got = dfa_epoch_int8(ws, bs, make((B, S_, din), i8),
                         make((B, S_, dout), i32), make((B,), i32), fb,
                         dither, make((10,), f32))
    out.append(("dfa_epoch_int8", [*got[0], *got[1], got[2]],
                [((B, din, h1), i8), ((B, h1, h2), i8), ((B, h2, dout), i8),
                 ((B, h1), i32), ((B, h2), i32), ((B, dout), i32),
                 ((B,), f32)]))
    return out


def _flat(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("kind", ["fake_cuda", "meta"])
def test_each_wrapper_takes_its_shape_only_route(kind):
    """On fake CUDA tensors (``FakeTensorMode``: each reports ``is_cuda``)
    and on ``meta`` tensors every wrapper returns outputs of its shapes
    and dtypes without a launch, and records its kernel in a
    ``CostMode``."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    from repro_torch.kernels.costs import CostMode, shape_only
    if kind == "fake_cuda":
        ctx = FakeTensorMode(allow_non_fake_inputs=True)

        def make(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="cuda")
    else:
        ctx = contextlib.nullcontext()

        def make(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
    ops.reset_launch_counts()
    with ctx, CostMode() as cm:
        if kind == "fake_cuda":
            assert make((1,), torch.float32).is_cuda
        calls = _wrapper_calls(make)
    assert all(v == 0 for v in ops.launch_counts().values())
    for name, outs, want in calls:
        outs = _flat(outs)
        assert [(tuple(o.shape), o.dtype) for o in outs] == want, name
        assert all(shape_only(o) for o in outs), name
    assert set(cm.kernels) == set(ops.KERNELS)
    assert cm.kernels["flash_decode"]["calls"] == 2
    # the device-L slice counted at its longest stretch, 16 rows
    assert cm.kernels["flash_decode"]["flops"] == 4 * 2 * 4 * (9 + 16) * 64


def test_a_real_cpu_tensor_still_gets_the_plain_version():
    """A real tensor is never shape-only; on the CPU a wrapper computes
    its plain version, which a ``CostMode`` does not count as aten work
    (the kernel's record stands for it)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.costs import CostMode, shape_only
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2, 4, 64, generator=gen)
    k = torch.randn(2, 16, 2, 64, generator=gen)
    assert not shape_only(q)
    with CostMode() as cm:
        got = ops.flash_decode(q, k, k, 9)
    assert torch.equal(got, ref.flash_decode(q, k, k, 9))
    assert cm.aten_flops == 0
    assert cm.kernels["flash_decode"] == {
        "calls": 1, "flops": 4 * 2 * 4 * 9 * 64,
        "bytes": 2 * 2 * 9 * 2 * 64 * 4 + 2 * 4 * 64 * 8}


def test_flash_decode_slice_gives_fp32_partials_on_the_cpu():
    """``return_lse=True``: the partial output fp32 whatever the caches'
    dtype (the plain version's, unrounded); without it q's dtype."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(2, 4, 64, generator=gen).bfloat16()
    k = torch.randn(2, 16, 2, 64, generator=gen).bfloat16()
    o, lse = ops.flash_decode(q, k, k, 20, offset=8, return_lse=True)
    want, want_lse = ref.flash_decode(q, k, k, 20, offset=8,
                                      return_lse=True)
    assert o.dtype == torch.float32 and torch.equal(o, want)
    assert torch.equal(lse, want_lse)
    assert ops.flash_decode(q, k, k, 9).dtype == torch.bfloat16
