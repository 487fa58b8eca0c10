"""The port's dense LM decode path against the JAX package's, on the
CPU: the plain ``flash_decode`` (against the JAX oracle at every case of
``tests/test_kernels.py`` and against the Pallas kernel in interpret
mode), the kernel wrapper's checks and split plan, RoPE, the MLP,
``decode_attention`` and its block, ``Model.decode_fn`` and its caches
over many steps, the serve launcher's decode mode and its parse-time
rejections.

The JAX package's init (``jax.random``) is carried over with
``bridge.lm_params_from_jax``, caches come back with
``bridge.lm_cache_to_jax``, and inputs are NumPy arrays from a seed.
fp32 is held at 1e-5. The port's ``decode_attention`` goes through
``flash_decode`` while the JAX one is plain jnp: the same function,
which the fp32 checks hold. bf16 rounds at other places in the two
frameworks (and the JAX ``decode_attention`` scales q in bf16, the
kernel in fp32), so bf16 is held to 4 bf16 steps (rtol 2^-6) of the
largest logit.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime.steps import make_decode_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 3e-4, "bfloat16": 2e-2}     # tests/test_kernels.py's
BF16_RTOL = 2 ** -6                           # 4 bf16 steps
KERNEL_SHAPES = [(1, 4, 4, 64, 512), (2, 8, 2, 64, 1024),
                 (1, 8, 1, 128, 2048)]        # MHA, GQA, MQA (B, H, Kv, hd, S)


def _both(a, dtype):
    """One NumPy fp32 array as a JAX and a torch array of ``dtype`` (both
    round to nearest even, so bf16 values are equal)."""
    return (jnp.asarray(a, jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _fd_inputs(B, H, Kv, hd, S, dtype, seed):
    r = np.random.default_rng(seed)
    return [_both(r.standard_normal(s).astype(np.float32), dtype)
            for s in ((B, H, hd), (B, S, Kv, hd), (B, S, Kv, hd))]


def _cases(S):
    return [(S // 2, 0), (S, 0), (1, 0), (S // 2, 128)]


# -- the plain version and the wrapper ---------------------------------------

@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_decode_matches_jax_ref(shape, dtype):
    """All 24 cases of tests/test_kernels.py (3 shapes x 2 dtypes x 4
    (cache_len, window))."""
    (jq, tq), (jk, tk), (jv, tv) = _fd_inputs(*shape, dtype, seed=sum(shape))
    for L, window in _cases(shape[-1]):
        want = np.asarray(jref.flash_decode(jq, jk, jv, L, window=window))
        got = ref.flash_decode(tq, tk, tv, L, window=window)
        assert got.dtype == torch.float32 and got.shape == shape[:2] + (
            shape[3],)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=f"{L}, {window}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_decode_matches_the_pallas_kernel(dtype):
    """The GQA shape through the Pallas kernel in interpret mode, as
    tests/test_kernels.py runs it, with a window."""
    B, H, Kv, hd, S = 2, 8, 2, 64, 1024
    (jq, tq), (jk, tk), (jv, tv) = _fd_inputs(B, H, Kv, hd, S, dtype, 5)
    want = jops.flash_decode(jq, jk, jv, 700, window=128, block_s=256)
    got = ref.flash_decode(tq, tk, tv, 700, window=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,L,block_s", [
    ((2, 8, 1, 256, 512), 300, 256),     # paligemma's head dim 256, R = 8
    ((2, 6, 6, 64, 1500), 1500, 500)])   # whisper's cross decode, L = S
def test_slice16_shapes_match_the_pallas_kernel(shape, L, block_s, dtype):
    """The shapes slice 16 adds to the decode path, through the Pallas
    kernel in interpret mode: the wrapper on the CPU (its plain
    version) within the kernel tolerance."""
    (jq, tq), (jk, tk), (jv, tv) = _fd_inputs(*shape, dtype, seed=L)
    want = jops.flash_decode(jq, jk, jv, L, block_s=block_s)
    got = ops.flash_decode(tq, tk, tv, L)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    (_, q), (_, k), (_, v) = _fd_inputs(2, 8, 2, 64, 100, dtype, 6)
    ops.reset_launch_counts()
    for L, window in ((1, 0), (37, 0), (100, 0), (90, 16)):
        got = ops.flash_decode(q, k, v, L, window=window)
        assert got.dtype == q.dtype and got.shape == q.shape
        assert torch.equal(got, ref.flash_decode(q, k, v, L, window=window)
                           .to(q.dtype))
    assert ops.flash_decode.launches == 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def _bad(case):
    q, k = torch.zeros(2, 8, 64), torch.zeros(2, 16, 2, 64)
    return {"L=0": (q, k, k, 0),
            "L>S": (q, k, k, 17),
            "H%Kv": (torch.zeros(2, 6, 64), torch.zeros(2, 16, 4, 64),
                     torch.zeros(2, 16, 4, 64), 4),
            "v shape": (q, k, torch.zeros(2, 15, 2, 64), 4),
            "batch": (q, torch.zeros(3, 16, 2, 64),
                      torch.zeros(3, 16, 2, 64), 4),
            "head dim": (q, torch.zeros(2, 16, 2, 32),
                         torch.zeros(2, 16, 2, 32), 4),
            "hd 32": (torch.zeros(2, 8, 32), torch.zeros(2, 16, 2, 32),
                      torch.zeros(2, 16, 2, 32), 4),
            "q rank": (torch.zeros(2, 1, 8, 64), k, k, 4),
            "dtype": (q, k.double(), k.double(), 4),
            "float L": (q, k, k, 4.0)}[case]


@pytest.mark.parametrize("case,err,msg", [
    ("L=0", ValueError, "cache_len"), ("L>S", ValueError, "cache_len"),
    ("H%Kv", ValueError, "multiple of Kv"), ("v shape", ValueError, "match"),
    ("batch", ValueError, "match"), ("head dim", ValueError, "match"),
    ("hd 32", ValueError, "head dim"), ("q rank", ValueError, "(B, H, hd)"),
    ("dtype", TypeError, "dtype"), ("float L", TypeError, "integer")])
def test_wrapper_rejects(case, err, msg):
    with pytest.raises(err, match=msg.replace("(", r"\(").replace(")", r"\)")):
        ops.flash_decode(*_bad(case))


@pytest.mark.parametrize("B,Kv,R,n,splits", [
    (8, 4, 8, 1, 1), (8, 4, 8, 577, 2), (8, 4, 8, 2048, 8),
    (4, 4, 2, 32768, 32), (1, 1, 8, 2048, 8), (2, 2, 4, 33, 1),
    (1, 4, 1, 512, 2), (2, 1, 12, 100, 1), (1, 2, 3, 1000, 4),
    (8, 1, 8, 2048, 8), (8, 6, 1, 1500, 6)])
def test_split_plan_covers_the_positions(B, Kv, R, n, splits):
    """Head groups of at most 8, stretches of whole 64-position tiles,
    none empty, at least 4 tiles a block where n has them, some 528
    blocks at most (the decode path's L = 2048: 8 splits, 256 blocks);
    bf16 at most 8 splits, one cluster."""
    for cap, want in ((fd.MAX_SPLITS, splits),
                      (fd.CLUSTER_SPLITS, min(splits, fd.CLUSTER_SPLITS))):
        n_split, chunk = fd.plan(B, Kv, R, n, cap)
        assert chunk % fd.TILE == 0 and n_split == want
        assert (n_split - 1) * chunk < n <= n_split * chunk
        assert n_split == 1 or chunk >= fd.MIN_TILES * fd.TILE
        base = B * Kv * -(-R // fd.MAX_ROWS)
        assert base * n_split < fd.TARGET_BLOCKS + base


@pytest.mark.parametrize("B,H,Kv,hd,n_split,want", [
    (8, 32, 4, 64, 1, (0, 0)), (8, 32, 4, 64, 8, (8 * 8 * 32 * 66, 32)),
    (1, 24, 2, 128, 3, (3 * 24 * 130, 4)), (4, 8, 4, 64, 17,
                                             (17 * 4 * 8 * 66, 16)),
    (8, 8, 1, 256, 8, (8 * 8 * 8 * 258, 8))])
def test_scratch_sizes(B, H, Kv, hd, n_split, want):
    """A split call's workspace holds every split's accumulator, max and
    sum per (b, h); its counters one per (b, head group of up to 8)."""
    assert fd.scratch_sizes(B, H, Kv, hd, n_split) == want


def _flash_decode_p_bf16(q, k_cache, v_cache, cache_len):
    """ref.flash_decode's math with the kernel's bf16 rounding of p for
    the P V product; the denominator sums the unrounded p."""
    B, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    R = H // Kv
    qg = q.reshape(B, Kv, R, hd).float() * hd ** -0.5
    s = torch.einsum("bkrh,bskh->bkrs", qg, k_cache.float())
    s = s.masked_fill(torch.arange(S) >= cache_len, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bkrs,bskh->bkrh", p.bfloat16().float(),
                       v_cache.float()) / p.sum(-1, keepdim=True)
    return out.reshape(B, H, hd)


@pytest.mark.parametrize("L", [1, 577, 2048])
def test_bf16_probabilities_fit_the_kernel_tolerance(L):
    """The bf16 kernel rounds p to bf16 for P V (the TPU kernel keeps it
    fp32). At the decode path's R = 8, hd 64, S = 2,048 that rounding
    stays well inside the kernel's bf16 tolerance (chip_smoke.py's
    FD_TOL: 2e-2 relative, 2e-2 x min(1, max |want|) absolute)."""
    B, H, Kv, hd, S = 8, 32, 4, 64, 2048
    r = np.random.default_rng(L)
    q, k, v = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((B, H, hd), (B, S, Kv, hd),
                                     (B, S, Kv, hd)))
    want = ref.flash_decode(q, k, v, L)
    got = _flash_decode_p_bf16(q, k, v, L)
    tol = TOL["bfloat16"]
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * min(1.0, want.abs().max().item()))
    # and by a wide margin: within a tenth of the absolute tolerance
    err = (got - want).abs().max().item()
    assert err <= 0.1 * tol * min(1.0, want.abs().max().item())


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("positions", ["shared", "per_row"])
def test_apply_rope_matches_jax(positions):
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 5, 4, 64)).astype(np.float32)
    pos = (np.arange(3, 8) if positions == "shared"
           else r.integers(0, 3000, (2, 5))).astype(np.int32)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = attention.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), 64, 96, act, jnp.float32)
    if act == "gelu":      # non-zero biases, so they are exercised
        jp = {**jp, "b_in": jnp.linspace(-1, 1, 96),
              "b_out": jnp.linspace(-0.5, 0.5, 64)}
    x = np.random.default_rng(8).standard_normal((2, 3, 64)).astype(
        np.float32) * 2
    want = jlayers.mlp(jp, jnp.asarray(x), act)
    got = layers.mlp(bridge.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"),
        torch.from_numpy(x), act)
    assert set(jp) == set(layers.mlp_shapes(64, 96, act, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 24])
def test_decode_attention_matches_jax(window):
    B, H, Kv, hd, S = 2, 8, 2, 64, 96
    r = np.random.default_rng(9 + window)
    q = r.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (r.standard_normal((B, S, Kv, hd)).astype(np.float32)
            for _ in range(2))
    for L in (1, 30, 96):
        want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), L, window=window)
        got = attention.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), L,
            window=window)
        assert got.shape == (B, 1, H, hd)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_decode_attention_block_matches_jax():
    d, H, Kv, hd, S, B = 64, 8, 2, 64, 40, 2
    jp = jattn.init_attention(jax.random.PRNGKey(4), d, H, Kv, hd,
                              jnp.float32)
    tp = bridge.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                  "cpu")
    r = np.random.default_rng(10)
    kc, vc = (r.standard_normal((B, S, Kv, hd)).astype(np.float32)
              for _ in range(2))
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    for t in (0, 7, 39):
        x = r.standard_normal((B, 1, d)).astype(np.float32)
        want, jk, jv = jattn.decode_attention_block(
            jp, jnp.asarray(x), jk, jv, t, rope_theta=10_000.0, window=16)
        rope = attention.rope_angles(torch.full((B, 1), t), hd, 10_000.0)
        got, tk, tv = attention.decode_attention_block(
            tp, torch.from_numpy(x), tk, tv, t, rope, window=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        for a, b in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
    with pytest.raises(ValueError, match="cannot write at 40"):
        attention.decode_attention_block(
            tp, torch.zeros(B, 1, d), tk, tv, 40, rope)


# -- the model, many steps ---------------------------------------------------

def _configs(name):
    """(JAX config, port config, cache length, steps) of each model."""
    def pair(arch, **kw):
        return (dataclasses.replace(jget_arch(arch).reduced(), **kw),
                dataclasses.replace(get_arch(arch).reduced(), **kw))
    if name == "tinyllama_mha":                    # 4 heads, 4 KV heads
        return (*pair("tinyllama-1.1b"), 32, 12)
    if name == "tinyllama_gqa_scan":               # 4 layers: JAX stacks
        return (*pair("tinyllama-1.1b", num_heads=8, num_kv_heads=2,
                      num_layers=4), 24, 12)
    if name == "starcoder2_window":                # gelu, window 64
        return (*pair("starcoder2-15b"), 128, 100)
    return (*pair("tinyllama-1.1b", dtype="bfloat16"), 16, 12)


@pytest.mark.parametrize("name", ["tinyllama_mha", "tinyllama_gqa_scan",
                                  "starcoder2_window", "tinyllama_bf16"])
def test_decode_fn_matches_jax(name):
    jcfg, tcfg, cache_len, steps = _configs(name)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    assert tm.jax_layout == (1 if name == "tinyllama_gqa_scan" else None)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.lm_params_from_jax(jparams, tm.jax_layout, "cpu")
    assert {p: (tuple(s), str(d).split(".")[1]) for p, (s, d) in
            bridge.tree_leaves(tm.param_shapes())} == {
        p: (tuple(t.shape), str(t.dtype).split(".")[1])
        for p, t in bridge.tree_leaves(tparams)}
    B = 2
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                               (B, steps))
    jdecode = jax.jit(jm.decode_fn)
    step = make_decode_step(tm)
    jcache = jm.init_cache(B, cache_len)
    tcache = tm.init_cache(B, cache_len, device="cpu")
    bf16 = tcfg.dtype == "bfloat16"
    with torch.no_grad():
        for t in range(steps):
            jl, jcache = jdecode(jparams, {
                "tokens": jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                "cache": jcache, "cache_len": jnp.int32(t)})
            tl, tcache = step(tparams, {
                "tokens": torch.from_numpy(tokens[:, t:t + 1]),
                "cache": tcache, "cache_len": t})
            want = np.asarray(jl)
            assert tl.dtype == torch.float32 and tl.shape == want.shape
            if bf16:
                np.testing.assert_allclose(
                    tl.numpy(), want, rtol=BF16_RTOL,
                    atol=BF16_RTOL * np.abs(want).max(), err_msg=str(t))
            else:
                np.testing.assert_allclose(tl.numpy(), want, rtol=1e-5,
                                           atol=1e-5, err_msg=str(t))
    got = bridge.flatten_tree(bridge.lm_cache_to_jax(tcache, tm.jax_layout))
    want = bridge.flatten_tree(jcache)
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        assert got[path].shape == w.shape, path
        if bf16:
            np.testing.assert_allclose(got[path], w, rtol=BF16_RTOL,
                                       atol=BF16_RTOL * np.abs(w).max())
        else:
            np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-5)
    back = bridge.lm_cache_from_jax(jcache, tm.jax_layout, "cpu")
    for (pa, a), (pb, b) in zip(bridge.tree_leaves(back),
                                bridge.tree_leaves(tcache)):
        assert pa == pb and a.shape == b.shape and a.dtype == b.dtype


def test_dense_model_param_count_and_full_width_shapes():
    """tinyllama-1.1b as registered, from shapes alone (no weights)."""
    cfg = get_arch("tinyllama-1.1b")
    model = build_model(cfg)
    leaves = list(bridge.tree_leaves(model.param_shapes()))
    n = sum(int(np.prod(s)) for _, (s, _) in leaves)
    assert n == cfg.param_count() == 1_100_048_384
    assert all(d == torch.bfloat16 for _, (_, d) in leaves)
    assert model.jax_layout == 1 and len(model.specs) == 22


# -- the launcher ------------------------------------------------------------

def test_launcher_matches_jax_run_decode(capsys):
    """The port's decode row against the JAX launcher's, from the JAX
    package's init carried over: the same greedy tokens and count."""
    argv = ["--arch", "tinyllama-1.1b", "--reduced"]
    jargs = jserve.parse_args(argv)
    jserve.run_decode(jargs)
    want = json.loads(capsys.readouterr().out)
    jcfg = jget_arch(jargs.arch).reduced()
    init = jbuild(jcfg).init(jax.random.PRNGKey(jargs.seed))
    args = serve.parse_args(["--mode", "decode", *argv, "--device", "cpu"])
    row, outputs = serve.run_decode(args, params=bridge.lm_params_from_jax(
        init, build_model(get_arch(args.arch).reduced()).jax_layout, "cpu"))
    capsys.readouterr()
    assert set(want) | {"device", "kernel_launches"} == set(row)
    for key in ("arch", "requests", "tokens_generated", "sample_output"):
        assert row[key] == want[key], key
    assert len(outputs) == 6 and all(len(o) == 8 for o in outputs)
    assert row["kernel_launches"] == {k: 0 for k in ops.KERNELS}


def _run(args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=str(ROOT))


def test_cli_decode_on_cpu_prints_the_row():
    out = _run(["--arch", "starcoder2-15b", "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "4"])
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout)
    assert row["arch"] == "starcoder2-15b-reduced" and row["device"] == "cpu"
    assert row["tokens_generated"] == 2 * 2 * 4      # the pad slot counts
    assert len(row["sample_output"]) == 4
    assert row["kernel_launches"]["flash_decode"] == 0


def test_decode_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(["--arch", "tinyllama-1.1b", "--reduced"])
    assert out.returncode != 0 and "no CUDA device" in out.stderr


@pytest.mark.parametrize("argv,msg", [
    (["--mode", "decode"], "--arch is required for --mode decode"),
    (["--arch", "nope"], "not in"),
    (["--mode", "adapt", "--arch", "zamba2-1.2b"],
     "--arch only applies with --mode decode"),
    (["--arch", "mixtral-8x22b", "--max-new", "-1"], "--max-new must be"),
    (["--arch", "tinyllama-1.1b", "--slots", "4"],
     "--slots only applies with --mode adapt"),
    (["--arch", "tinyllama-1.1b", "--strategy", "tifed"],
     "--strategy only applies with --mode adapt"),
    (["--mode", "adapt", "--batch", "4"],
     "--batch only applies with --mode decode"),
    (["--mode", "adapt", "--reduced"],
     "--reduced only applies with --mode decode"),
    (["--arch", "tinyllama-1.1b", "--prompt-len", "8", "--max-new", "8",
      "--cache-len", "15"], "--cache-len 15 cannot hold"),
    (["--arch", "tinyllama-1.1b", "--prompt-len", "0"], "--prompt-len"),
    (["--arch", "tinyllama-1.1b", "--batch", "0"], "--batch must be"),
    (["--arch", "tinyllama-1.1b", "--requests", "0"], "--requests"),
])
def test_decode_parse_rejections(argv, msg, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(argv)
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--arch", "paligemma-3b"],
                                  ["--arch", "whisper-tiny"]])
def test_decode_parse_takes_the_encdec_and_vlm_configs(argv):
    """The VLM and the encoder-decoder decode (rejected until slice 16)."""
    args = serve.parse_args(argv)
    assert args.mode == "decode" and args.arch == argv[1]
    assert args.arch in serve.decode_archs()
