"""The port's Mamba2 decode path against the JAX package's, on the CPU:
``mamba_decode_block``, ``Model.init_cache`` and ``decode_fn`` over 32
steps with the cache carried back through ``bridge.lm_cache_to_jax``,
the decode runner's waves, and the serve launcher's decode mode.

The JAX package's init (``jax.random``) is carried over with
``bridge.lm_params_from_jax``, and every input is a seeded NumPy array.
The reduced config runs at 2 layers and at 4, where the JAX package
stacks the layers and their cache entries. Tolerances: one block at
rtol 1e-5; 32 decode steps in fp32 within 2e-5 of the largest entry
(logits, then each cache leaf): the state carries each step's rounding
into the next, and at 4 layers the two packages' fp32 logits drift
further apart than 1e-5 of the largest (each drifts from a float64
decode of the same weights). bf16 within 16 bf16 steps of the largest
entry (2^-4): XLA keeps fused bf16 elementwise chains in fp32 where
torch rounds each op, and over 32 recurrent steps 4 bf16 steps (as
``tests/test_torch_decode.py`` holds the dense family over 12 steps) do
not hold. The recurrent decode is also held to the port's own chunked
scan (``prefill_fn``) at 1e-4: two algorithms for one function.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime.steps import DecodeRunner  # noqa: E402

BF16_DECODE_TOL = 2 ** -4                     # 16 bf16 steps


def _np(a):
    return np.asarray(a, np.float32)


def _configs(layers, dtype="float32"):
    kw = dict(num_layers=layers, dtype=dtype)
    return (dataclasses.replace(jget_arch("mamba2-130m").reduced(), **kw),
            dataclasses.replace(get_arch("mamba2-130m").reduced(), **kw))


def _close(got, want, bf16):
    """fp32 within 2e-5 of the largest entry; bf16 within 16 bf16 steps
    of it."""
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_DECODE_TOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())


def test_mamba_decode_block_matches_jax():
    """One token through one block from random nonzero states: the
    output and both new states at 1e-5."""
    jcfg, _ = _configs(2)
    d, n, p, e, W = (jcfg.d_model, jcfg.ssm_state, jcfg.ssm_head_dim,
                     jcfg.ssm_expand, jcfg.ssm_conv_width)
    jp = jmamba.init_mamba(jax.random.PRNGKey(3), d, n, p, e, W,
                           jnp.float32)
    jp = dict(jp, dt_bias=jnp.linspace(-1.0, 1.0, jp["dt_bias"].shape[0]),
              conv_b=jnp.full(jp["conv_b"].shape, 0.1),
              gate_norm=jnp.full(jp["gate_norm"].shape, 0.2))
    _, nheads, conv_dim = jmamba.mamba_dims(d, e, p, n)
    r = np.random.default_rng(0)
    x = r.standard_normal((3, 1, d)).astype(np.float32)
    conv = r.standard_normal((3, W - 1, conv_dim)).astype(np.float32)
    ssm = r.standard_normal((3, nheads, p, n)).astype(np.float32)
    kw = dict(d_state=n, head_dim=p, expand=e, conv_width=W,
              norm_eps=jcfg.norm_eps)
    want = jmamba.mamba_decode_block(jp, jnp.asarray(x), jnp.asarray(conv),
                                     jnp.asarray(ssm), **kw)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = tmamba.mamba_decode_block(tp, torch.from_numpy(x),
                                    torch.from_numpy(conv),
                                    torch.from_numpy(ssm), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=1e-5)


def test_mamba_decode_block_matches_jax_bf16():
    """One token through one bf16 block from random nonzero states (the
    conv window in bf16, the ssm state fp32): the output and both new
    states within 4 bf16 steps of each one's largest entry."""
    jcfg, _ = _configs(2)
    d, n, p, e, W = (jcfg.d_model, jcfg.ssm_state, jcfg.ssm_head_dim,
                     jcfg.ssm_expand, jcfg.ssm_conv_width)
    jp = jmamba.init_mamba(jax.random.PRNGKey(4), d, n, p, e, W,
                           jnp.bfloat16)
    _, nheads, conv_dim = jmamba.mamba_dims(d, e, p, n)
    r = np.random.default_rng(5)
    x = r.standard_normal((3, 1, d)).astype(np.float32)
    conv = r.standard_normal((3, W - 1, conv_dim)).astype(np.float32)
    ssm = r.standard_normal((3, nheads, p, n)).astype(np.float32)
    kw = dict(d_state=n, head_dim=p, expand=e, conv_width=W,
              norm_eps=jcfg.norm_eps)
    want = jax.jit(functools.partial(jmamba.mamba_decode_block, **kw))(
        jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(conv, jnp.bfloat16),
        jnp.asarray(ssm))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = tmamba.mamba_decode_block(
        tp, torch.from_numpy(x).bfloat16(), torch.from_numpy(conv).bfloat16(),
        torch.from_numpy(ssm), **kw)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, str(w.dtype))
        w = _np(w)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=4 * 2 ** -8 * np.abs(w).max())


def test_bf16_decode_parts_from_prefill_as_jax_does():
    """In bf16 the recurrent decode and the chunked scan round in other
    places in every layer, and over the depth of mamba2-130m (24 layers,
    here at the reduced width) the two routes' logits part by more than 4
    bf16 steps of the largest, in the JAX package as in the port. The
    port's parting stays within twice the JAX package's own at each
    position: it adds no bf16 fault of its own. Prints the partings."""
    jcfg, tcfg = _configs(24, "bfloat16")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.lm_params_from_jax(jparams, tm.jax_layout, "cpu")
    at, B = (0, 31, 63), 2
    tokens = np.random.default_rng(17).integers(0, jcfg.vocab_size,
                                                (B, max(at) + 1))
    jdecode, jprefill = jax.jit(jm.decode_fn), jax.jit(jm.prefill_fn)
    jcache = jm.init_cache(B, tokens.shape[1])
    tcache = tm.init_cache(B, tokens.shape[1], device="cpu")
    parts = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            jl, jcache = jdecode(jparams, {
                "tokens": jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                "cache": jcache, "cache_len": jnp.int32(t)})
            tl, tcache = tm.decode_fn(tparams, {
                "tokens": torch.from_numpy(tokens[:, t:t + 1]),
                "cache": tcache, "cache_len": t})
            if t not in at:
                continue
            jp = _np(jprefill(jparams, {"tokens": jnp.asarray(
                tokens[:, :t + 1], jnp.int32)}))
            tp = tm.prefill_fn(tparams, {"tokens": torch.from_numpy(
                tokens[:, :t + 1])}).numpy()
            jl = _np(jl)
            parts.append({"t": t,
                          "jax": float(np.abs(jl - jp).max()
                                       / np.abs(jl).max()),
                          "port": float(np.abs(tl.numpy() - tp).max()
                                        / np.abs(tl.numpy()).max())})
    print(json.dumps({"bf16_decode_vs_prefill_of_max": parts}))
    for row in parts:
        assert row["port"] <= 2 * row["jax"], row


@pytest.mark.parametrize("layers,dtype", [(2, "float32"), (4, "float32"),
                                          (2, "bfloat16")])
def test_decode_fn_matches_jax(layers, dtype):
    """32 decode steps at batch 2 from the JAX init: every step's logits,
    then the final cache carried back to the JAX layout (stacked at 4
    layers) and forward again, each entry's shape and dtype kept."""
    jcfg, tcfg = _configs(layers, dtype)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    assert tm.jax_layout == (1 if layers == 4 else None)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.lm_params_from_jax(jparams, tm.jax_layout, "cpu")
    B, steps = 2, 32
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                               (B, steps))
    jdecode = jax.jit(jm.decode_fn)
    jcache = jm.init_cache(B, steps)
    tcache = tm.init_cache(B, steps, device="cpu")
    for entry in tcache["layers"]:
        assert entry["ssm"].dtype == torch.float32
        assert entry["conv"].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                       else torch.float32)
    bf16 = dtype == "bfloat16"
    with torch.no_grad():
        for t in range(steps):
            jl, jcache = jdecode(jparams, {
                "tokens": jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                "cache": jcache, "cache_len": jnp.int32(t)})
            tl, tcache = tm.decode_fn(tparams, {
                "tokens": torch.from_numpy(tokens[:, t:t + 1]),
                "cache": tcache, "cache_len": t})
            assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
            _close(tl.numpy(), _np(jl), bf16)
    got = bridge.flatten_tree(bridge.lm_cache_to_jax(tcache, tm.jax_layout))
    want = bridge.flatten_tree(jcache)
    assert set(got) == set(want)
    for path, w in want.items():
        w = _np(w)
        assert got[path].shape == w.shape, path
        _close(got[path], w, bf16)
    back = bridge.lm_cache_from_jax(jcache, tm.jax_layout, "cpu")
    for (pa, a), (pb, b) in zip(bridge.tree_leaves(back),
                                bridge.tree_leaves(tcache)):
        assert pa == pb and a.shape == b.shape and a.dtype == b.dtype


def test_decode_equals_the_chunked_scan():
    """Teacher-forced decode logits at position t equal ``prefill_fn`` of
    the first t + 1 tokens (the chunked scan, here its plain version) at
    1e-4, at t = 0, a chunk's last token and past two chunks."""
    _, tcfg = _configs(2)
    tm = build_model(tcfg)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    T = 2 * tcfg.ssm_chunk + 5
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, T)))
    cache = tm.init_cache(2, T, device="cpu")
    with torch.no_grad():
        for t in range(T):
            logits, cache = tm.decode_fn(params, {
                "tokens": tokens[:, t:t + 1], "cache": cache,
                "cache_len": t})
            if t in (0, tcfg.ssm_chunk - 1, T - 1):
                want = tm.prefill_fn(params, {"tokens": tokens[:, :t + 1]})
                np.testing.assert_allclose(logits.numpy(), want.numpy(),
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=str(t))


def test_decode_runner_waves_start_from_a_zero_state():
    """The runner's state is zeroed at each wave, so the same prompts
    give the same tokens and logits in a later wave, equal to the model's
    own decode steps from a fresh cache."""
    _, tcfg = _configs(2)
    tm = build_model(tcfg)
    params = tm.init(torch.Generator().manual_seed(1), "cpu")
    runner = DecodeRunner(tm, params, batch=2, prompt_len=5, cache_len=12,
                          max_new=7, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 5)))
    other = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 5)))
    first, logits = runner.wave(prompts), []
    runner.wave(other)
    again = runner.wave(prompts, on_logits=logits.append)
    assert first == again and runner.trace_count == 1
    cache = tm.init_cache(2, 12, device="cpu")
    tok = prompts
    with torch.no_grad():
        for t in range(12):
            lg, cache = tm.decode_fn(params, {"tokens": tok[:, t:t + 1],
                                              "cache": cache,
                                              "cache_len": t})
            assert torch.equal(lg, logits[t])
            if t >= 4:
                tok = torch.cat([tok, lg[:, 0].argmax(-1, keepdim=True)], 1)
    assert tok[:, 5:12].tolist() == again


def test_serve_launcher_matches_jax_run_decode(capsys):
    """``serve --mode decode --arch mamba2-130m --reduced`` against the JAX
    launcher's row, from the JAX package's init carried over: the same
    greedy tokens and count, no kernel on the CPU."""
    argv = ["--arch", "mamba2-130m", "--reduced"]
    jargs = jserve.parse_args(argv)
    jserve.run_decode(jargs)
    want = json.loads(capsys.readouterr().out)
    init = jbuild(jget_arch(jargs.arch).reduced()).init(
        jax.random.PRNGKey(jargs.seed))
    args = serve.parse_args(["--mode", "decode", *argv, "--device", "cpu"])
    row, outputs = serve.run_decode(args, params=bridge.lm_params_from_jax(
        init, build_model(get_arch(args.arch).reduced()).jax_layout, "cpu"))
    capsys.readouterr()
    assert set(want) | {"device", "kernel_launches"} == set(row)
    for key in ("arch", "requests", "tokens_generated", "sample_output"):
        assert row[key] == want[key], key
    assert len(outputs) == 6 and all(len(o) == 8 for o in outputs)
    assert row["kernel_launches"] == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("arch", ["mamba2-130m", "tinyllama-1.1b",
                                  "starcoder2-15b"])
def test_serve_decode_takes_the_dense_and_ssm_families(arch):
    args = serve.parse_args(["--arch", arch])
    assert args.mode == "decode" and arch in serve.decode_archs()
