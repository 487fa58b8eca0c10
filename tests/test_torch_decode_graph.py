"""The decode step built once, on the CPU: ``flash_decode``,
``decode_attention`` and ``Model.decode_fn`` with ``cache_len`` a tensor
(as the JAX package's ``decode_fn`` takes a traced scalar), and the
decode runner (``runtime/steps.py::DecodeRunner``) against the eager
decode loop it replaced and against the JAX launcher.

A tensor ``cache_len`` must give exactly what the int gives; the port
with a tensor is held to the JAX package's jitted ``decode_fn`` (a traced
``jnp.int32``) within 1e-5 in fp32, with the JAX init carried over by
``bridge.lm_params_from_jax``. On the card the runner's step is a CUDA
graph (``tests/test_torch_cuda.py`` holds its replays to the eager step);
here the same function runs eagerly.
"""
import dataclasses
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
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime.steps import DecodeRunner  # noqa: E402


def _len(L):
    return torch.tensor([L], dtype=torch.int32)


def _inputs(B, H, Kv, hd, S, seed, dtype=torch.float32):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((B, H, hd), (B, S, Kv, hd), (B, S, Kv, hd))]


# -- flash_decode and attention with L a tensor --------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 16])
def test_wrapper_tensor_len_equals_int(dtype, window):
    """Every L of a short wave, with and without a window."""
    q, k, v = _inputs(2, 8, 2, 64, 48, 11, dtype)
    for L in range(1, 49):
        want = ops.flash_decode(q, k, v, L, window=window)
        got = ops.flash_decode(q, k, v, _len(L), window=window)
        assert torch.equal(got, want), L
        assert torch.equal(ops.flash_decode(q, k, v, torch.tensor(L, dtype=
                                            torch.int32), window=window),
                           want)


@pytest.mark.parametrize("window", [0, 16])
def test_decode_attention_tensor_len_equals_int(window):
    q, k, v = _inputs(2, 8, 2, 64, 40, 12)
    q = q[:, None]
    for L in range(1, 41):
        assert torch.equal(
            attention.decode_attention(q, k, v, _len(L), window=window),
            attention.decode_attention(q, k, v, L, window=window)), L


def test_decode_attention_block_tensor_len_equals_int():
    """The cache write at a device position (no host index) and the
    attention over cache_len + 1, against the int route, step by step."""
    d, H, Kv, hd, S, B = 64, 8, 2, 64, 24, 2
    r = np.random.default_rng(13)
    params = {name: torch.from_numpy(r.standard_normal(shape).astype(
        np.float32) * 0.1) for name, (shape, _) in attention.attention_shapes(
            d, H, Kv, hd, torch.float32).items()}
    caches = [[torch.zeros(B, S, Kv, hd) for _ in range(2)] for _ in range(2)]
    for t in range(S):
        x = torch.from_numpy(r.standard_normal((B, 1, d)).astype(np.float32))
        rope = attention.rope_angles(torch.full((B, 1), t), hd, 10_000.0)
        outs = [attention.decode_attention_block(params, x, kc, vc, at, rope,
                                                 window=8)[0]
                for (kc, vc), at in zip(caches, (t, _len(t)))]
        assert torch.equal(outs[1], outs[0]), t
        for a, b in zip(*caches):
            assert torch.equal(a, b), t


@pytest.mark.parametrize("bad,err,msg", [
    (torch.tensor([4]), TypeError, "one int32"),
    (torch.tensor([4, 5], dtype=torch.int32), TypeError, "one int32"),
    (torch.tensor([0], dtype=torch.int32), ValueError, "cache_len must be"),
    (torch.tensor([17], dtype=torch.int32), ValueError, "cache_len must be")])
def test_wrapper_rejects_bad_tensor_len(bad, err, msg):
    """A tensor L must be one int32 on q's device; on the CPU it is read
    and held to [1, S] as an int is (the kernel clamps it on the card)."""
    q, k, v = _inputs(2, 8, 2, 64, 16, 14)
    with pytest.raises(err, match=msg):
        ops.flash_decode(q, k, v, bad)


@pytest.mark.parametrize("B,Kv,R,cap", [(8, 4, 8, fd.CLUSTER_SPLITS),
                                        (4, 4, 2, fd.MAX_SPLITS),
                                        (1, 1, 8, fd.MAX_SPLITS),
                                        (2, 2, 12, fd.CLUSTER_SPLITS)])
@pytest.mark.parametrize("min_tiles", [1, fd.MIN_TILES])
def test_device_len_grid_holds_every_shorter_plan(B, Kv, R, cap, min_tiles,
                                                  monkeypatch):
    """The device-L route's grid, ``splits_for`` of the longest stretch,
    is at least the splits ``plan`` gives every shorter one, and ``plan``
    covers the positions in stretches of whole tiles with none empty."""
    monkeypatch.setattr(fd, "MIN_TILES", min_tiles)
    fd.plan.cache_clear()
    for n_max in (1, 64, 65, 700, 2048, 4097):
        grid = fd.splits_for(B, Kv, R, n_max, cap)
        assert 1 <= grid <= cap
        for n in range(1, n_max + 1):
            n_split, chunk = fd.plan(B, Kv, R, n, cap)
            assert n_split <= fd.splits_for(B, Kv, R, n, cap) <= grid
            assert chunk % fd.TILE == 0
            assert (n_split - 1) * chunk < n <= n_split * chunk
    fd.plan.cache_clear()


# -- decode_fn with L a tensor, against the JAX package's jitted one ----------

def _pair(arch, **kw):
    return (dataclasses.replace(jget_arch(arch).reduced(), **kw),
            dataclasses.replace(get_arch(arch).reduced(), **kw))


_CONFIGS = {"tinyllama_mha": (_pair("tinyllama-1.1b"), 20),
            "tinyllama_gqa_scan": (_pair("tinyllama-1.1b", num_heads=8,
                                         num_kv_heads=2, num_layers=4), 16),
            "starcoder2_window": (_pair("starcoder2-15b", sliding_window=8),
                                  20)}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_decode_fn_tensor_len_matches_jitted_jax(name):
    """Teacher-forced steps from an empty cache: the port's logits with
    ``cache_len`` a CPU int32 tensor against ``jax.jit(decode_fn)`` with a
    traced ``jnp.int32``, within 1e-5 at every step, and equal to the
    port's own int route."""
    (jcfg, tcfg), steps = _CONFIGS[name]
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    tparams = bridge.lm_params_from_jax(jparams, tm.jax_layout, "cpu")
    B = 2
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                               (B, steps))
    jdecode = jax.jit(jm.decode_fn)
    jcache = jm.init_cache(B, steps)
    caches = [tm.init_cache(B, steps, device="cpu") for _ in range(2)]
    with torch.no_grad():
        for t in range(steps):
            jl, jcache = jdecode(jparams, {
                "tokens": jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                "cache": jcache, "cache_len": jnp.int32(t)})
            got, want = (tm.decode_fn(tparams, {
                "tokens": torch.from_numpy(tokens[:, t:t + 1]),
                "cache": cache, "cache_len": at})[0]
                for cache, at in zip(caches, (_len(t), t)))
            np.testing.assert_allclose(got.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=1e-5, err_msg=str(t))
            assert torch.equal(got, want), t


# -- the decode runner --------------------------------------------------------

def _eager_decode(model, params, prompts, *, batch, max_new, cache_len):
    """The launcher's decode loop before the runner: a fresh cache a wave,
    ``decode_fn`` called with a host int, the argmax on the device, every
    step's logits kept."""
    prompt_len = len(prompts[0])
    queue, outputs, logits_seen = list(prompts), [], []
    with torch.no_grad():
        while queue:
            wave, queue = queue[:batch], queue[batch:]
            n_real = len(wave)
            wave += [np.zeros(prompt_len, np.int64)] * (batch - n_real)
            tokens = torch.from_numpy(np.stack(wave).astype(np.int64))
            cache = model.init_cache(batch, cache_len, device="cpu")
            for t in range(prompt_len):
                logits, cache = model.decode_fn(params, {
                    "tokens": tokens[:, t:t + 1], "cache": cache,
                    "cache_len": t})
                logits_seen.append(logits)
            chosen = []
            for t in range(max_new):
                nxt = torch.argmax(logits[:, 0], dim=-1)
                chosen.append(nxt)
                logits, cache = model.decode_fn(params, {
                    "tokens": nxt[:, None], "cache": cache,
                    "cache_len": prompt_len + t})
                logits_seen.append(logits)
            gen = (torch.stack(chosen, dim=1).tolist() if chosen
                   else [[] for _ in range(batch)])
            outputs.extend(gen[:n_real])
    return outputs, logits_seen


def _model(arch="tinyllama-1.1b", seed=0):
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("arch,requests,batch,prompt_len,max_new,cache_len", [
    ("tinyllama-1.1b", 5, 2, 6, 7, 16),          # a pad slot, 3 waves
    ("tinyllama-1.1b", 3, 3, 1, 10, 11),         # a one-token prompt
    ("tinyllama-1.1b", 2, 2, 5, 0, 8),           # no new tokens
    ("starcoder2-15b", 4, 2, 40, 30, 96)])       # the window (64) slides
def test_runner_matches_the_eager_loop(arch, requests, batch, prompt_len,
                                       max_new, cache_len):
    """The runner's waves give exactly the eager loop's tokens, and its
    logits within 1e-6 at every step (the cache is reused across waves:
    nothing reads past the rows a step has written)."""
    cfg, model, params = _model(arch, seed=requests)
    rng = np.random.default_rng(prompt_len)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len)
               for _ in range(requests)]
    want, want_logits = _eager_decode(model, params, prompts, batch=batch,
                                      max_new=max_new, cache_len=cache_len)
    runner = DecodeRunner(model, params, batch=batch, prompt_len=prompt_len,
                          cache_len=cache_len, max_new=max_new, device="cpu")
    seen = []
    got, tokens_out = serve.decode_requests(runner, prompts,
                                            on_logits=seen.append)
    assert got == want and len(got) == requests
    assert all(len(o) == max_new for o in got)
    assert tokens_out == -(-requests // batch) * batch * max_new
    assert len(seen) == len(want_logits)
    for a, b in zip(seen, want_logits):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert runner.trace_count == 1
    assert runner.capture_s is None and runner.nodes is None   # the CPU


def _jax_decode(jcfg, jparams, prompts, *, batch, max_new, cache_len):
    """The JAX launcher's loop (``repro/launch/serve.py::run_decode``),
    keeping every request's tokens."""
    jm = jbuild(jcfg)
    decode = jax.jit(jm.decode_fn)
    queue, done = list(prompts), []
    while queue:
        wave, queue = queue[:batch], queue[batch:]
        n_real = len(wave)
        wave += [np.zeros(len(prompts[0]), np.int64)] * (batch - n_real)
        cache = jm.init_cache(batch, cache_len)
        toks = jnp.asarray(np.stack(wave), jnp.int32)
        for t in range(toks.shape[1]):
            logits, cache = decode(jparams, {
                "tokens": toks[:, t:t + 1], "cache": cache,
                "cache_len": jnp.int32(t)})
        outs = [[] for _ in range(batch)]
        for t in range(max_new):
            nxt = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
            for i in range(batch):
                outs[i].append(int(nxt[i]))
            logits, cache = decode(jparams, {
                "tokens": nxt[:, None], "cache": cache,
                "cache_len": jnp.int32(toks.shape[1] + t)})
        done.extend(outs[:n_real])
    return done


def test_runner_matches_the_jax_launcher(capsys):
    """Every generated token of every request, from the JAX init carried
    over, against the JAX launcher's loop; and the JAX launcher's own row
    at its defaults."""
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--requests", "5",
            "--prompt-len", "6", "--max-new", "9", "--cache-len", "15"]
    jargs = jserve.parse_args(argv)
    jcfg = jget_arch(jargs.arch).reduced()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(jargs.seed))
    rng = np.random.default_rng(jargs.seed)
    prompts = [rng.integers(0, jcfg.vocab_size, size=jargs.prompt_len)
               for _ in range(jargs.requests)]
    want = _jax_decode(jcfg, jparams, prompts, batch=jargs.batch,
                       max_new=jargs.max_new, cache_len=jargs.cache_len)
    jserve.run_decode(jargs)
    jrow = capsys.readouterr().out
    args = serve.parse_args(["--mode", "decode", *argv, "--device", "cpu"])
    built = []
    row, got = serve.run_decode(args, params=bridge.lm_params_from_jax(
        jparams, build_model(get_arch(args.arch).reduced()).jax_layout,
        "cpu"), on_build=built.append)
    capsys.readouterr()
    assert got == want
    assert row["sample_output"] == want[0][:8]
    assert json.loads(jrow)["sample_output"] == want[0][:8]
    (runner,) = built
    assert runner.trace_count == 1 and runner.max_new == 9
    assert row["kernel_launches"] == {k: 0 for k in ops.KERNELS}


def test_runner_builds_once_and_checks_its_wave():
    cfg, model, params = _model()
    with pytest.raises(ValueError, match="cannot hold"):
        DecodeRunner(model, params, batch=2, prompt_len=8, cache_len=12,
                     max_new=5, device="cpu")
    with pytest.raises(ValueError, match="cannot hold"):
        DecodeRunner(model, params, batch=2, prompt_len=0, cache_len=12,
                     max_new=5, device="cpu")
    runner = DecodeRunner(model, params, batch=2, prompt_len=4, cache_len=9,
                          max_new=5, device="cpu")
    assert runner.trace_count == 0
    runner.build()
    runner.build()
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 4)))
    first = runner.wave(prompts)
    assert runner.wave(prompts) == first              # a wave is a wave
    assert runner.trace_count == 1
    assert int(runner.cursor) == 9                    # P + max_new steps
    assert [len(t) for t in first] == [5, 5]
