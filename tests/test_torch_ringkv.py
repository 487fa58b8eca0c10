"""The ``ringkv`` lever of the port against the JAX package's, on the
CPU: a sliding-window layer's decode cache as a ring of ``window`` rows,
written at ``cache_len % window`` and attended over ``min(cache_len + 1,
window)`` rows (the port through ``flash_decode``'s plain version).

Every case holds the port against the JAX package under the same lever,
from the JAX package's init carried over with ``bridge``: fp32 logits at
1e-5 (``tests/test_torch_decode.py``'s decode parity), greedy tokens
equal. Ring on is also held against ring off at the JAX test's 2e-3
(``tests/test_perf_levers.py``): the two sum the same window in another
order.
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
from repro.runtime.flags import feature_scope as jfeature_scope  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime.flags import feature_scope  # noqa: E402
from repro_torch.runtime.steps import DecodeRunner  # noqa: E402

PARITY = 1e-5            # fp32 decode, port against the JAX package
RING_VS_FULL = 2e-3      # ring on against ring off (the JAX test's)


def _pair(arch, **kw):
    """(JAX model, port model) of ``arch``'s reduced config with ``kw``."""
    return (jbuild(dataclasses.replace(jget_arch(arch).reduced(), **kw)),
            build_model(dataclasses.replace(get_arch(arch).reduced(), **kw)))


def _jax_decode(jm, jparams, tokens, cache_len, ring, cache=None, start=0):
    """The JAX package's decode_fn (jitted under the lever) over
    ``tokens`` (B, T) from position ``start``: (logits (B, T, V), cache)."""
    with jfeature_scope(ringkv=ring):
        step = jax.jit(lambda p, b: jm.decode_fn(p, b))
        if cache is None:
            cache = jm.init_cache(tokens.shape[0], cache_len)
        outs = []
        for t in range(tokens.shape[1]):
            logits, cache = step(jparams, {
                "tokens": jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                "cache": cache, "cache_len": jnp.int32(start + t)})
            outs.append(np.asarray(logits))
    return np.concatenate(outs, axis=1), cache


def _port_decode(tm, params, tokens, cache_len, ring, cache=None, start=0):
    """The port's decode_fn under the lever, int positions."""
    with feature_scope(ringkv=ring), torch.no_grad():
        if cache is None:
            cache = tm.init_cache(tokens.shape[0], cache_len, device="cpu")
        outs = []
        for t in range(tokens.shape[1]):
            logits, cache = tm.decode_fn(params, {
                "tokens": torch.from_numpy(tokens[:, t:t + 1]),
                "cache": cache, "cache_len": start + t})
            outs.append(logits.numpy())
    return np.concatenate(outs, axis=1), cache


def test_ring_matches_jax_across_the_wrap():
    """The JAX test's case: the reduced mixtral at window 16, 24 steps
    into a cache of 64 (8 past the wrap). The port's ring holds the JAX
    ring at every step, its cache the JAX ring cache; ring on against
    ring off at 2e-3."""
    jm, tm = _pair("mixtral-8x22b", sliding_window=16)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = bridge.lm_params_from_jax(jparams, tm.jax_layout, "cpu")
    tokens = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (1, 24))
    want, jcache = _jax_decode(jm, jparams, tokens, 64, True)
    got, cache = _port_decode(tm, params, tokens, 64, True)
    assert [e["k"].shape[1] for e in cache["layers"]] == [16, 16]
    np.testing.assert_allclose(got, want, rtol=PARITY, atol=PARITY)
    for path, w in bridge.flatten_tree(jcache).items():
        g = bridge.flatten_tree(bridge.lm_cache_to_jax(cache,
                                                       tm.jax_layout))[path]
        np.testing.assert_allclose(g, np.asarray(w), rtol=PARITY,
                                   atol=PARITY, err_msg=str(path))
    full, cache = _port_decode(tm, params, tokens, 64, False)
    assert [e["k"].shape[1] for e in cache["layers"]] == [64, 64]
    np.testing.assert_allclose(got, full, rtol=RING_VS_FULL,
                               atol=RING_VS_FULL)


@pytest.mark.parametrize("arch,kw", [
    ("mixtral-8x22b", dict(sliding_window=16, num_layers=4)),     # JAX scan
    ("llama4-maverick-400b-a17b", dict(sliding_window=16, num_layers=4)),
    ("zamba2-1.2b", dict(sliding_window=16)),
    ("starcoder2-15b", {}),
    ("tinyllama-1.1b", {})])
@pytest.mark.parametrize("seq_len", [8, 64])
def test_init_cache_shapes_match_jax(arch, kw, seq_len):
    """``init_cache`` under the lever against the JAX ``init_cache``
    carried through the bridge, leaf by leaf: a windowed application gets
    ``min(seq_len, window)`` rows, the reduced maverick's fourth layer
    (global) and a model without a window ``seq_len``."""
    jm, tm = _pair(arch, **kw)
    with jfeature_scope(ringkv=True):
        jcache = jm.init_cache(2, seq_len)
    with feature_scope(ringkv=True):
        cache = tm.init_cache(2, seq_len, device="cpu")
        rows = tm.cache_rows(seq_len)
    back = bridge.lm_cache_from_jax(jcache, tm.jax_layout, "cpu")
    assert [p for p, _ in bridge.tree_leaves(back)] == [
        p for p, _ in bridge.tree_leaves(cache)]
    for (path, a), (_, b) in zip(bridge.tree_leaves(back),
                                 bridge.tree_leaves(cache)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    windows = [w for _, w in tm.specs]
    assert rows == [None if r is None else
                    (min(seq_len, w) if w else seq_len)
                    for r, w in zip(rows, windows)]
    if arch.startswith("llama4"):
        assert windows == [16, 16, 16, 0]
        assert [e["k"].shape[1] for e in cache["layers"]] == [
            min(seq_len, 16)] * 3 + [seq_len]


def _jax_greedy(jm, jparams, prompts, max_new, cache_len, ring):
    """The JAX launcher's loop: the prompt teacher-forced, then
    ``max_new`` argmax tokens, all slots in lockstep."""
    with jfeature_scope(ringkv=ring):
        step = jax.jit(lambda p, b: jm.decode_fn(p, b))
        cache = jm.init_cache(prompts.shape[0], cache_len)
        P = prompts.shape[1]
        for t in range(P):
            logits, cache = step(jparams, {
                "tokens": jnp.asarray(prompts[:, t:t + 1], jnp.int32),
                "cache": cache, "cache_len": jnp.int32(t)})
        outs = []
        for t in range(max_new):
            nxt = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
            outs.append(np.asarray(nxt))
            logits, cache = step(jparams, {
                "tokens": nxt[:, None], "cache": cache,
                "cache_len": jnp.int32(P + t)})
    return np.stack(outs, axis=1).tolist()


@pytest.mark.parametrize("ring", [True, False])
def test_runner_tensor_cursor_across_the_wrap(ring):
    """``DecodeRunner`` (an int32 cursor on the device, the write index
    and the attended length computed from it) on the reduced starcoder2
    at window 16: prompt 20, 12 new, so the ring wraps in the prompt and
    again while decoding. Its greedy tokens equal the JAX decode loop's
    under the same lever; the runner records the lever it built its
    cache under and refuses a cache of another route."""
    jm, tm = _pair("starcoder2-15b", sliding_window=16)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = bridge.lm_params_from_jax(jparams, tm.jax_layout, "cpu")
    prompts = np.random.default_rng(2).integers(0, tm.cfg.vocab_size,
                                                (2, 20))
    with feature_scope(ringkv=ring):
        runner = DecodeRunner(tm, params, batch=2, prompt_len=20,
                              cache_len=32, max_new=12, device="cpu")
    assert runner.ring is ring
    assert runner.chosen.shape == (2, 32) and runner.prompts.shape == (2, 20)
    rows = 16 if ring else 32
    assert [e["k"].shape[1] for e in runner.cache["layers"]] == [rows] * 2
    logits = []
    with feature_scope(ringkv=not ring):      # the recorded route holds
        got = runner.wave(torch.from_numpy(prompts), on_logits=logits.append)
    assert got == _jax_greedy(jm, jparams, prompts, 12, 32, ring)
    assert runner.trace_count == 1
    want, _ = _jax_decode(jm, jparams, np.concatenate(
        [prompts, np.asarray(got)], axis=1), 32, ring)
    np.testing.assert_allclose(torch.cat(logits, dim=1).numpy(), want,
                               rtol=PARITY, atol=PARITY)
    with feature_scope(ringkv=not ring):
        runner.cache = tm.init_cache(2, 32, device="cpu")
    with pytest.raises(ValueError, match="do not match the route"):
        runner.wave(torch.from_numpy(prompts))


def test_runner_needs_the_logical_length():
    """The ring has fewer rows than the steps; the check stays the
    logical ``prompt_len + max_new <= cache_len``."""
    tm = build_model(dataclasses.replace(get_arch("starcoder2-15b").reduced(),
                                         sliding_window=16))
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    with feature_scope(ringkv=True), pytest.raises(ValueError,
                                                   match="cannot hold"):
        DecodeRunner(tm, params, batch=1, prompt_len=20, cache_len=24,
                     max_new=8, device="cpu")


def test_jax_ring_cache_carried_over_continues():
    """A JAX ring cache after 20 steps of the reduced mixtral at 4 layers
    (the JAX scan layout, (G, B, window, Kv, hd)) carried over with
    ``lm_cache_from_jax``: the port continues from it equal to the JAX
    package for 8 more steps, past a second wrap."""
    jm, tm = _pair("mixtral-8x22b", sliding_window=16, num_layers=4)
    assert tm.jax_layout == 1
    jparams = jm.init(jax.random.PRNGKey(3))
    params = bridge.lm_params_from_jax(jparams, tm.jax_layout, "cpu")
    tokens = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, (2, 28))
    _, jcache = _jax_decode(jm, jparams, tokens[:, :20], 64, True)
    assert jcache["layers"][0]["k"].shape == (4, 2, 16, 4, 64)
    cache = bridge.lm_cache_from_jax(jcache, tm.jax_layout, "cpu")
    want, _ = _jax_decode(jm, jparams, tokens[:, 20:], 64, True, jcache, 20)
    got, _ = _port_decode(tm, params, tokens[:, 20:], 64, True, cache, 20)
    np.testing.assert_allclose(got, want, rtol=PARITY, atol=PARITY)


def test_serve_launchers_under_the_env_lever(capsys, monkeypatch):
    """Both ``serve --mode decode`` launchers under ``REPRO_OPT_RINGKV=1``
    on the reduced mixtral (window 64), 60 + 16 tokens in a cache of 128:
    the same row and tokens; the port's runner kept a ring of 64 rows."""
    monkeypatch.setenv("REPRO_OPT_RINGKV", "1")
    argv = ["--arch", "mixtral-8x22b", "--reduced", "--prompt-len", "60",
            "--max-new", "16", "--cache-len", "128", "--requests", "2"]
    jargs = jserve.parse_args(argv)
    jserve.run_decode(jargs)
    want = json.loads(capsys.readouterr().out)
    init = jbuild(jget_arch(jargs.arch).reduced()).init(
        jax.random.PRNGKey(jargs.seed))
    model = build_model(get_arch(jargs.arch).reduced())
    built = []
    args = serve.parse_args(["--mode", "decode", *argv, "--device", "cpu"])
    row, outputs = serve.run_decode(
        args, params=bridge.lm_params_from_jax(init, model.jax_layout, "cpu"),
        on_build=built.append)
    capsys.readouterr()
    (runner,) = built
    assert runner.ring and [e["k"].shape[1] for e in
                            runner.cache["layers"]] == [64, 64]
    for key in ("arch", "requests", "tokens_generated", "sample_output"):
        assert row[key] == want[key], key
    assert len(outputs) == 2 and all(len(o) == 16 for o in outputs)
    assert row["kernel_launches"] == {k: 0 for k in ops.KERNELS}
