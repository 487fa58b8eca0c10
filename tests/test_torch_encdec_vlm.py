"""The port's encoder-decoder (whisper-tiny) and VLM (paligemma-3b)
against the JAX package's, on the CPU.

whisper-tiny runs an encoder over precomputed frame embeddings (the
JAX package's stub frontend: sinusoidal positions, non-causal blocks
without RoPE) and decoder blocks with cross-attention to its output,
sinusoidal positions and no RoPE; its decode cache holds a cross cache
of ``encoder_tokens`` rows per layer. paligemma-3b prepends 256 patch
embeddings through ``vision_proj`` and takes its loss over the text. The
reduced configs (2 layers, d 256, 16 frames or 8 patches, fp32) from
the JAX package's init, carried over with ``bridge.lm_params_from_jax``,
on seeded NumPy inputs: ``loss_fn``, every gradient leaf, ``prefill_fn``
and a decode wave through the port's ``DecodeRunner`` against the JAX
package's greedy ``decode_fn`` loop; a decode step from a random,
non-zero cross cache; the encoder at 600 frames (padded to 1,024 keys);
bf16 weights with fp32 frames, as the launcher makes them (gradients
at rtol and atol 2^-6, as ``tests/test_torch_lm.py`` holds the bf16
LM's); both trees
through the bridge and back (paligemma also in its scan layout); both
launchers against the JAX ones; and the runners of the port's graphs
collected without Python's cyclic collector. Tolerances as for the
other families: fp32 at rtol 1e-5 (and 1e-5 of the largest entry),
gradients within 1e-4 of each leaf's largest entry, bf16 at 4 bf16
steps.
"""
import contextlib
import dataclasses
import functools
import gc
import io
import json
import sys
import weakref

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
from repro_torch.configs import ALL_ARCHS, get_arch  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime.steps import DecodeRunner  # noqa: E402

BF16_RTOL = 2 ** -6                           # 4 bf16 steps
WAVE = dict(batch=2, prompt_len=3, max_new=3)
ARCHS = ("whisper-tiny", "paligemma-3b")


def _np(a):
    return np.asarray(a, np.float32)


def _cfgs(arch, **over):
    return (dataclasses.replace(jget_arch(arch).reduced(), **over),
            dataclasses.replace(get_arch(arch).reduced(), **over))


def _batch(cfg, shape, seed):
    """Tokens and shifted labels, and the frontend's float32 inputs."""
    r = np.random.default_rng(seed)
    tok = r.integers(0, cfg.vocab_size, shape).astype(np.int32)
    out = {"tokens": tok,
           "labels": np.concatenate([tok[:, 1:], np.full(
               (shape[0], 1), -1, np.int32)], axis=1)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = r.standard_normal(
            (shape[0], cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = r.standard_normal(
            (shape[0], cfg.encoder_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, bf16=False):
    tol = BF16_RTOL if bf16 else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


class Case:
    """One reduced config: the JAX model, its init and results, computed
    once; the port's model and the init carried over."""

    def __init__(self, arch, **over):
        jcfg, tcfg = _cfgs(arch, **over)
        self.jm, self.tm = jbuild(jcfg), build_model(tcfg)
        self.bf16 = jcfg.dtype == "bfloat16"
        self.phi = self.jm.init(jax.random.PRNGKey(0))
        self.batch = _batch(jcfg, (2, 12), 1)
        loss, grads = jax.jit(jax.value_and_grad(self.jm.loss_fn))(
            self.phi, _jb(self.batch))
        self.want = dict(
            loss=float(loss),
            grads=bridge.flatten_tree(jax.tree.map(_np, grads)),
            logits=_np(jax.jit(self.jm.prefill_fn)(self.phi,
                                                    _jb(self.batch))))

    def params(self):
        return bridge.lm_params_from_jax(self.phi, self.tm.jax_layout, "cpu")


@functools.lru_cache(maxsize=None)
def fp32_case(arch):
    """The fp32 reduced config's ``Case``, built once per process."""
    return Case(arch)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return fp32_case(request.param)


def test_loss_and_prefill_match_jax(case):
    params = case.params()
    with torch.no_grad():
        loss = case.tm.loss_fn(params, _tb(case.batch))
        logits = case.tm.prefill_fn(params, _tb(case.batch))
    assert abs(float(loss) - case.want["loss"]) <= 1e-5 * abs(
        case.want["loss"])
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 1, case.tm.cfg.vocab_size)
    _close(logits.numpy(), case.want["logits"])


def test_every_gradient_matches_jax(case):
    """Each leaf's gradient, the encoder's, the cross blocks' and
    ``vision_proj``'s included, within 1e-4 of its largest entry."""
    leaves = {k: v.requires_grad_()
              for k, v in bridge.flatten_tree(case.params()).items()}
    loss = case.tm.loss_fn(bridge.unflatten_tree(leaves), _tb(case.batch))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    got = bridge.flatten_tree(bridge.lm_params_to_jax(
        bridge.unflatten_tree(grads), case.tm.jax_layout))
    want = case.want["grads"]
    assert set(got) == set(want)
    names = {k for p in want for k in p}
    if case.tm.is_encdec:
        assert {"encoder", "cross", "norm_x"} <= names
    else:
        assert "vision_proj" in names
    for path, g in want.items():
        top = float(np.abs(g).max())
        assert top > 0, path
        np.testing.assert_allclose(got[path], g, rtol=0, atol=1e-4 * top,
                                   err_msg=str(path))


def _jax_wave(case, prompts, steps, cache=None):
    """The JAX serve loop's greedy wave through ``decode_fn``: every
    step's logits and the new tokens (the JAX launcher never fills the
    cross cache)."""
    decode = jax.jit(case.jm.decode_fn)
    B, P = prompts.shape
    if cache is None:
        cache = case.jm.init_cache(B, WAVE["prompt_len"] + WAVE["max_new"])
    logits, out, nxt = [], [], None
    for t in range(steps):
        tok = prompts[:, t:t + 1] if t < P else nxt[:, None]
        lg, cache = decode(case.phi, {"tokens": jnp.asarray(tok, jnp.int32),
                                      "cache": cache,
                                      "cache_len": jnp.int32(t)})
        logits.append(_np(lg))
        nxt = np.asarray(jnp.argmax(lg[:, 0], axis=-1))
        if t >= P - 1:
            out.append(nxt)
    return logits, np.stack(out[:WAVE["max_new"]], axis=1).tolist(), cache


def test_decode_wave_matches_jax(case):
    """A wave of the port's decode runner (prompts, then greedy tokens;
    the cross cache of zeros held through the build) against the JAX
    package's loop: every step's logits, the tokens."""
    prompts = np.random.default_rng(4).integers(
        0, case.tm.cfg.vocab_size, (WAVE["batch"], WAVE["prompt_len"]))
    steps = WAVE["prompt_len"] + WAVE["max_new"]
    want_logits, want_tokens, _ = _jax_wave(case, prompts, steps)
    runner = DecodeRunner(case.tm, case.params(), cache_len=steps,
                          device="cpu", **WAVE)
    assert ("cross" in runner.cache) == case.tm.is_encdec
    got = []
    tokens = runner.wave(torch.from_numpy(prompts), on_logits=got.append)
    assert tokens == want_tokens
    assert len(got) == steps
    for g, w in zip(got, want_logits):
        _close(g.numpy(), w)
    assert runner.trace_count == 1


def test_decode_with_a_nonzero_cross_cache_matches_jax():
    """whisper's decode steps from a random, non-zero cross cache (the
    cross path held against more than zeros): the logits and the final
    caches, the cross cache carried through the bridge."""
    case = fp32_case("whisper-tiny")
    tm = case.tm
    B, S = 2, 4
    jcache = case.jm.init_cache(B, S)
    r = np.random.default_rng(9)
    jcache["cross"] = [{k: jnp.asarray(r.standard_normal(v.shape).astype(
        np.float32)) for k, v in e.items()} for e in jcache["cross"]]
    cache = bridge.lm_cache_from_jax(jcache, tm.jax_layout, "cpu")
    tokens = r.integers(0, tm.cfg.vocab_size, (B, S))
    decode = jax.jit(case.jm.decode_fn)
    params = case.params()
    for t in range(S):
        lg, jcache = decode(case.phi, {
            "tokens": jnp.asarray(tokens[:, t:t + 1], jnp.int32),
            "cache": jcache, "cache_len": jnp.int32(t)})
        with torch.no_grad():
            got, cache = tm.decode_fn(params, {
                "tokens": torch.from_numpy(tokens[:, t:t + 1]),
                "cache": cache, "cache_len": torch.tensor(
                    [t], dtype=torch.int32)})
        _close(got.numpy(), _np(lg))
    back = bridge.flatten_tree(bridge.lm_cache_to_jax(cache, tm.jax_layout))
    want = bridge.flatten_tree(jax.tree.map(_np, jcache))
    assert set(back) == set(want)
    for path, w in want.items():
        _close(back[path], w)


def test_encoder_pads_600_frames_like_jax():
    """The encoder over 600 frames: its non-causal blocks pad the keys
    to 1,024 (two blocks of 512), the pad masked, as in the JAX package;
    then the loss with those frames."""
    case = fp32_case("whisper-tiny")
    frames = np.random.default_rng(6).standard_normal(
        (2, 600, case.tm.cfg.d_model)).astype(np.float32)
    want = _np(jax.jit(case.jm._encode)(case.phi, jnp.asarray(frames)))
    with torch.no_grad():
        got = case.tm._encode(case.params(), torch.from_numpy(frames))
    assert got.shape == (2, 600, case.tm.cfg.d_model)
    _close(got.numpy(), want)
    batch = dict(case.batch, frames=frames)
    wl = float(jax.jit(case.jm.loss_fn)(case.phi, _jb(batch)))
    with torch.no_grad():
        tl = float(case.tm.loss_fn(case.params(), _tb(batch)))
    assert abs(tl - wl) <= 1e-5 * abs(wl)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_with_fp32_frontend_inputs_matches_jax(arch):
    """bf16 weights with the launcher's float32 frames or patches: the
    encoder promotes to fp32 against the bf16 weights and the patches are
    cast to bf16, in both packages; the loss within 1e-3, the encoder's
    output and the prefill logits within 4 bf16 steps of the largest,
    each gradient leaf at rtol and atol 4 bf16 steps."""
    case = Case(arch, dtype="bfloat16")
    assert case.tm.cfg.dtype == "bfloat16"
    params = case.params()
    assert all(v.dtype == torch.bfloat16
               for _, v in bridge.tree_leaves(params))
    if case.tm.is_encdec:
        with torch.no_grad():
            enc = case.tm._encode(params, torch.from_numpy(
                case.batch["frames"]))
        assert enc.dtype == torch.float32
        _close(enc.numpy(), _np(jax.jit(case.jm._encode)(
            case.phi, jnp.asarray(case.batch["frames"]))), bf16=True)
    leaves = {k: v.requires_grad_()
              for k, v in bridge.flatten_tree(params).items()}
    loss = case.tm.loss_fn(bridge.unflatten_tree(leaves), _tb(case.batch))
    assert abs(loss.item() - case.want["loss"]) <= 1e-3 * abs(
        case.want["loss"])
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    with torch.no_grad():
        logits = case.tm.prefill_fn(params, _tb(case.batch))
    _close(logits.numpy(), case.want["logits"], bf16=True)
    got = bridge.flatten_tree(bridge.lm_params_to_jax(
        bridge.unflatten_tree(grads), case.tm.jax_layout))
    for path, g in case.want["grads"].items():
        assert got[path].dtype == np.float32      # bf16, carried as fp32
        np.testing.assert_allclose(got[path], g, rtol=BF16_RTOL,
                                   atol=BF16_RTOL, err_msg=str(path))


@pytest.mark.parametrize("arch,layers", [("whisper-tiny", 2),
                                         ("paligemma-3b", 2),
                                         ("paligemma-3b", 4)])
def test_bridge_round_trips_both_trees(arch, layers):
    """The JAX package's params and cache (``encoder``, each layer's
    ``cross`` and ``norm_x``, ``vision_proj``, ``cache["cross"]``; at 4
    layers paligemma's scan layout) cross to the port and back exactly,
    and the port's init has the JAX init's tree."""
    jcfg, tcfg = _cfgs(arch, num_layers=layers)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    assert tm.use_scan == jm.use_scan == (layers == 4)
    assert tm.jax_layout == (1 if layers == 4 else None)
    phi = jm.init(jax.random.PRNGKey(layers))
    params = bridge.lm_params_from_jax(phi, tm.jax_layout, "cpu")
    assert len(params["layers"]) == layers
    back = bridge.flatten_tree(bridge.lm_params_to_jax(params,
                                                       tm.jax_layout))
    want = bridge.flatten_tree(jax.tree.map(_np, phi))
    assert set(back) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w, err_msg=str(path))
    mine = bridge.flatten_tree(bridge.lm_params_to_jax(
        tm.init(torch.Generator().manual_seed(0), "cpu"), tm.jax_layout))
    assert {p: v.shape for p, v in mine.items()} == {
        p: v.shape for p, v in want.items()}
    jcache = jm.init_cache(2, 8)
    r = np.random.default_rng(layers)
    jcache = jax.tree.map(lambda a: jnp.asarray(
        r.standard_normal(a.shape).astype(np.float32)), jcache)
    cache = bridge.lm_cache_from_jax(jcache, tm.jax_layout, "cpu")
    mine = tm.init_cache(2, 8, device="cpu")
    assert [(p, t.shape) for p, t in bridge.tree_leaves(cache)] == [
        (p, t.shape) for p, t in bridge.tree_leaves(mine)]
    assert ("cross" in mine) == tm.is_encdec
    back = bridge.flatten_tree(bridge.lm_cache_to_jax(cache, tm.jax_layout))
    want = bridge.flatten_tree(jax.tree.map(_np, jcache))
    assert set(back) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w, err_msg=str(path))


def test_dropped_runners_are_freed_without_the_cyclic_collector():
    """With Python's cyclic collector off, a dropped decode runner (its
    caches with it), an engine runner dropped by ``clear_runner_cache``
    (its programs with it) and a dropped serving tick's server are freed
    with their last reference: no runner and its step refer to each
    other."""
    from functools import partial

    from repro_torch.configs.paper_models import SINE_MLP
    from repro_torch.models.paper_nets import (init_paper_model,
                                               paper_model_loss)
    from repro_torch.serving import AdaptationServer, Fp32Adapter

    tm = build_model(get_arch("whisper-tiny").reduced())
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    collecting = gc.isenabled()
    gc.disable()
    try:
        runner = DecodeRunner(tm, params, batch=2, prompt_len=2,
                              cache_len=4, max_new=2, device="cpu")
        runner.wave(torch.zeros(2, 2, dtype=torch.int64))
        refs = [weakref.ref(runner), weakref.ref(runner.cache["cross"][0][
            "k"]), weakref.ref(runner.step)]
        del runner
        assert [r() for r in refs] == [None] * 3

        engine.clear_runner_cache()
        with contextlib.redirect_stdout(io.StringIO()):
            train.run_engine_strategy(train.parse_args(
                ["--strategy", "reptile", "--rounds", "2", "--clients", "4",
                 "--device", "cpu"]))
        runners = list(engine._RUNNER_CACHE._entries.values())
        assert len(runners) == 1 and runners[0]._programs
        refs = [weakref.ref(runners[0])] + [
            weakref.ref(p) for p in runners[0]._programs.values()]
        del runners
        engine.clear_runner_cache()
        assert [r() for r in refs] == [None] * len(refs)

        phi = init_paper_model(SINE_MLP, torch.Generator().manual_seed(0),
                               "cpu")
        server = AdaptationServer(
            phi, Fp32Adapter(loss_fn=partial(paper_model_loss, SINE_MLP)),
            slots=4, k_max=2, device="cpu")
        ref = weakref.ref(server)
        del server
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_launcher_rows_match_the_jax_launcher(arch, monkeypatch):
    """2 rounds of the tinyreptile LM launcher from the JAX init: the
    random ``frames`` or ``patch_embeds`` drawn from the launcher's rng in
    the JAX launcher's order, so every row's client, alpha and comm_mb
    are exact and the losses within 1e-4."""
    from repro.launch import train as jtrain
    argv = ["--arch", arch, "--reduced", "--rounds", "2", "--seq", "16",
            "--batch", "4", "--k-inner", "2"]
    init = jbuild(jget_arch(arch).reduced()).init(jax.random.PRNGKey(0))
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.main()
    want = [json.loads(line) for line in out.getvalue().splitlines()]
    with contextlib.redirect_stdout(io.StringIO()):
        rows, _, _ = train.run_lm(
            train.parse_args(argv + ["--device", "cpu"]), init_params=init)
    assert len(rows) == len(want) == 2
    for got, w in zip(rows, want):
        assert set(got) == set(w)
        for k in ("round", "client", "alpha", "comm_mb"):
            assert got[k] == w[k], k
        for k in ("loss", "inner_first", "inner_last"):
            assert abs(got[k] - w[k]) <= 1e-4, k


def test_serve_launcher_matches_jax_run_decode(capsys):
    """``serve --mode decode --arch whisper-tiny --reduced`` against the
    JAX launcher's row, from the JAX package's init: the same greedy
    tokens and count, no kernel on the CPU."""
    argv = ["--arch", "whisper-tiny", "--reduced", "--requests", "2"]
    jargs = jserve.parse_args(argv)
    jserve.run_decode(jargs)
    want = json.loads(capsys.readouterr().out)
    init = jbuild(jget_arch(jargs.arch).reduced()).init(
        jax.random.PRNGKey(jargs.seed))
    args = serve.parse_args(["--mode", "decode", *argv, "--device", "cpu"])
    row, outputs = serve.run_decode(args, params=bridge.lm_params_from_jax(
        init, None, "cpu"))
    capsys.readouterr()
    for key in ("arch", "requests", "tokens_generated", "sample_output"):
        assert row[key] == want[key], key
    assert len(outputs) == 2 and all(len(o) == 8 for o in outputs)
    assert row["kernel_launches"] == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_take_the_encdec_and_vlm_configs(arch):
    assert train.parse_args(["--arch", arch]).arch in ALL_ARCHS
    assert arch in serve.decode_archs()
    assert serve.parse_args(["--arch", arch]).mode == "decode"
