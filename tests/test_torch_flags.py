"""The port's ``runtime/flags.py`` and the single-device routes it
switches, held against the JAX package under the same flags on the CPU
(the port's counterpart of ``tests/test_perf_levers.py``).

Inputs are NumPy arrays from a seed; the JAX package's init is carried
over with ``bridge``. fp32 at 1e-5, bf16 at 4 bf16 steps (rtol 2^-6) of
the largest entry; a lever on is also held against it off at the JAX
test's 2e-4 (4 bf16 steps in bf16). Gradients at
``tests/test_torch_dense_train.py``'s 1e-4 of a leaf's largest entry,
the MoE block at ``tests/test_torch_moe.py``'s 1e-5.
"""
import contextlib
import dataclasses
import io
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.engine import streaming_sgd as jstreaming_sgd  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.runtime import flags as jflags  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.engine import streaming_sgd  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime import flags  # noqa: E402

BF16_RTOL = 2 ** -6                           # 4 bf16 steps
LEVER_VS_BASE = 2e-4                          # tests/test_perf_levers.py's


def _np(a):
    return np.asarray(a, dtype=np.float32)


@contextlib.contextmanager
def both(probe=False, **kw):
    """The same flags in both packages."""
    with jflags.feature_scope(**kw), jflags.probe_scope(probe), \
            flags.feature_scope(**kw), flags.probe_scope(probe):
        yield


# -- the flags API -----------------------------------------------------------

def test_the_same_seven_features():
    assert flags._FEATURES == jflags._FEATURES
    assert len(flags._FEATURES) == 7


def test_scopes_nest_and_restore(monkeypatch):
    for name in flags._FEATURES:
        monkeypatch.delenv(f"REPRO_OPT_{name.upper()}", raising=False)
    monkeypatch.delenv("REPRO_PROBE", raising=False)
    assert not flags.probe_mode() and not flags.feature("banded")
    with flags.feature_scope(banded=True):
        assert flags.feature("banded") and not flags.feature("ringkv")
        with flags.feature_scope(ringkv=True, banded=False):
            assert flags.feature("ringkv") and not flags.feature("banded")
        assert flags.feature("banded") and not flags.feature("ringkv")
        with flags.probe_scope():
            assert flags.probe_mode()
            with flags.probe_scope(False):
                assert not flags.probe_mode()
            assert flags.probe_mode()
    assert not flags.probe_mode() and not flags.feature("banded")


def test_environment_is_read(monkeypatch):
    monkeypatch.setenv("REPRO_OPT_RINGKV", "1")
    monkeypatch.setenv("REPRO_PROBE", "1")
    assert flags.feature("ringkv") and flags.probe_mode()
    assert jflags.feature("ringkv") and jflags.probe_mode()
    with flags.feature_scope(ringkv=False), flags.probe_scope(False):
        assert not flags.feature("ringkv") and not flags.probe_mode()
    monkeypatch.setenv("REPRO_OPT_RINGKV", "0")
    assert not flags.feature("ringkv")


def test_state_is_per_thread():
    """``set_features_from_env_string`` sets the calling thread's flags
    (every feature on or off), as a scope does; another thread keeps its
    own (run in threads of their own, so the test's thread is left as it
    was)."""
    seen = {}

    def setter():
        flags.set_features_from_env_string(" gqa_flat, moe2d ,")
        seen["set"] = {f: flags.feature(f) for f in flags._FEATURES}

    def other():
        with flags.feature_scope(ringkv=True):
            seen["other"] = flags.feature("ringkv"), flags.feature("moe2d")

    for fn in (setter, other):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert seen["set"] == {f: f in ("gqa_flat", "moe2d")
                           for f in flags._FEATURES}
    assert seen["other"] == (True, False)


@pytest.mark.parametrize("call", [
    lambda: flags.feature("nope"),
    lambda: flags.feature_scope(nope=True).__enter__(),
    lambda: flags.set_features_from_env_string("banded,nope")])
def test_unknown_names_are_refused(call):
    with pytest.raises(ValueError, match="unknown feature"):
        call()


# -- attention under each lever ----------------------------------------------

@pytest.fixture(scope="module")
def qkv():
    """The JAX test's shapes: (B, S, H, Kv, hd) = (2, 64, 8, 2, 32)."""
    r = np.random.default_rng(0)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((2, 64, 8, 32), (2, 64, 2, 32), (2, 64, 2, 32))]


LEVERS = {"banded": (dict(banded=True), False),
          "gqa_flat": (dict(gqa_flat=True), False),
          "seqpar": (dict(seqpar=True), False),
          "gqa_flat+banded": (dict(gqa_flat=True, banded=True), False),
          "probe": ({}, True),
          "banded+probe": (dict(banded=True), True)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lever", list(LEVERS))
def test_flash_attention_levers_match_jax(qkv, lever, dtype):
    """The JAX function takes each lever's route; the port takes
    ``_banded_attention`` under ``banded`` and its default route under
    the others, which compute the same on one device (bit for bit the
    port's output under ``banded`` alone, or under no lever)."""
    kw, probe = LEVERS[lever]
    jin = [jnp.asarray(a, jnp.dtype(dtype)) for a in qkv]
    tin = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in qkv]
    args = dict(causal=True, window=16, q_block=16, kv_block=16)
    with both(probe, **kw):
        want = _np(jattn.flash_attention(*jin, **args))
        got = tattn.flash_attention(*tin, **args).float().numpy()
    with flags.feature_scope(banded=kw.get("banded", False)):
        alone = tattn.flash_attention(*tin, **args).float().numpy()
    np.testing.assert_array_equal(got, alone)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(want).max())
    base = tattn.flash_attention(*tin, **args).float().numpy()
    tol = LEVER_VS_BASE if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(got, base, rtol=tol,
                               atol=tol * max(1.0, np.abs(base).max()))


@pytest.mark.parametrize("lever", ["gqa_flat", "seqpar", "probe"])
def test_full_causal_levers_match_jax(qkv, lever):
    """No window: the JAX package's ``gqa_flat``, ``seqpar`` and probe
    routes on plain causal attention against the port's default route
    (``banded`` takes only a window)."""
    kw, probe = LEVERS[lever]
    args = dict(causal=True, q_block=16, kv_block=16)
    with both(probe, **kw):
        want = _np(jattn.flash_attention(*map(jnp.asarray, qkv), **args))
        got = tattn.flash_attention(*map(torch.from_numpy, qkv), **args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_banded_takes_only_the_band(qkv, monkeypatch):
    """Under ``banded`` a window shorter than the keys goes to
    ``_banded_attention``; a window as long as the keys does not."""
    calls = []
    real = tattn._banded_attention
    monkeypatch.setattr(tattn, "_banded_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q, k, v = map(torch.from_numpy, qkv)
    with flags.feature_scope(banded=True):
        tattn.flash_attention(q, k, v, causal=True, window=16, q_block=16)
        tattn.flash_attention(q, k, v, causal=True, window=64, q_block=16)
        tattn.flash_attention(q, k, v, causal=False, window=16, q_block=16)
    assert len(calls) == 1


def _lm_batch(vocab, shape, seed):
    r = np.random.default_rng(seed)
    tok = r.integers(0, vocab, shape).astype(np.int32)
    lab = np.concatenate([tok[..., 1:], np.full(shape[:-1] + (1,), -1,
                                                np.int32)], axis=-1)
    return {"tokens": tok, "labels": lab}


def _pair(arch, **kw):
    return (jbuild(dataclasses.replace(jget_arch(arch).reduced(), **kw)),
            build_model(dataclasses.replace(get_arch(arch).reduced(), **kw)))


def test_banded_gradient_matches_jax():
    """The reduced starcoder2 at window 16 and 64 tokens under
    ``banded``: the loss at 1e-5 and every gradient leaf within 1e-4 of
    its largest entry against ``jax.grad`` under the same lever."""
    jm, tm = _pair("starcoder2-15b", sliding_window=16)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = _lm_batch(tm.cfg.vocab_size, (2, 64), 1)
    with both(banded=True):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss_fn(p, b)))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        leaves = {k: v.requires_grad_() for k, v in bridge.flatten_tree(
            bridge.lm_params_from_jax(jparams, tm.jax_layout,
                                      "cpu")).items()}
        loss = tm.loss_fn(bridge.unflatten_tree(leaves),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    got = bridge.flatten_tree(bridge.lm_params_to_jax(
        bridge.unflatten_tree(grads), tm.jax_layout))
    want = bridge.flatten_tree(jax.tree.map(_np, jgrads))
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(),
                                   err_msg=str(path))


# -- the MoE levers ----------------------------------------------------------

@pytest.mark.parametrize("lever", ["moelocal", "moe2d"])
def test_moe_levers_match_jax(lever):
    """With no mesh the JAX block runs ``moelocal`` as one group and
    ``moe2d`` only places shards: the port's block under either equals
    the JAX block under it (1e-5), and itself with the lever off."""
    d, f, E = 16, 32, 4
    r = np.random.default_rng(1)
    p = {"router": r.standard_normal((d, E)).astype(np.float32) / 4,
         "w_gate": r.standard_normal((E, d, f)).astype(np.float32) / 4,
         "w_up": r.standard_normal((E, d, f)).astype(np.float32) / 4,
         "w_down": r.standard_normal((E, f, d)).astype(np.float32) / 6}
    x = r.standard_normal((2, 8, d)).astype(np.float32)
    tp = bridge.params_from_numpy(p, "cpu")
    with both(**{lever: True}):
        jy, jaux = jmoe.moe_block(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), experts_per_token=2)
        ty, taux = tmoe.moe_block(tp, torch.from_numpy(x),
                                  experts_per_token=2)
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    assert abs(taux.item() - float(jaux)) <= 1e-5 * abs(float(jaux))
    by, baux = tmoe.moe_block(tp, torch.from_numpy(x), experts_per_token=2)
    assert torch.equal(ty, by) and torch.equal(taux, baux)


# -- probe mode --------------------------------------------------------------

def test_probe_mode_unstacks_the_layout():
    """A homogeneous model of four or more periods is stacked by the JAX
    package, and not in probe mode: ``jax_layout`` goes to None there,
    and the JAX init's layout with it."""
    jm, tm = _pair("tinyllama-1.1b", num_layers=4)
    assert tm.jax_layout == 1 and tm.use_scan
    with both(probe=True):
        assert tm.jax_layout is None and not tm.use_scan
        jparams = jm.init(jax.random.PRNGKey(0))
    assert isinstance(jparams["layers"], list) and len(
        jparams["layers"]) == 4
    _, hm = _pair("zamba2-1.2b")
    with both(probe=True):
        assert hm.jax_layout == bridge.HybridLayout(2)


@pytest.mark.parametrize("arch,kw", [
    ("starcoder2-15b", dict(num_layers=4, sliding_window=16)),
    ("mamba2-130m", {})])
def test_probe_loss_and_step_match_jax(arch, kw):
    """Under probe mode in both packages (the JAX init and params in the
    per-layer layout): the loss at 1e-5 (the JAX package's cross
    entropy in one chunk, the port's in its chunks), and
    ``streaming_sgd`` (the JAX package's unrolled inner loop, the port's
    loop) over 2 microbatches at 1e-4."""
    jm, tm = _pair(arch, **kw)
    batch = _lm_batch(tm.cfg.vocab_size, (2, 2, 48), 2)
    with both(probe=True):
        jparams = jm.init(jax.random.PRNGKey(0))
        params = bridge.lm_params_from_jax(jparams, tm.jax_layout, "cpu")
        first = {k: v[0] for k, v in batch.items()}
        jloss = float(jax.jit(lambda p, b: jm.loss_fn(p, b))(
            jparams, {k: jnp.asarray(v) for k, v in first.items()}))
        with torch.no_grad():
            loss = tm.loss_fn(params, {k: torch.from_numpy(v)
                                       for k, v in first.items()}).item()
        jphi, jlosses = jax.jit(lambda p, b: jstreaming_sgd(
            jm.loss_fn, p, b, 0.05))(
                jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        phi, losses = streaming_sgd(
            tm.loss_fn, params, {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, 0.05)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    np.testing.assert_allclose(losses.numpy(), _np(jlosses), rtol=1e-5)
    got = bridge.flatten_tree(bridge.lm_params_to_jax(phi, None))
    for path, w in bridge.flatten_tree(jax.tree.map(_np, jphi)).items():
        np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=1e-4,
                                   err_msg=str(path))


def test_lm_launcher_under_probe_matches_the_jax_launcher(monkeypatch):
    """Both LM launchers under ``REPRO_PROBE=1`` (the JAX package's
    verify path), the reduced tinyllama for 2 rounds from the JAX init:
    every row's keys, client, alpha and comm_mb exact, the losses within
    1e-4."""
    from repro.launch import train as jtrain
    monkeypatch.setenv("REPRO_PROBE", "1")
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--rounds", "2",
            "--seq", "32", "--batch", "4", "--k-inner", "2"]
    init = jbuild(jget_arch("tinyllama-1.1b").reduced()).init(
        jax.random.PRNGKey(0))
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.main()
    want = [json.loads(line) for line in out.getvalue().splitlines()]
    with contextlib.redirect_stdout(io.StringIO()):
        rows, _, _ = train.run_lm(train.parse_args(argv + ["--device",
                                                           "cpu"]),
                                  init_params=init)
    assert len(rows) == len(want) == 2
    for got, w in zip(rows, want):
        assert set(got) == set(w)
        for k in ("round", "client", "alpha", "comm_mb"):
            assert got[k] == w[k], k
        for k in ("loss", "inner_first", "inner_last"):
            assert abs(got[k] - w[k]) <= 1e-4, k
