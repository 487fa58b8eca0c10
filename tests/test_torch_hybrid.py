"""The port's hybrid family (zamba2-1.2b) and the dense glm4-9b and
minicpm-2b against the JAX package's, on the CPU.

zamba2 runs a weight-shared attention block before each group of
``hybrid_attn_every`` Mamba2 layers and once more before the tail. The
reduced config has one group of 2 and no tail; at 5 layers it has two
groups and a tail of 1, so the shared block runs 3 times, each with a
KV cache of its own. The JAX package stacks the hybrid's groups whatever
its depth; the port keeps one dict per layer and one cache entry per
application, and ``bridge.HybridLayout`` maps the two. For each config:
``loss_fn``, gradients, ``prefill_fn``, decode steps, one
``make_meta_train_step`` round and the bridge's round trip of params and
caches (``tests/test_torch_moe.py``'s checks and tolerances); then the
hybrid's layouts, the shared block's applications, the decode runner's
waves from a zero state, and both launchers against the JAX ones.
"""
import contextlib
import dataclasses
import io
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime.steps import DecodeRunner  # noqa: E402

from test_torch_moe import (LmCase, check_decode_and_round_trips,  # noqa: E402
                            check_gradients, check_loss_and_prefill,
                            check_meta_round)

#: name -> (arch, overrides of .reduced(), sequence length)
CASES = {
    "zamba2_2l": ("zamba2-1.2b", {}, 16),
    "zamba2_5l": ("zamba2-1.2b", {"num_layers": 5}, 16),
    "glm4": ("glm4-9b", {}, 16),
    "minicpm": ("minicpm-2b", {}, 16),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return LmCase(*CASES[request.param])


def test_loss_and_prefill_match_jax(case):
    check_loss_and_prefill(case)


def test_every_gradient_matches_jax(case):
    check_gradients(case)


def test_meta_train_step_matches_jax(case):
    check_meta_round(case)


def test_decode_and_round_trips_match_jax(case):
    check_decode_and_round_trips(case)


def _zamba2(layers):
    return build_model(dataclasses.replace(get_arch("zamba2-1.2b").reduced(),
                                           num_layers=layers))


@pytest.mark.parametrize("layers,groups,tail", [(2, 1, 0), (5, 2, 1),
                                                (4, 2, 0)])
def test_hybrid_layouts(layers, groups, tail):
    """The port's params: ``shared_block`` and one dict per Mamba2 layer;
    its cache: one entry per application (an attention entry opening each
    group and the tail). Both cross to the JAX layout (k stacks of the
    groups, ``tail``; ``group_attn``, ``group_mamba``, ``tail_attn``,
    ``tail_mamba``) and back unchanged."""
    tm = _zamba2(layers)
    jm = jbuild(dataclasses.replace(jget_arch("zamba2-1.2b").reduced(),
                                    num_layers=layers))
    assert tm.jax_layout == bridge.HybridLayout(2) and not tm.use_scan
    shapes = tm.param_shapes()
    assert len(shapes["layers"]) == layers and "shared_block" in shapes
    kinds = [k for k, _ in tm.specs]
    assert kinds.count("shared_attn") == groups + (1 if tail else 0)
    cache = tm.init_cache(2, 8, device="cpu")
    assert [set(e) for e in cache["layers"]] == [
        {"k", "v"} if k == "shared_attn" else {"conv", "ssm"} for k in kinds]
    jcache = jm.init_cache(2, 8)
    assert set(jcache) == ({"group_attn", "group_mamba"}
                           | ({"tail_attn", "tail_mamba"} if tail else set()))
    to_jax = bridge.lm_cache_to_jax(cache, tm.jax_layout)
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), jcache)
    got = jax.tree.map(lambda a: (a.shape, a.dtype.name), to_jax)
    assert bridge.flatten_tree(got) == bridge.flatten_tree(want)
    back = bridge.lm_cache_from_jax(to_jax, tm.jax_layout, "cpu")
    assert [(p, t.shape) for p, t in bridge.tree_leaves(back)] == [
        (p, t.shape) for p, t in bridge.tree_leaves(cache)]
    params = tm.init(torch.Generator().manual_seed(layers), "cpu")
    jparams = bridge.lm_params_to_jax(params, tm.jax_layout)
    assert len(jparams["layers"]) == 2 and len(jparams["tail"]) == tail
    want = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        jm.init, jax.random.PRNGKey(0)))
    assert bridge.flatten_tree(jax.tree.map(np.shape, jparams)) == \
        bridge.flatten_tree(want)
    again = bridge.lm_params_from_jax(jparams, tm.jax_layout, "cpu")
    for (pa, a), (pb, b) in zip(bridge.tree_leaves(again),
                                bridge.tree_leaves(params)):
        assert pa == pb and torch.equal(a, b)


def test_shared_block_runs_before_each_group_and_the_tail(monkeypatch):
    """At 5 layers the shared attention runs 3 times a forward, and again
    in the backward (recomputed, as the JAX package's checkpointed scan
    recomputes its groups)."""
    calls = []
    real = tattn.attention_block

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*a, **kw)
    monkeypatch.setattr(tattn, "attention_block", counted)
    tm = _zamba2(5)
    leaves = {k: v.requires_grad_() for k, v in bridge.flatten_tree(
        tm.init(torch.Generator().manual_seed(0), "cpu")).items()}
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 16)))
    loss = tm.loss_fn(bridge.unflatten_tree(leaves),
                      {"tokens": tok, "labels": tok})
    assert len(calls) == 3
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert len(calls) == 6
    shared = [g for k, g in zip(leaves, grads) if k[0] == "shared_block"]
    assert shared and all(g.abs().sum() > 0 for g in shared)


def test_decode_runner_zeroes_every_mamba2_state():
    """A hybrid wave after another starts from a zero Mamba2 state in
    every layer: the same prompts give the same tokens and logits as in
    the first wave."""
    tm = _zamba2(5)
    params = tm.init(torch.Generator().manual_seed(1), "cpu")
    runner = DecodeRunner(tm, params, batch=2, prompt_len=4, cache_len=10,
                          max_new=6, device="cpu")
    assert len(runner._recurrent) == 2 * 5
    prompts, other = (torch.from_numpy(np.random.default_rng(s).integers(
        0, tm.cfg.vocab_size, (2, 4))) for s in (3, 4))
    first, again = [], []
    tokens = runner.wave(prompts, on_logits=first.append)
    runner.wave(other)
    assert runner.wave(prompts, on_logits=again.append) == tokens
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert runner.trace_count == 1


def test_serve_launcher_matches_jax_run_decode(capsys):
    """``serve --mode decode --arch zamba2-1.2b --reduced`` against the
    JAX launcher's row, from the JAX package's init carried over: the same
    greedy tokens and count, no kernel on the CPU."""
    argv = ["--arch", "zamba2-1.2b", "--reduced"]
    jargs = jserve.parse_args(argv)
    jserve.run_decode(jargs)
    want = json.loads(capsys.readouterr().out)
    init = jbuild(jget_arch(jargs.arch).reduced()).init(
        jax.random.PRNGKey(jargs.seed))
    args = serve.parse_args(["--mode", "decode", *argv, "--device", "cpu"])
    row, outputs = serve.run_decode(args, params=bridge.lm_params_from_jax(
        init, _zamba2(2).jax_layout, "cpu"))
    capsys.readouterr()
    for key in ("arch", "requests", "tokens_generated", "sample_output"):
        assert row[key] == want[key], key
    assert len(outputs) == 6 and all(len(o) == 8 for o in outputs)
    assert row["kernel_launches"] == {k: 0 for k in ops.KERNELS}


def test_lm_launcher_rows_match_the_jax_launcher(monkeypatch):
    """2 rounds of the tinyreptile LM launcher on the reduced zamba2 from
    the JAX init (in its hybrid layout): every row's keys and client,
    alpha and comm_mb exact; the losses within 1e-4."""
    from repro.launch import train as jtrain
    argv = ["--arch", "zamba2-1.2b", "--reduced", "--rounds", "2", "--seq",
            "16", "--batch", "4", "--k-inner", "2"]
    init = jbuild(jget_arch("zamba2-1.2b").reduced()).init(
        jax.random.PRNGKey(0))
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


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "glm4-9b", "minicpm-2b"])
def test_launchers_take_the_hybrid_and_dense_configs(arch):
    assert train.parse_args(["--arch", arch]).arch in ALL_ARCHS
    assert arch in serve.decode_archs()
    assert serve.parse_args(["--arch", arch]).mode == "decode"
