"""The port's dense LM train and prefill path against the JAX package's,
on the CPU: ``flash_attention`` (the blockwise online softmax) and
``attention_block``, then the reduced tinyllama's and starcoder2's
``loss_fn``, gradients, ``prefill_fn``, one ``make_meta_train_step``
round, and the LM launcher's rows.

The JAX package's init (``jax.random``) is carried over with
``bridge.lm_params_from_jax``, and every input is a seeded NumPy array.
The reduced configs run at 2 layers and at 4, where the JAX package
stacks the layers (``use_scan``) and recomputes each layer's forward in
the backward, as the port does (``torch.utils.checkpoint``). starcoder2
runs at 96 tokens, past its window of 64, so the window masks.
Tolerances: fp32 loss, logits and attention at rtol 1e-5; gradients
within 1e-4 of each leaf's largest entry; one round at 1e-4; bf16 at 4
bf16 steps (rtol 2^-6), the loss at 1e-3 relative, as
``tests/test_torch_lm.py`` holds the SSM family.
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
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.runtime.steps import make_meta_train_step as jmeta_step  # noqa: E402
from repro.runtime.steps import make_prefill_step as jprefill_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime.steps import (make_meta_train_step,  # noqa: E402
                                       make_prefill_step)

BETA, ALPHA = 0.02, 0.7
BF16_RTOL = 2 ** -6                           # 4 bf16 steps


def _np(a):
    return np.asarray(a, np.float32)


# -- attention ---------------------------------------------------------------

def _qkv(seed, B, Sq, Kv, R, hd):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, Sq, Kv * R, hd)).astype(np.float32),
            r.standard_normal((B, Sq, Kv, hd)).astype(np.float32),
            r.standard_normal((B, Sq, Kv, hd)).astype(np.float32))


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("Sq", [1, 7, 64, 600])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (True, 64),
                                           (False, 0), (False, 16)])
def test_flash_attention_matches_jax(causal, window, Sq, R):
    """Self-attention at 1e-5: one token, a ragged block, one block, and
    600 tokens (two q and two KV blocks of 512, the second padded), MHA
    and GQA, with and without the causal mask and a sliding window."""
    q, k, v = _qkv(Sq * 10 + R, 2, Sq, 2, R, 16)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, window=window)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0), (False, 100)])
def test_flash_attention_explicit_positions(causal, window):
    """Positions passed in, as ``attention_block`` passes them: shifted
    positions against the JAX package at 1e-5."""
    Sq = 600
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, Sq, 2, 2, 16))
    shifted = np.arange(Sq, dtype=np.int32) + 37
    want = jattn.flash_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=causal, window=window,
        q_positions=jnp.asarray(shifted), kv_positions=jnp.asarray(shifted))
    pos = torch.from_numpy(shifted)
    got = tattn.flash_attention(q, k, v, causal=causal, window=window,
                                q_positions=pos, kv_positions=pos)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_flash_attention_bf16_matches_jax():
    """bf16 operands: the scale and the scores' products as the JAX
    package rounds them, accumulated in fp32; within 4 bf16 steps."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(4, 2, 600, 2, 4,
                                                          16))
    want = _np(jattn.flash_attention(q, k, v, causal=True, window=64))
    tq, tk, tv = (torch.from_numpy(_np(a)).to(torch.bfloat16)
                  for a in (q, k, v))
    got = tattn.flash_attention(tq, tk, tv, causal=True, window=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(want).max())


@pytest.mark.parametrize("window", [0, 24])
def test_attention_block_matches_jax(window):
    """Projections, RoPE, the attention and the output projection, GQA
    (8 heads over 2 KV heads), at 1e-5."""
    d, H, Kv, hd, S = 64, 8, 2, 16, 80
    r = np.random.default_rng(window)
    params = {n: (r.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
              for n, s in (("wq", (d, H, hd)), ("wk", (d, Kv, hd)),
                           ("wv", (d, Kv, hd)), ("wo", (H, hd, d)))}
    x = r.standard_normal((2, S, d)).astype(np.float32)
    want = jattn.attention_block(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        num_kv_heads=Kv, rope_theta=10000.0, window=window)
    got = tattn.attention_block(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), num_kv_heads=Kv, rope_theta=10000.0,
        window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_init_attention_shapes():
    p = tattn.init_attention(torch.Generator().manual_seed(0), 32, 4, 2, 8,
                             torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        k: (s, d) for k, (s, d) in tattn.attention_shapes(
            32, 4, 2, 8, torch.bfloat16).items()}


# -- the model ---------------------------------------------------------------

def _batch(vocab, shape, seed):
    r = np.random.default_rng(seed)
    tok = r.integers(0, vocab, shape).astype(np.int32)
    lab = np.concatenate([tok[..., 1:], np.full(shape[:-1] + (1,), -1,
                                                np.int32)], axis=-1)
    return {"tokens": tok, "labels": lab}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


#: name -> (arch, layers, dtype, sequence length)
CASES = {"tinyllama": ("tinyllama-1.1b", 2, "float32", 40),
         "tinyllama_scan": ("tinyllama-1.1b", 4, "float32", 40),
         "starcoder2_window": ("starcoder2-15b", 2, "float32", 96),
         "tinyllama_bf16": ("tinyllama-1.1b", 2, "bfloat16", 40)}


class _Case:
    """One config: the JAX model, its init and results, computed once;
    the port's model and the init carried over."""

    def __init__(self, name):
        arch, layers, dtype, S = CASES[name]
        kw = dict(num_layers=layers, dtype=dtype)
        jcfg = dataclasses.replace(jget_arch(arch).reduced(), **kw)
        self.jm = jbuild(jcfg)
        self.tm = build_model(dataclasses.replace(get_arch(arch).reduced(),
                                                  **kw))
        self.phi = self.jm.init(jax.random.PRNGKey(0))
        self.batch = _batch(jcfg.vocab_size, (2, S), 1)
        self.meta_batch = _batch(jcfg.vocab_size, (2, 2, S), 2)
        loss, grads = jax.jit(jax.value_and_grad(self.jm.loss_fn))(
            self.phi, _jb(self.batch))
        logits = jax.jit(jprefill_step(self.jm))(self.phi, _jb(self.batch))
        new_phi, metrics = jax.jit(jmeta_step(self.jm, beta=BETA))(
            self.phi, _jb(self.meta_batch), jnp.float32(ALPHA))
        self.want = dict(
            loss=float(loss), logits=_np(logits),
            grads=bridge.flatten_tree(jax.tree.map(_np, grads)),
            new_phi=bridge.flatten_tree(jax.tree.map(_np, new_phi)),
            metrics={k: float(v) for k, v in metrics.items()})

    def port_params(self):
        return bridge.lm_params_from_jax(self.phi, self.tm.jax_layout,
                                         "cpu")


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _Case(request.param)


def _close(got, want, bf16, rtol=1e-5):
    if bf16:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def test_loss_and_prefill_match_jax(case):
    bf16 = case.tm.cfg.dtype == "bfloat16"
    params = case.port_params()
    with torch.no_grad():
        loss = case.tm.loss_fn(params, _tb(case.batch))
    logits = make_prefill_step(case.tm)(params, _tb(case.batch))
    want = case.want
    tol = 1e-3 * abs(want["loss"]) if bf16 else 1e-5 * abs(want["loss"])
    assert abs(float(loss) - want["loss"]) <= tol
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 1, case.tm.cfg.vocab_size)
    _close(logits.numpy(), want["logits"], bf16)


def test_every_gradient_matches_jax(case, monkeypatch):
    """Each leaf's gradient within 1e-4 of its largest entry (4 bf16
    steps in bf16). At 4 layers each attention block's forward runs
    again in the backward (the JAX package's per-group recompute), at 2
    only once."""
    calls = []
    real = tattn.attention_block

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*a, **kw)
    monkeypatch.setattr(tattn, "attention_block", counted)
    bf16 = case.tm.cfg.dtype == "bfloat16"
    leaves = {k: v.requires_grad_()
              for k, v in bridge.flatten_tree(case.port_params()).items()}
    loss = case.tm.loss_fn(bridge.unflatten_tree(leaves), _tb(case.batch))
    n_fwd = len(calls)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    layers = case.tm.cfg.num_layers
    assert n_fwd == layers
    assert len(calls) == (2 * layers if case.tm.use_scan else layers)
    got = bridge.flatten_tree(bridge.lm_params_to_jax(
        bridge.unflatten_tree(grads), case.tm.jax_layout))
    want = case.want["grads"]
    assert set(got) == set(want)
    for path, g in want.items():
        top = float(np.abs(g).max())
        tol = BF16_RTOL * top if bf16 else 1e-4 * top
        np.testing.assert_allclose(got[path], g, rtol=0, atol=tol,
                                   err_msg=str(path))


def test_meta_train_step_matches_jax(case):
    """One TinyReptile round (K = 2 streaming SGD steps, then the
    interpolation); each leaf back in its own dtype."""
    bf16 = case.tm.cfg.dtype == "bfloat16"
    step = make_meta_train_step(case.tm, beta=BETA)
    new_phi, metrics = step(case.port_params(), _tb(case.meta_batch), ALPHA)
    for path, leaf in bridge.tree_leaves(new_phi):
        assert leaf.dtype == (torch.bfloat16 if bf16 else torch.float32)
    for k, v in case.want["metrics"].items():
        assert abs(float(metrics[k]) - v) <= (1e-3 * abs(v) if bf16
                                              else 1e-4), k
    got = bridge.flatten_tree(bridge.lm_params_to_jax(new_phi,
                                                      case.tm.jax_layout))
    for path, p in case.want["new_phi"].items():
        if bf16:
            np.testing.assert_allclose(got[path], p, rtol=BF16_RTOL,
                                       atol=2 ** -8, err_msg=str(path))
        else:
            np.testing.assert_allclose(got[path], p, rtol=1e-4, atol=1e-4,
                                       err_msg=str(path))


# -- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["transformer", "starcoder2-15b"])
def test_lm_launcher_rows_match_the_jax_launcher(arch, monkeypatch):
    """3 rounds of both launchers from the JAX package's init: every
    row's keys and client, alpha and comm_mb exact; the losses within
    1e-4. starcoder2 runs at 96 tokens, past its window of 64."""
    from repro.launch import train as jtrain
    seq = "96" if arch == "starcoder2-15b" else "32"
    argv = ["--arch", arch, "--reduced", "--rounds", "3", "--seq", seq,
            "--batch", "4", "--k-inner", "2"]
    args = train.parse_args(argv + ["--device", "cpu"])
    jcfg = jget_arch(args.arch).reduced()
    init = jbuild(jcfg).init(jax.random.PRNGKey(0))
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.main()
    want = [json.loads(line) for line in out.getvalue().splitlines()]
    with contextlib.redirect_stdout(io.StringIO()):
        rows, summary, _ = train.run_lm(args, init_params=init)
    assert len(rows) == len(want) == 3
    for got, w in zip(rows, want):
        assert set(got) == set(w)
        for k in ("round", "client", "alpha", "comm_mb"):
            assert got[k] == w[k], k
        for k in ("loss", "inner_first", "inner_last"):
            assert abs(got[k] - w[k]) <= 1e-4, k
    assert summary["arch"] == jcfg.name and summary["device"] == "cpu"
    assert summary["kernel_launches"] == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("arch,name", [("tinyllama-1.1b", "tinyllama-1.1b"),
                                       ("transformer", "tinyllama-1.1b"),
                                       ("starcoder2-15b", "starcoder2-15b")])
def test_lm_launcher_takes_the_dense_family(arch, name):
    args = train.parse_args(["--arch", arch])
    assert args.arch == name and name in ALL_ARCHS
