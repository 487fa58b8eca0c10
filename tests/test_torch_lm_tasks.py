"""The port's LM client tasks (``data/lm.py``: ``LmTaskDistribution``)
and its cohort ``lm_loss``, held against the JAX package's on the CPU.

Every draw is equal bit for bit: the tasks ``sample_task`` draws and
their samples, ``sample_support_block`` with and without a
participation mask, the reference block loop, ``sample_client_support``
(the vectorized pool's check-in) and ``materialize_client``, over
several seeds. The cohort loss gives each client the JAX ``lm_loss`` of
its own params and batch within 1e-5, and each client's gradient from
``cohort_grad`` the JAX gradient within 1e-4, for both families, on the
reduced fp32 configs from the JAX init.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data import LmTaskDistribution as JDist  # noqa: E402
from repro.data import lm_loss as jlm_loss  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.meta import cohort_grad  # noqa: E402
from repro_torch.data import LmTaskDistribution, lm_loss  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

SEEDS = (0, 1, 7, 123)
VOCAB, SEQ = 512, 16
ARCHS = ("mamba2-130m", "tinyllama-1.1b")


def _dists(vocab=VOCAB, seq=SEQ, domains=4096):
    return JDist(vocab, seq, domains), LmTaskDistribution(vocab, seq, domains)


def _equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == np.int32, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_task_streams_match_jax(seed):
    jd, td = _dists()
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        jt, tt = jd.sample_task(jr), td.sample_task(tr)
        assert tt.task_id == jt.task_id
        _equal(tt.support_batch(tr, 3), jt.support_batch(jr, 3))
        xs = list(tt.support_stream(tr, 2))
        for (gx, gy), (wx, wy) in zip(xs, jt.support_stream(jr, 2)):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    assert tr.bit_generator.state == jr.bit_generator.state


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("masked", [False, True])
def test_support_blocks_match_jax(seed, masked):
    jd, td = _dists(domains=64)          # repeated domains within a block
    part = None
    if masked:
        part = np.random.default_rng(seed + 100).random((3, 4)) < 0.6
        part[:, 0] = True
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jd.sample_support_block(jr, 3, 4, 5, participation=part)
    got = td.sample_support_block(tr, 3, 4, 5, participation=part)
    _equal(got, want)
    assert got["x"].shape == (3, 4, 5, SEQ)
    live = np.ones((3, 4), bool) if part is None else part
    assert (got["y"][live][..., -1] == -1).all()
    np.testing.assert_array_equal(got["y"][..., :-1], got["x"][..., 1:])
    assert not got["x"][~live].any()
    # the reference loop (the engine's default sampler)
    sub = live[:2, :3]
    _equal(td.sample_support_block_reference(tr, 2, 3, 4, "stream", sub),
           jd.sample_support_block_reference(jr, 2, 3, 4, "stream", sub))
    assert tr.bit_generator.state == jr.bit_generator.state


@pytest.mark.parametrize("seed", SEEDS)
def test_client_support_and_materialize_match_jax(seed):
    jd, td = _dists()
    for i, k in ((0, 0), (5, 3), (4095, 1)):
        def rngs():
            return (np.random.default_rng([seed, 0x9E37, i]),
                    np.random.default_rng([seed, 1, i, k]))
        gx, gy = td.sample_client_support(*rngs(), 6)
        wx, wy = jd.sample_client_support(*rngs(), 6)
        _equal({"x": gx, "y": gy}, {"x": wx, "y": wy})
        assert gx.shape == (6, SEQ)
        jt, tt = jd.materialize_client(i, seed), td.materialize_client(i, seed)
        assert tt.task_id == jt.task_id
        r1, r2 = np.random.default_rng(k), np.random.default_rng(k)
        _equal(tt.support_batch(r1, 2), jt.support_batch(r2, 2))


def _models(arch):
    jcfg, tcfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    assert dataclasses.asdict(jcfg)["dtype"] == "float32"
    return jbuild(jcfg), build_model(tcfg)


def _cohort_params(jm, clients):
    """C JAX inits (one seed each), and the port's cohort tree: every
    leaf stacked over a leading C axis."""
    inits = [jm.init(jax.random.PRNGKey(s)) for s in range(clients)]
    flat = [bridge.flatten_tree(jax.tree.map(np.asarray, p)) for p in inits]
    stacked = bridge.unflatten_tree({
        k: torch.from_numpy(np.stack([f[k] for f in flat]))
        for k in flat[0]})
    return inits, stacked


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("stream", [False, True])
def test_cohort_lm_loss_matches_jax_per_client(arch, stream):
    jm, tm = _models(arch)
    clients, support = 3, 1 if stream else 2
    inits, cohort = _cohort_params(jm, clients)
    block = LmTaskDistribution(tm.cfg.vocab_size, SEQ).sample_support_block(
        np.random.default_rng(5), 1, clients, support)
    batch = {k: torch.from_numpy(v[0]) for k, v in block.items()}
    got = lm_loss(tm)(cohort, batch)
    assert got.shape == (clients,) and got.dtype == torch.float32
    jloss = jax.jit(jlm_loss(jm))
    for c in range(clients):
        want = float(jloss(inits[c], {k: jnp.asarray(v[0, c])
                                      for k, v in block.items()}))
        np.testing.assert_allclose(float(got[c]), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_cohort_gradients_are_each_clients_own(arch):
    jm, tm = _models(arch)
    clients = 2
    inits, cohort = _cohort_params(jm, clients)
    block = LmTaskDistribution(tm.cfg.vocab_size, SEQ).sample_support_block(
        np.random.default_rng(9), 1, clients, 2)
    batch = {k: torch.from_numpy(v[0]) for k, v in block.items()}
    layout = bridge.FlatLayout.of_tree(bridge.index_tree(cohort, 0))
    assert layout.nested
    flat = layout.pack(layout.named(cohort), batch_dims=1)
    loss, g = cohort_grad(lm_loss(tm), layout, flat, batch)
    grads = layout.views(g)
    jgrad = jax.jit(jax.grad(jlm_loss(jm)))
    for c in range(clients):
        want = bridge.flatten_tree(jax.tree.map(np.asarray, jgrad(
            inits[c], {k: jnp.asarray(v[0, c]) for k, v in block.items()})))
        assert set(want) == set(layout.names)
        for path, w in want.items():
            np.testing.assert_allclose(grads[path][c].numpy(), w, rtol=1e-4,
                                       atol=1e-5, err_msg=str(path))
