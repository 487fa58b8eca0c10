"""The engine's LM route: ``run_federated`` over the reduced LM families'
nested parameter trees, held against the JAX engine on the CPU.

Both packages start from the JAX package's init (``Model.init`` at
``PRNGKey(0)``, carried across as NumPy; the reduced configs keep one
dict per layer in both) and the same seed, on ``LmTaskDistribution``
tasks with the cohort ``lm_loss``. Every run is 2 rounds of 2 clients on
support sets of 2 sequences of 16 tokens, with one eval at the end. The
final params are held within 1e-5 of the JAX engine's, leaf by leaf in
the init's structure, the history's losses within 1e-5 relative, the
bytes exactly. This file holds Reptile and TinyReptile on both families;
``test_torch_lm_fleet.py`` the other strategies, the partial wire and
the pooled route.

Reptile runs the launcher's 8 epochs on the dense family. On the reduced
mamba2, 8 epochs of full-batch SGD on one client's two sequences
amplify last-bit differences: one ulp added to every init weight moves
the port's own 2-round run by 3.4e-6 to 8.4e-5 (seeds 3, 5, 11), the
same order as the port's distance from the JAX engine (1.3e-6 to
3.2e-4), and the JAX package's own two scan routes part as far. So the
mamba2 Reptile case runs 2 epochs at 1e-5, and the 8-epoch run is held
to that sensitivity, measured in the test (ROADMAP, "Known gaps").
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data import LmTaskDistribution as JDist  # noqa: E402
from repro.data import lm_loss as jlm_loss  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import LmTaskDistribution, lm_loss  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

SEQ = 16
TOL = 1e-5
EVAL = dict(num_tasks=2, support=4, k_steps=4, lr=0.01, query=8)
RUN = dict(rounds=2, clients_per_round=2, support=2, alpha=1.0, beta=0.02,
           eval_every=2, eval_kwargs=EVAL)


class Family:
    """One reduced family on both packages, from the JAX init."""

    def __init__(self, arch):
        self.jm = jbuild(jget_arch(arch).reduced())
        self.tm = build_model(get_arch(arch).reduced())
        self.init = jax.tree.map(np.asarray, self.jm.init(
            jax.random.PRNGKey(0)))
        self.vocab = self.tm.cfg.vocab_size

    def dists(self):
        return JDist(self.vocab, SEQ), LmTaskDistribution(self.vocab, SEQ)

    def run(self, strategy, skw=None, jkw=None, tkw=None, **kw):
        """``strategy`` (a name of ``core``'s strategies, built with
        ``skw``) on both packages, ``jkw`` and ``tkw`` going to one side
        only; returns (jax out, port out)."""
        jd, td = self.dists()
        run = {**RUN, **kw}
        jout = jcore.run_federated(
            self.init, jd, getattr(jcore, strategy)(jlm_loss(self.jm),
                                                    **(skw or {})),
            **run, **(jkw or {}))
        tout = tcore.run_federated(
            self.init, td, getattr(tcore, strategy)(lm_loss(self.tm),
                                                    **(skw or {})),
            device="cpu", **run, **(tkw or {}))
        return jout, tout


@pytest.fixture(scope="module")
def mamba2():
    return Family("mamba2-130m")


@pytest.fixture(scope="module")
def tinyllama():
    return Family("tinyllama-1.1b")


def assert_same_lm_run(got, want, tol=TOL):
    """Params in the init's structure within ``tol``; history floats
    within ``tol`` relative, its ints and keys exact; bytes exact."""
    want_leaves = bridge.flatten_tree(jax.tree.map(np.asarray,
                                                   want["params"]))
    got_leaves = bridge.flatten_tree(got["params"])
    assert list(got_leaves) == sorted(want_leaves)
    assert isinstance(got["params"]["layers"], list)
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol,
                                   err_msg=str(path))
    for key in ("comm_bytes", "per_client_bytes"):
        assert got.get(key) == want.get(key), key
    assert len(got["history"]) == len(want["history"])
    for ge, we in zip(got["history"], want["history"]):
        assert set(ge) == set(we)
        for k, v in we.items():
            if isinstance(v, (int, np.integer)):
                assert ge[k] == v, k
            else:
                np.testing.assert_allclose(ge[k], v, rtol=tol, err_msg=k)


@pytest.mark.parametrize("family,strategy,skw", [
    ("mamba2", "ReptileStrategy", dict(epochs=2)),
    ("mamba2", "TinyReptileStrategy", {}),
    ("tinyllama", "ReptileStrategy", dict(epochs=8)),
    ("tinyllama", "TinyReptileStrategy", {}),
])
def test_reptile_strategies_match_jax(family, strategy, skw, request):
    fam = request.getfixturevalue(family)
    jout, tout = fam.run(strategy, skw, seed=3)
    assert_same_lm_run(tout, jout)
    # the bill: 2 rounds x 2 clients x (down + up) x every fp32 param
    params = sum(v.size for _, v in bridge.tree_leaves(fam.init))
    assert tout["comm_bytes"] == 2 * 2 * 2 * 4 * params
    assert "inner_loss" in tout["history"][-1]


def _max_gap(a, b):
    fa = bridge.flatten_tree(jax.tree.map(np.asarray, a))
    return max(float(np.abs(np.asarray(v, np.float32) - fa[k]).max())
               for k, v in bridge.flatten_tree(jax.tree.map(
                   np.asarray, b)).items())


def test_mamba2_reptile_at_eight_epochs_is_as_close_as_rounding(mamba2):
    """The launcher's 8 epochs on the reduced mamba2: the port's distance
    from the JAX engine is within 10x of how far one ulp on the init
    moves the port's own run (measured 0.6x to 4.4x over three seeds),
    and the eval within 1e-3."""
    jout, tout = mamba2.run("ReptileStrategy", dict(epochs=8), seed=5)
    ulp = jax.tree.map(
        lambda a: np.nextafter(a, np.float32(np.inf)).astype(np.float32),
        mamba2.init)
    _, td = mamba2.dists()
    moved = tcore.run_federated(ulp, td, tcore.ReptileStrategy(
        lm_loss(mamba2.tm), epochs=8), device="cpu", seed=5, **RUN)
    port = jax.tree.map(lambda t: t.numpy(), tout["params"])
    sensitivity = _max_gap(port, jax.tree.map(lambda t: t.numpy(),
                                              moved["params"]))
    gap = _max_gap(port, jout["params"])
    assert 0 < sensitivity < 1e-3
    assert gap <= 10 * sensitivity, (gap, sensitivity)
    np.testing.assert_allclose(tout["history"][-1]["query_loss"],
                               jout["history"][-1]["query_loss"], rtol=1e-3)
    assert tout["comm_bytes"] == jout["comm_bytes"]


def test_engine_keeps_int32_token_blocks(mamba2):
    """The staged blocks, the runner's buffers and the loss see int32
    tokens; the eval sees the init's nested structure."""
    from repro_torch.core import engine

    seen = []

    def loss(params, batch):
        seen.append((type(params["layers"]), batch["x"].dtype,
                     batch["y"].dtype))
        return lm_loss(mamba2.tm)(params, batch)

    engine.clear_runner_cache()
    _, td = mamba2.dists()
    tcore.run_federated(mamba2.init, td, tcore.ReptileStrategy(loss, epochs=2),
                        device="cpu", seed=1, **RUN)
    assert seen and all(s == (list, torch.int32, torch.int32) for s in seen)
    (runner,) = engine._RUNNER_CACHE._entries.values()
    assert runner.trace_count == 1
    (prog,) = runner._programs.values()
    assert {t.dtype for t in prog.batch.values()} == {torch.int32}
    assert prog.layout.nested
