"""The port's inner loops and evaluation protocol against the JAX
package's ``core/meta.py``.

The port runs a COHORT of models as one flat buffer; each of its rows is
held to one JAX call on that model, within 1e-5 (fp32 sums in another
order)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import SINE_MLP as J_SINE  # noqa: E402
from repro.core import meta as jmeta  # noqa: E402
from repro.data import SineTasks as JSine  # noqa: E402
from repro.models.paper_nets import init_paper_model as j_init  # noqa: E402
from repro.models.paper_nets import paper_model_loss as j_loss  # noqa: E402
from repro_torch.bridge import FlatLayout  # noqa: E402
from repro_torch.configs.paper_models import SINE_MLP  # noqa: E402
from repro_torch.core import meta as tmeta  # noqa: E402
from repro_torch.data import SineTasks  # noqa: E402
from repro_torch.models.paper_nets import paper_model_loss  # noqa: E402

JLOSS = functools.partial(j_loss, J_SINE)
TLOSS = functools.partial(paper_model_loss, SINE_MLP)
TOL = 1e-5
C, S = 3, 7


@pytest.fixture(scope="module")
def case():
    """C different models (one init, perturbed per client) and C support
    streams of S sine samples, as NumPy."""
    rng = np.random.default_rng(0)
    base = {k: np.asarray(v)
            for k, v in j_init(J_SINE, jax.random.PRNGKey(0)).items()}
    models = [{k: (v + 0.05 * i * rng.normal(size=v.shape)).astype(np.float32)
               for k, v in base.items()} for i in range(C)]
    xs = rng.uniform(-5, 5, (C, S, 1)).astype(np.float32)
    ys = (rng.uniform(0.1, 5, (C, 1, 1)) * np.sin(xs)).astype(np.float32)
    return models, xs, ys


def _cohort(models):
    trees = {k: torch.from_numpy(np.stack([m[k] for m in models]))
             for k in models[0]}
    layout = FlatLayout.of(trees, batch_dims=1)
    return layout, layout.pack(trees, batch_dims=1)


def _check_rows(layout, flat, losses, want_params, want_losses):
    got = layout.views(flat)
    for c, (wp, wl) in enumerate(zip(want_params, want_losses)):
        for k, v in wp.items():
            np.testing.assert_allclose(got[k][c].numpy(), np.asarray(v),
                                       rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(losses[c].numpy(), np.asarray(wl),
                                   rtol=TOL, atol=TOL)


def test_finetune_online_matches_jax(case):
    models, xs, ys = case
    layout, flat = _cohort(models)
    flat, losses = tmeta.finetune_online(TLOSS, layout, flat,
                                         torch.from_numpy(xs),
                                         torch.from_numpy(ys), 0.02)
    assert losses.shape == (C, S)
    want = [jmeta.finetune_online(JLOSS, m, jnp.asarray(x), jnp.asarray(y),
                                  jnp.float32(0.02))
            for m, x, y in zip(models, xs, ys)]
    _check_rows(layout, flat, losses, [w[0] for w in want],
                [w[1] for w in want])


def test_finetune_batch_matches_jax(case):
    models, xs, ys = case
    layout, flat = _cohort(models)
    batch = {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)}
    flat, losses = tmeta.finetune_batch(TLOSS, layout, flat, batch, 5, 0.02)
    assert losses.shape == (C, 5)
    want = [jmeta.finetune_batch(JLOSS, m, {"x": jnp.asarray(x),
                                            "y": jnp.asarray(y)}, 5,
                                 jnp.float32(0.02))
            for m, x, y in zip(models, xs, ys)]
    _check_rows(layout, flat, losses, [w[0] for w in want],
                [w[1] for w in want])


@pytest.mark.parametrize("form", ["online", "batch"])
def test_masked_forms_match_jax(case, form):
    """Per-client budgets 0 (every step dead), partial, and full."""
    models, xs, ys = case
    k = np.array([0, 3, S if form == "online" else 5], np.int32)
    layout, flat = _cohort(models)
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
    if form == "online":
        flat2, losses = tmeta.finetune_online_masked(
            TLOSS, layout, flat, tx, ty, 0.02, torch.from_numpy(k))
        want = [jmeta.finetune_online_masked(
            JLOSS, m, jnp.asarray(x), jnp.asarray(y), jnp.float32(0.02),
            jnp.int32(kc)) for m, x, y, kc in zip(models, xs, ys, k)]
    else:
        flat2, losses = tmeta.finetune_batch_masked(
            TLOSS, layout, flat, {"x": tx, "y": ty}, 5, 0.02,
            torch.from_numpy(k))
        want = [jmeta.finetune_batch_masked(
            JLOSS, m, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, 5,
            jnp.float32(0.02), jnp.int32(kc))
            for m, x, y, kc in zip(models, xs, ys, k)]
    _check_rows(layout, flat2, losses, [w[0] for w in want],
                [w[1] for w in want])
    # a client with no live step passes through exactly, with loss 0
    assert torch.equal(flat2[0], flat[0])
    assert not losses[0].any()


@pytest.mark.parametrize("kw", [
    dict(num_tasks=4, support=8, k_steps=4, lr=0.02, query=16),
    dict(num_tasks=3, support=0, query=9),
    dict(),
])
def test_evaluate_init_matches_jax(case, kw):
    model = case[0][1]
    want = jmeta.evaluate_init(JLOSS, model, JSine(),
                               np.random.default_rng(10_007), **kw)
    got = tmeta.evaluate_init(TLOSS, {k: torch.from_numpy(v)
                                      for k, v in model.items()},
                              SineTasks(), np.random.default_rng(10_007),
                              **kw)
    assert set(got) == {"query_loss"}
    np.testing.assert_allclose(got["query_loss"], want["query_loss"],
                               rtol=TOL, atol=TOL)


def test_tree_helpers_match_jax(case):
    a, b = case[0][0], case[0][2]
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    assert tmeta.tree_bytes(ta) == jmeta.tree_bytes(a) == 1153 * 4
    for got, want in ((tmeta.tree_lerp(ta, tb, 0.3),
                       jmeta.tree_lerp(a, b, 0.3)),
                      (tmeta.tree_sub(ta, tb), jmeta.tree_sub(a, b)),
                      (tmeta.tree_add_scaled(ta, tb, -0.5),
                       jmeta.tree_add_scaled(a, b, -0.5))):
        for k in a:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6)


def test_flat_layout_round_trips():
    tree = {"w1": torch.arange(6.0).reshape(2, 3), "b0": torch.tensor(7.0),
            "a": torch.arange(4.0)}
    layout = FlatLayout.of(tree)
    assert layout.names == ("a", "b0", "w1")
    assert layout.shapes == ((4,), (), (2, 3))
    flat = layout.pack(tree)
    assert flat.tolist() == [0, 1, 2, 3, 7, 0, 1, 2, 3, 4, 5]
    back = layout.views(flat)
    for k, v in tree.items():
        assert torch.equal(back[k], v)
    cohort = flat.expand(4, -1) * torch.arange(4.0)[:, None]
    assert layout.views(cohort)["w1"].shape == (4, 2, 3)
    assert torch.equal(layout.pack(layout.views(cohort), batch_dims=1),
                       cohort)
