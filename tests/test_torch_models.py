"""The port's sine MLP against the JAX package's, batched over slots."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import SINE_MLP as J_SINE  # noqa: E402
from repro.core.strategies import tifed_requantize as j_requant  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.paper_models import PAPER_MODELS, SINE_MLP  # noqa: E402
from repro_torch.core.strategies import (tifed_dequantize,  # noqa: E402
                                         tifed_requantize)
from repro_torch.models import paper_nets as tnets  # noqa: E402


def _slots(B, seed):
    """B JAX inits (one per key) and the same trees stacked for the port."""
    trees = [jax.tree.map(np.asarray, jnets.init_paper_model(
        J_SINE, jax.random.PRNGKey(seed + b))) for b in range(B)]
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    return trees, params_from_numpy(stacked, "cpu")


def test_configs_are_the_jax_packages():
    from repro.configs.paper_models import PAPER_MODELS as J_MODELS
    assert {k: vars(v) for k, v in PAPER_MODELS.items()} == {
        k: vars(v) for k, v in J_MODELS.items()}


@pytest.mark.parametrize("kind", ["tanh", "relu"])
def test_batched_forward_loss_and_grad_match_jax(kind):
    B, N = 3, 7
    trees, params = _slots(B, 0)
    rng = np.random.default_rng(0)
    x = rng.uniform(-5, 5, (B, N, 1)).astype(np.float32)
    y = rng.normal(size=(B, N, 1)).astype(np.float32)
    if kind == "tanh":
        t_loss = lambda p, b: tnets.paper_model_loss(SINE_MLP, p, b)  # noqa
        j_loss = lambda p, b: jnets.paper_model_loss(J_SINE, p, b)    # noqa
        t_apply = lambda p, xx: tnets.paper_model_apply(SINE_MLP, p, xx)  # noqa
        j_apply = lambda p, xx: jnets.paper_model_apply(J_SINE, p, xx)    # noqa
    else:
        t_loss, j_loss = tnets.relu_mlp_loss, jnets.relu_mlp_loss
        t_apply, j_apply = tnets.relu_mlp_apply, jnets.relu_mlp_apply
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    pred = t_apply(leaves, torch.tensor(x))
    loss = t_loss(leaves, {"x": torch.tensor(x), "y": torch.tensor(y)})
    grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
    assert loss.shape == (B,)
    for b in range(B):
        batch = {"x": jnp.asarray(x[b]), "y": jnp.asarray(y[b])}
        np.testing.assert_allclose(pred[b].detach().numpy(),
                                   np.asarray(j_apply(trees[b], batch["x"])),
                                   rtol=1e-5, atol=1e-5)
        jl, jg = jax.value_and_grad(j_loss)(trees[b], batch)
        np.testing.assert_allclose(loss[b].item(), float(jl), rtol=1e-5)
        for k, g in zip(leaves, grads):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(jg[k]),
                                       rtol=1e-5, atol=1e-5)


def test_init_law_and_param_count():
    g = torch.Generator().manual_seed(0)
    p = tnets.init_paper_model(SINE_MLP, g, "cpu")
    assert tnets.param_count(p) == 1153
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w0": (1, 32), "b0": (32,), "w1": (32, 32), "b1": (32,),
        "w2": (32, 1), "b2": (1,)}
    assert all(not p[f"b{i}"].any() for i in range(3))
    again = tnets.init_paper_model(SINE_MLP, torch.Generator().manual_seed(0),
                                   "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    # He normal: std sqrt(2 / fan_in) for the 32 x 32 layer
    assert abs(float(p["w1"].std()) - (2 / 32) ** 0.5) < 0.03
    # the conv nets are ported too (tests/test_torch_paper_conv.py)
    kws = tnets.init_paper_model(PAPER_MODELS["kws_conv"], g, "cpu")
    assert tnets.param_count(kws) == 20_612


def test_tifed_requantize_matches_jax():
    trees, _ = _slots(1, 5)
    phi = trees[0]
    phi = {**phi, "b1": np.linspace(-0.3, 0.3, 32, dtype=np.float32)}
    want = j_requant({k: jnp.asarray(v) for k, v in phi.items()})
    got = tifed_requantize(params_from_numpy(phi, "cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    q = {"q": {"w": torch.tensor([[3, -4]], dtype=torch.int8)},
         "exp": {"w": torch.tensor(-2, dtype=torch.int32)}}
    np.testing.assert_array_equal(tifed_dequantize(q)["w"].numpy(),
                                  [[0.75, -1.0]])
