"""mamba2-130m's gradient at its canonical widths (d_model 768, 24
heads of 64, state 128, one 256-position chunk, vocab 50,280), fp32,
with the depth cut: the port's against the JAX package's on the CPU,
from the JAX init, on one client's 2 sequences of 64 tokens.

The test holds every leaf within 1e-4 of that leaf's largest entry at 2
layers. Run as a script, the file measures how the rounding grows with
depth, in both packages::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_rounding.py \\
        --layers 12

It prints, per leaf, the port's distance from the JAX gradient and how
far one ulp added to every init weight moves each package's own
gradient (each as a share of the leaf's largest entry); then the loss
over 8 steps of full-batch SGD at the engine's inner rates (0.002 and
0.02) in each package, from the init and from it moved one ulp.
"""
import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data import lm_loss as jlm_loss  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import LmTaskDistribution, lm_loss  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

SEQ, SUPPORT = 64, 2


class Witness:
    """mamba2-130m at ``layers`` layers in both packages, the JAX init
    in the port's layout (NumPy), and one client's batch."""

    def __init__(self, layers):
        cut = dict(num_layers=layers, dtype="float32")
        self.jm = jbuild(dataclasses.replace(jget_arch("mamba2-130m"), **cut))
        self.tm = build_model(dataclasses.replace(get_arch("mamba2-130m"),
                                                  **cut))
        self.period = self.tm.jax_layout
        self.init = bridge.flatten_tree(bridge.lm_params_to_jax(
            bridge.lm_params_from_jax(self.jm.init(jax.random.PRNGKey(0)),
                                      self.period, "cpu")))
        block = LmTaskDistribution(self.tm.cfg.vocab_size, SEQ) \
            .sample_support_block(np.random.default_rng(1), 1, 1, SUPPORT)
        self.batch = {k: v[0, 0] for k, v in block.items()}
        self._jgrad = jax.jit(jax.value_and_grad(jlm_loss(self.jm)))

    def jax_grad(self, flat):
        """The JAX package's loss and gradient, as ``{path: array}``."""
        tree = bridge.lm_params_to_jax(bridge.lm_params_from_jax(
            bridge.unflatten_tree(flat), None, "cpu"), self.period)
        loss, g = self._jgrad(tree, {k: jnp.asarray(v)
                                     for k, v in self.batch.items()})
        g = bridge.lm_params_from_jax(g, self.period, "cpu")
        return float(loss), {k: v.numpy()
                             for k, v in bridge.flatten_tree(g).items()}

    def port_grad(self, flat):
        """The port's loss and gradient: the cohort ``lm_loss`` of a
        cohort of one client."""
        leaves = {k: torch.from_numpy(np.array(v)).requires_grad_()
                  for k, v in flat.items()}
        loss = lm_loss(self.tm)(
            bridge.unflatten_tree({k: v[None] for k, v in leaves.items()}),
            {k: torch.from_numpy(v)[None] for k, v in self.batch.items()})[0]
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), {k: g.numpy()
                                      for k, g in zip(leaves, grads)}


def ulp_up(flat):
    return {k: np.nextafter(v, np.float32(np.inf)).astype(np.float32)
            for k, v in flat.items()}


def leaf_gaps(got, want):
    """``{path: max |got - want| / max |want|}``."""
    return {k: float(np.abs(got[k] - w).max() / np.abs(w).max())
            for k, w in want.items()}


def sgd_losses(grad, flat, lr, steps=8):
    losses = []
    for _ in range(steps):
        loss, g = grad(flat)
        losses.append(loss)
        flat = {k: (v - np.float32(lr) * g[k]).astype(np.float32)
                for k, v in flat.items()}
    return losses


def test_full_width_mamba2_gradient_matches_jax_leaf_by_leaf():
    w = Witness(layers=2)
    assert w.period is None                 # one dict per layer in both
    jl, jg = w.jax_grad(w.init)
    tl, tg = w.port_grad(w.init)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    gaps = leaf_gaps(tg, jg)
    assert len(gaps) == 2 * 13 + 2     # 13 leaves a layer, embed, norm
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1e-4, (worst, gaps[worst])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=12)
    args = ap.parse_args()
    torch.set_num_threads(4)
    w = Witness(args.layers)
    moved = ulp_up(w.init)
    jl, jg = w.jax_grad(w.init)
    tl, tg = w.port_grad(w.init)
    cols = {"port_vs_jax": leaf_gaps(tg, jg),
            "jax_one_ulp": leaf_gaps(w.jax_grad(moved)[1], jg),
            "port_one_ulp": leaf_gaps(w.port_grad(moved)[1], tg)}
    print(f"mamba2-130m widths, {args.layers} layers, fp32: loss JAX {jl!r}"
          f", port {tl!r}")
    print("leaf, max |grad|, then as shares of it: " + ", ".join(cols))
    for k in sorted(jg, key=lambda k: -cols["port_vs_jax"][k]):
        print("/".join(map(str, k)), f"{np.abs(jg[k]).max():.3e}",
              *(f"{c[k]:.2e}" for c in cols.values()))
    for name, c in cols.items():
        print(f"worst {name}: {max(c.values()):.2e}")
    for lr in (0.002, 0.02):
        for name, grad in (("jax", w.jax_grad), ("port", w.port_grad)):
            for tag, flat in (("init", w.init), ("init+1ulp", moved)):
                print(f"sgd lr {lr} {name} {tag}:",
                      [round(x, 6) for x in sgd_losses(grad, flat, lr)])


if __name__ == "__main__":
    main()
