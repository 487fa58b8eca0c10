"""The port's training substrate against the JAX package's, on the CPU:
the optimizers (``sgd``, ``adamw``), the schedules (``constant``,
``linear_anneal``, ``cosine``, ``wsd``) and the joint train step
(``make_joint_train_step``) on the reduced dense model.

The optimizers run 5 steps on a seeded tree of fp32 and bf16 leaves and
are held to the JAX package's un-jitted functions: under ``jax.jit`` XLA
on the CPU may contract ``b1 m + (1 - b1) g`` into a fused multiply-add,
which the port's plain ops do not. fp32 leaves and moments at rtol 1e-6,
bf16 leaves at one bf16 step (they are the fp32 result rounded once).
The schedules are held at rtol 1e-6 at the reference tests' settings and
at their edges (0, the warmup, the decay start, the total). The joint
step runs 3 AdamW steps under a cosine schedule, its loss and params at
1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.optim.optimizers import AdamState as JAdamState  # noqa: E402
from repro.runtime.steps import make_joint_train_step as jjoint  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime.steps import make_joint_train_step  # noqa: E402


def _tree(seed):
    """A nested tree with fp32 and bf16 leaves; JAX arrays and the
    port's tensors of the same values."""
    r = np.random.default_rng(seed)
    shapes = {"w": ((6, 5), jnp.float32), "layers": [
        {"a": ((4, 3), jnp.bfloat16), "b": ((7,), jnp.float32)},
        {"a": ((4, 3), jnp.bfloat16), "b": ((7,), jnp.float32)}]}
    leaves = {path: jnp.asarray(r.standard_normal(shape), dtype)
              for path, (shape, dtype) in bridge.tree_leaves(shapes)}
    jtree = bridge.unflatten_tree(leaves)
    return jtree, bridge.params_from_numpy(jax.tree.map(np.asarray, jtree),
                                           "cpu")


def _assert_tree(got, want):
    want = dict(bridge.tree_leaves(jax.tree.map(np.asarray, want)))
    got = dict(bridge.tree_leaves(got))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, path
            np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                       rtol=2 ** -8, atol=0, err_msg=str(path))
        else:
            assert g.dtype == torch.float32, path
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))


@pytest.mark.parametrize("make", [
    lambda m: m.sgd(), lambda m: m.sgd(momentum=0.9), lambda m: m.adamw(),
    lambda m: m.adamw(weight_decay=0.1)],
    ids=["sgd", "sgd_momentum", "adamw", "adamw_decay"])
def test_optimizer_matches_jax(make):
    """5 steps from one tree with a new seeded gradient tree each step;
    the params and the state (momentum, moments, count) after each."""
    jopt, topt = make(joptim), make(optim)
    jp, tp = _tree(0)
    js, ts = jopt.init(jp), topt.init(tp)
    lr = np.float32(0.05)
    for i in range(5):
        jg, tg = _tree(10 + i)
        jp, js = jopt.update(jg, js, jp, lr)
        tp, ts = topt.update(tg, ts, tp, lr)
        _assert_tree(tp, jp)
        if isinstance(js, JAdamState):
            assert isinstance(ts, optim.AdamState)
            assert int(ts.count) == int(js.count) == i + 1
            _assert_tree(ts.mu, js.mu)
            _assert_tree(ts.nu, js.nu)
        elif js != ():
            _assert_tree(ts, js)
        else:
            assert ts == ()


def test_optimizer_takes_a_device_lr():
    """An lr tensor (one fp32 element on the params' device) gives the
    same step as the number."""
    _, tp = _tree(1)
    _, tg = _tree(2)
    opt = optim.adamw(weight_decay=0.1)
    a, _ = opt.update(tg, opt.init(tp), tp, 0.05)
    b, _ = opt.update(tg, opt.init(tp), tp, torch.tensor(0.05))
    for (pa, x), (pb, y) in zip(bridge.tree_leaves(a), bridge.tree_leaves(b)):
        assert pa == pb and torch.equal(x, y)


def _schedule_cases():
    cases = []
    for lr, total in ((0.01, 1000), (3e-4, 100), (1e-5, 10), (1.0, 37)):
        warm = total // 10
        cases += [
            ("constant", (lr,), (0, 1, total)),
            ("linear_anneal", (lr, total), (0, 1, total // 2, total - 1,
                                            total, total + 5)),
            ("linear_anneal", (lr, total, lr * 0.1), (0, total // 3, total)),
            ("cosine", (lr, total), (0, 1, total // 2, total)),
            ("cosine", (lr, total, warm), (0, 1, warm - 1, warm, warm + 1,
                                           total // 2, total - 1, total,
                                           total + 3)),
            ("wsd", (lr, total), (0, 1, 9, max(int(total * 0.01), 1),
                                  int(total * 0.9) - 1, int(total * 0.9),
                                  int(total * 0.9) + 1, 500 % total,
                                  total - 1, total))]
    cases.append(("cosine", (3e-4, 3), (0, 1, 2, 3), {"warmup": 1}))
    return cases


@pytest.mark.parametrize("case", _schedule_cases(),
                         ids=lambda c: f"{c[0]}{c[1]}")
def test_schedule_matches_jax(case):
    name, args, steps = case[:3]
    kw = case[3] if len(case) > 3 else {}
    js, ts = getattr(joptim, name)(*args, **kw), getattr(optim, name)(
        *args, **kw)
    for step in steps:
        want, got = float(js(step)), ts(step)
        assert isinstance(got, np.float32), (name, step)
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0,
                                   err_msg=f"{name}{args} at {step}")


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_joint_train_step_matches_jax(opt):
    """3 steps of the reduced dense model (2 layers, fp32) under
    ``cosine(3e-4, 3, warmup=1)`` on one batch, from the JAX init: loss
    and lr at 1e-5, opt_step counted on the host, every param at 1e-5.
    AdamW's step is about lr in size whatever the gradient's, and its sign
    follows the gradient's, so an entry whose gradient is within rounding
    of 0 may step the other way: at most 1 entry in 10^4 may then differ,
    by at most 2 lr a step."""
    jcfg = jget_arch("tinyllama-1.1b").reduced()
    tcfg = get_arch("tinyllama-1.1b").reduced()
    jm, tm = jbuild(jcfg), build_model(tcfg)
    phi = jm.init(jax.random.PRNGKey(0))
    r = np.random.default_rng(5)
    tok = r.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    lr = 3e-4 if opt == "adamw" else 0.5
    jopt, topt = getattr(joptim, opt)(), getattr(optim, opt)()
    jstep = jjoint(jm, jopt, joptim.cosine(lr, 3, warmup=1))
    tstep = make_joint_train_step(tm, topt, optim.cosine(lr, 3, warmup=1))
    jp, js, jn = phi, jopt.init(phi), jnp.int32(0)
    tp = bridge.lm_params_from_jax(phi, tm.jax_layout, "cpu")
    ts, tn = topt.init(tp), 0
    for i in range(3):
        jp, js, jn, jmet = jstep(jp, js, jn, jb)
        tp, ts, tn, tmet = tstep(tp, ts, tn, tb)
        assert tn == int(jn) == i + 1
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * abs(
            float(jmet["loss"]))
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
    got = bridge.flatten_tree(bridge.lm_params_to_jax(tp, tm.jax_layout))
    for path, w in bridge.flatten_tree(jax.tree.map(np.asarray, jp)).items():
        diff = np.abs(got[path] - w)
        off = diff > 1e-5 + 1e-5 * np.abs(w)
        if opt == "adamw":
            assert off.sum() <= max(1, w.size // 10_000), path
            assert diff.max() <= 3 * 2 * lr, path
        else:
            assert not off.any(), (path, diff.max())
