"""The round engine over trees that mix leaf dtypes, held against the JAX
engine on the CPU.

The model is the reduced mamba2 with bf16 weights (``dtype="bfloat16"``:
its matrices, norms and conv in bf16, the SSM scalars ``A_log``, ``D``
and ``dt_bias`` in fp32), cut to one layer for the suite's time, the
JAX package's init carried across as NumPy. The port keeps one flat buffer per dtype group
(``bridge.GroupedLayout``) and every leaf in its dtype.

The reference is the JAX engine itself, with one change made here and
not in the JAX package: the JAX engine hands its strategy hooks ``beta``
as a strongly typed fp32 scalar, under which ``w - beta * g`` promotes a
bf16 leaf to fp32, so the JAX engine refuses a bf16 init outright (its
scan carry changes type). The hooks below receive ``beta`` as a Python
float, the weak type under which the JAX package's update rules keep
each leaf in its own dtype (``_weak``).

Tolerances. The two frameworks round bf16 at other places (matmul
accumulation, elementwise fusion, the bf16 learning rate of the JAX
package's weakly typed step against the port's fp32 one), so every leaf
is held at the repo's 4 bf16 steps (rtol 2^-6, atol 2^-8, as
``tests/test_torch_lm.py`` holds the bf16 round); the bf16 leaves
measured at most 0.32 of it. The fp32 leaves get their gradients
through bf16 activations: they part from the JAX engine by up to 7.3e-5
(measured; 2.3e-4 at two layers), past 1e-5, and are held at the same
tolerance (under 1% of it). Each run is 2 rounds of 2 clients, 2 epochs
where a strategy has them (8 epochs took 0.86 of the tolerance here,
1.8x it at two layers, as the fp32 mamba2 engine tests found for 1e-5).
Bills and pooled counters are exact. A grouped run's snapshot and
resume equals the uninterrupted run bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.engine import meta_interpolate as jmeta  # noqa: E402
from repro.data import LmTaskDistribution as JDist  # noqa: E402
from repro.data import lm_loss as jlm_loss  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.checkpoint import list_checkpoints  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import LmTaskDistribution, lm_loss  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

SEQ = 16
RUN = dict(rounds=2, clients_per_round=2, support=2, alpha=1.0, beta=0.02)
FP32_LEAVES = ("A_log", "D", "dt_bias")


def _weak(cls):
    """A JAX strategy class whose hooks get ``beta`` weakly typed."""
    class Weak(cls):
        def client_update(self, phi, batch, beta):
            return super().client_update(phi, batch, float(beta))

        def client_update_steps(self, phi, batch, beta, k):
            return super().client_update_steps(phi, batch, float(beta), k)

        def server_aggregate(self, phi, results, alpha_t, beta):
            return super().server_aggregate(phi, results, alpha_t,
                                            float(beta))

        def server_aggregate_weighted(self, phi, results, alpha_t, beta,
                                      weights, axis_name=None):
            return super().server_aggregate_weighted(
                phi, results, alpha_t, float(beta), weights,
                axis_name=axis_name)
    Weak.__name__ = cls.__name__
    return dataclasses.dataclass(frozen=True)(Weak)


class Mixed:
    """The bf16-weight reduced mamba2, cut to one layer, on both
    packages."""

    def __init__(self):
        self.jm = jbuild(dataclasses.replace(
            jget_arch("mamba2-130m").reduced(), dtype="bfloat16",
            num_layers=1))
        self.tm = build_model(dataclasses.replace(
            get_arch("mamba2-130m").reduced(), dtype="bfloat16",
            num_layers=1))
        self.init = jax.tree.map(np.asarray, self.jm.init(
            jax.random.PRNGKey(0)))
        self.vocab = self.tm.cfg.vocab_size

    def port(self, strategy, skw=None, **kw):
        return tcore.run_federated(
            self.init, LmTaskDistribution(self.vocab, SEQ),
            getattr(tcore, strategy)(lm_loss(self.tm), **(skw or {})),
            device="cpu", **{**RUN, **kw})

    def jax(self, strategy, skw=None, **kw):
        return jcore.run_federated(
            self.init, JDist(self.vocab, SEQ),
            _weak(getattr(jcore, strategy))(jlm_loss(self.jm),
                                            **(skw or {})),
            **{**RUN, **kw})


@pytest.fixture(scope="module")
def mixed():
    return Mixed()


def _leaves(params):
    return bridge.flatten_tree(params)


def assert_close_bf16(got, want):
    """Every leaf in its init dtype, within 4 bf16 steps of the JAX
    engine's."""
    want = _leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                want["params"]))
    got = _leaves(got["params"])
    assert list(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        fp32 = path[-1] in FP32_LEAVES
        assert g.dtype == (torch.float32 if fp32 else torch.bfloat16), path
        np.testing.assert_allclose(g.float().numpy(), w, rtol=2 ** -6,
                                   atol=2 ** -8, err_msg=str(path))


def _sides(make):
    """The same plugin built from each package's ``core``."""
    return make(jcore), make(tcore)


CASES = {
    "reptile": ("ReptileStrategy", dict(epochs=2), None),
    "fedavg": ("FedAvgStrategy", dict(epochs=2), None),
    "fedsgd": ("FedSGDStrategy", {}, None),
    "fedsgd_weighted": ("FedSGDStrategy", {}, lambda c: dict(
        sampling=c.PartialParticipation(0.5))),
    "fedavg_weighted": ("FedAvgStrategy", dict(epochs=2), lambda c: dict(
        sampling=c.PartialParticipation(0.5))),
    "transfer": ("TransferStrategy", {}, None),
    "fp16_wire": ("ReptileStrategy", dict(epochs=2), lambda c: dict(
        channel=c.CommChannel("float16"))),
    "partial_wire": ("ReptileStrategy", dict(epochs=2), lambda c: dict(
        channel=c.PartialCommChannel(fraction=0.25, rotate=True))),
    "pooled_fedbuff": ("ReptileStrategy", dict(epochs=2), lambda c: dict(
        pool=c.ClientPool((JDist if c is jcore else LmTaskDistribution)(
            512, SEQ), 6, seed=0),
        buffered=c.BufferedAggregation(2),
        sampling=c.DiurnalAvailability(period=24), rounds=6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mixed_dtype_run_matches_jax_engine(mixed, case):
    strategy, skw, plug = CASES[case]
    jkw, tkw = _sides(plug) if plug else ({}, {})
    want = mixed.jax(strategy, skw, **jkw)
    got = mixed.port(strategy, skw, **tkw)
    assert_close_bf16(got, want)
    for key in ("comm_bytes", "per_client_bytes"):
        assert got.get(key) == want.get(key), key
    if "pool_state" in want:
        for k, v in want["pool_state"].items():
            np.testing.assert_array_equal(np.asarray(got["pool_state"][k]),
                                          np.asarray(v), err_msg=k)


def test_mixed_run_launches_per_group(mixed, monkeypatch):
    """A weighted Reptile round on the grouped buffers: per dtype group
    one ``online_sgd`` call an epoch, one ``client_mean`` and one
    ``meta_update``; the bf16 group's rows go to the client mean as bf16
    (no fp32 copy of the cohort) and its fp32 mean to ``meta_update``
    unrounded."""
    calls = {"online_sgd": [], "client_mean": [], "meta_update": []}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name):
            calls[_name].append(tuple(t.dtype for t in a[:2]))
            return _real(*a)
        monkeypatch.setattr(ops, name, spy)
    mixed.port("ReptileStrategy", dict(epochs=2), rounds=1,
               sampling=tcore.PartialParticipation(0.5))
    bf, f32 = torch.bfloat16, torch.float32
    assert calls["online_sgd"] == [(bf, bf), (f32, f32)] * 2
    assert calls["client_mean"] == [(bf, f32), (f32, f32)]
    assert calls["meta_update"] == [(bf, f32), (f32, f32)]


def test_grouped_layout_of_one_dtype_is_the_flat_layout(mixed):
    """A single-dtype tree is one group whose layout (and so whose
    buffer) is ``FlatLayout.of_tree``'s; a mixed tree's groups keep the
    whole tree's order within each group."""
    fp32 = jax.tree.map(lambda a: np.asarray(a, np.float32), mixed.init)
    tree = bridge.params_from_numpy(fp32, "cpu")
    lay = bridge.GroupedLayout.of_tree(tree)
    assert lay.groups == (bridge.FlatLayout.of_tree(tree),)
    assert torch.equal(lay.pack(lay.named(tree))[0],
                       bridge.FlatLayout.of_tree(tree).pack(
                           bridge.flatten_tree(tree)))
    tree = bridge.params_from_numpy(mixed.init, "cpu")
    lay = bridge.GroupedLayout.of_tree(tree)
    assert lay.dtypes == (torch.bfloat16, torch.float32)
    order = {k: i for i, k in enumerate(lay.names)}
    for g in lay.groups:
        assert [order[k] for k in g.names] == sorted(order[k]
                                                     for k in g.names)
    bufs = lay.pack(lay.named(tree))
    assert [b.dtype for b in bufs] == [torch.bfloat16, torch.float32]
    for k, v in lay.views(bufs).items():
        assert torch.equal(v, bridge.flatten_tree(tree)[k])


@pytest.mark.parametrize("rotate", [False, True])
def test_partial_masks_follow_the_whole_tree_order(mixed, rotate):
    """The grouped mask state is the whole tree's (leaf i's permutation
    is leaf i of the sorted tree), cut into the groups."""
    tree = bridge.params_from_numpy(mixed.init, "cpu")
    lay = bridge.GroupedLayout.of_tree(tree)
    ch = tcore.PartialCommChannel(fraction=0.25, rotate=rotate, mask_seed=3)
    whole = bridge.FlatLayout.of_tree(tree)
    fixed, ids = ch.flat_mask_state(whole, "cpu")
    gfixed, gids = ch.flat_mask_state(lay, "cpu")
    want = whole.views(ids if rotate else fixed)
    got = lay.views(gids if rotate else gfixed)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_bf16_client_mean_reads_rows_as_they_are():
    """``client_mean`` on bf16 rows equals it on their fp32 widening, bit
    for bit, in both sum orders (the chain and the windows)."""
    rng = np.random.default_rng(0)
    for C in (8, 64):
        q = torch.from_numpy(rng.normal(size=(C, 1153)).astype(
            np.float32)).to(torch.bfloat16)
        w = torch.from_numpy(rng.uniform(size=C).astype(np.float32))
        w[1] = 0.0
        q[1, 3] = float("nan")
        out = ops.client_mean(q, w)
        assert out.dtype == torch.float32
        assert torch.equal(out, ref.client_mean(q.float(), w))


def test_bf16_interpolation_reads_the_fp32_mean_unrounded():
    """``meta_update`` of a bf16 w with an fp32 w_hat is the JAX
    package's plain interpolation (jitted, as its engine runs it), bit for
    bit; rounding the mean to bf16 first is another function."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=4096).astype(np.float32)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    mean = (wb.float() + torch.from_numpy(
        rng.normal(size=4096).astype(np.float32)) * 1e-2)
    alpha = np.float32(0.37)
    got = ops.meta_update(wb, mean, float(alpha))
    assert got.dtype == torch.bfloat16
    want = jax.jit(lambda p, q, a: jmeta(p, q, a, use_pallas=False))(
        jnp.asarray(wb.float().numpy(), jnp.bfloat16),
        jnp.asarray(mean.numpy()), jnp.float32(alpha))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    cast_first = ops.meta_update(wb, mean.to(torch.bfloat16), float(alpha))
    assert not torch.equal(cast_first, got)


def test_grouped_snapshot_resume_is_exact(mixed, tmp_path):
    """A pooled FedBuff run of the grouped buffers, crashed right after
    its round-4 snapshot and resumed, equals the uninterrupted run bit
    for bit; the snapshot holds phi and the FedBuff buffer as named
    leaves, each in its dtype (bf16 as its raw ``|V2`` bits)."""
    def make_run(**extra):
        return mixed.port(
            "ReptileStrategy", dict(epochs=1), rounds=8, seed=2,
            pool=tcore.ClientPool(LmTaskDistribution(512, SEQ), 6, seed=1),
            buffered=tcore.BufferedAggregation(3),
            sampling=tcore.MarkovAvailability(), **extra)

    # the uninterrupted run snapshots too: blocks are cut at the
    # snapshots, and an availability process draws block by block
    ref_run = make_run(ckpt_dir=str(tmp_path / "ref"), ckpt_every=4)
    ck = dict(ckpt_dir=str(tmp_path / "crash"), ckpt_every=4)
    with pytest.raises(faults.SimulatedPreemption):
        with faults.crash_at_round(4):
            make_run(ckpt_async=False, **ck)
    with np.load(list_checkpoints(ck["ckpt_dir"])[-1]) as snap:
        kinds = {k: snap[k].dtype.str for k in snap.files
                 if "layers/0/mamba/" in k}
    assert kinds and {v for k, v in kinds.items()
                      if k.endswith(("A_log", "D", "dt_bias"))} == {"<f4"}
    assert "|V2" in kinds.values()
    res = make_run(resume=True, **ck)
    got, want = _leaves(res["params"]), _leaves(ref_run["params"])
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    assert res["per_client_bytes"] == ref_run["per_client_bytes"]
    for k, v in ref_run["pool_state"].items():
        np.testing.assert_array_equal(np.asarray(res["pool_state"][k]),
                                      np.asarray(v), err_msg=k)


def test_fp32_runs_keep_one_buffer(mixed, monkeypatch):
    """An fp32 tree runs on one ``(C, P)`` buffer, as before the groups:
    one ``online_sgd`` launch an epoch over every parameter."""
    fp32 = jax.tree.map(lambda a: np.asarray(a, np.float32), mixed.init)
    shapes = []
    real = ops.online_sgd

    def spy(p, *a):
        shapes.append((p.dtype, tuple(p.shape)))
        return real(p, *a)
    monkeypatch.setattr(ops, "online_sgd", spy)
    out = tcore.run_federated(
        fp32, LmTaskDistribution(mixed.vocab, SEQ),
        tcore.ReptileStrategy(lm_loss(build_model(dataclasses.replace(
            get_arch("mamba2-130m").reduced(), num_layers=1))), epochs=1),
        device="cpu", **dict(RUN, rounds=1))
    n = sum(v.size for v in jax.tree.leaves(fp32))
    assert shapes == [(torch.float32, (2, n))]
    assert {v.dtype for v in _leaves(out["params"]).values()} == {
        torch.float32}
