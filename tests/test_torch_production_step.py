"""The meta-train step on the production mesh,
``runtime/steps.py::make_meta_train_step(model, mesh=)`` with a
``("data", "model")`` or ``("pod", "data", "model")`` ``ProcessMesh``,
four gloo ranks on the CPU, against the JAX package's step jitted on four
forced host devices with phi placed by its ``param_shardings`` and the
batch by its ``token_spec``.

One module fixture starts the four ranks once (``runtime/ranks.py``, the
2-D tests' harness) and, at the same time, the JAX side in a subprocess
under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``. Both sides
lower ``FSDP_THRESHOLD_BYTES`` (the module attribute, in their own
processes) to 100,000 bytes, so that the reduced leaves split on
``data`` where their stacked bytes a model shard pass it: the reduced
tinyllama-1.1b and mixtral-8x22b at 4 layers (so the JAX package stacks
them), fp32, from the JAX package's init, one step of K = 2 microbatches
of 4 x 24 tokens. Held:

- phi (gathered whole) and the three losses within 1e-3 of the JAX step,
  the tolerance at which ``tests/test_torch_mesh2d_engine.py`` holds the
  2-D route's transformer; within 1e-5 of the port's own single-rank
  step; every rank the same, bit for bit;
- each rank's parameter bytes exactly the bytes a chip that
  ``launch/describe.py`` gives for the mesh, each leaf at its specs'
  local shape, some leaves split on ``data`` and some on ``model``;
- the same gradient with the backward on another thread (where no shards
  are installed, as on the card);
- a gradient summed over the batch ranks once: a toy tree with one leaf
  split on ``data`` and one kept whole, against the whole batch on one
  rank, and the same step with the split leaf summed again (as if it were
  whole) caught.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.runtime.ranks import run_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 100_000
BETA, ALPHA = 0.02, 0.5
SHAPE = (2, 4, 24)                 # K, mb, S
TOL = 1e-3                         # the 2-D route's (test_torch_mesh2d_engine)
ONE_RANK_TOL = 1e-5
# name -> (arch, mesh sizes, mesh axes)
CASES = {
    "tinyllama_data2_model2": ("tinyllama-1.1b", (2, 2), ("data", "model")),
    "mixtral_data2_model2": ("mixtral-8x22b", (2, 2), ("data", "model")),
    "tinyllama_pod2_data1_model2": ("tinyllama-1.1b", (2, 1, 2),
                                    ("pod", "data", "model")),
}
ARCHS = sorted({a for a, _, _ in CASES.values()})


def _cfg(get_arch, arch):
    return dataclasses.replace(get_arch(arch).reduced(), num_layers=4,
                               dtype="float32")


def _batch(vocab, seed=1):
    r = np.random.default_rng(seed)
    tok = r.integers(0, vocab, SHAPE).astype(np.int32)
    lab = np.concatenate([tok[..., 1:], np.full(SHAPE[:-1] + (1,), -1,
                                                np.int32)], axis=-1)
    return {"tokens": tok, "labels": lab}


def _flat(tree):
    return {"/".join(map(str, k)): np.asarray(v, np.float32)
            for k, v in bridge.flatten_tree(tree).items()}


def jax_side(out_path):
    """The JAX package's production step on four forced host devices."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.configs import get_arch
    from repro.models import build_model
    from repro.runtime import sharding as jsh
    from repro.runtime.shardctx import mesh_context
    from repro.runtime.steps import make_meta_train_step

    jsh.FSDP_THRESHOLD_BYTES = THRESHOLD
    res = {}
    for name, (arch, sizes, axes) in CASES.items():
        model = build_model(_cfg(get_arch, arch))
        phi = model.init(jax.random.PRNGKey(0))
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(sizes), axes)
        with mesh_context(mesh):
            p = jax.device_put(phi, jsh.param_shardings(phi, mesh))
            spec = jsh.token_spec(mesh, SHAPE[1], extra_dims=1, leading=1)
            b = jax.device_put({k: jnp.asarray(v) for k, v in
                                _batch(model.cfg.vocab_size).items()},
                               NamedSharding(mesh, spec))
            new, metrics = jax.jit(make_meta_train_step(
                model, beta=BETA, alpha=ALPHA))(p, b, jnp.float32(ALPHA))
        res[name] = (_flat(jax.tree.map(np.asarray, new)),
                     {k: float(v) for k, v in metrics.items()})
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _toy_rank(rank):
    """One SGD step of a toy tree, ``a`` split on data (FSDP) and ``b``
    kept whole, on the (2, 2) mesh: the shards' step gathered, the same
    step with ``a`` summed over data again, and the whole batch on one
    rank."""
    from repro_torch.bridge import GroupedLayout
    from repro_torch.core.engine import streaming_sgd
    from repro_torch.runtime import sharding as sh

    mesh = sh.make_mesh((2, 2), ("data", "model"), "cpu")
    specs = {"a": ("data", None), "b": (None, "model")}
    shapes = {"a": (4, 3), "b": (3, 2)}
    shards = sh.ModelShards(specs, shapes, mesh)
    gen = torch.Generator().manual_seed(3)
    whole = {"a": torch.randn(4, 3, generator=gen),
             "b": torch.randn(3, 2, generator=gen)}
    x = torch.randn(1, 8, 4, generator=gen)      # K = 1, mb = 8 rows

    def loss_of(gather):
        def loss(p, micro):
            return ((micro["x"] @ gather("a", p["a"])
                     @ gather("b", p["b"])) ** 2).mean()
        return loss

    want, _ = streaming_sgd(loss_of(lambda k, v: v), whole, {"x": x}, 0.1)
    local = {k: shards.local(k, v).contiguous() for k, v in whole.items()}
    rows = x[:, 4 * mesh.coordinate("data"):4 * mesh.coordinate("data") + 4]
    out = {"want": {k: v.clone() for k, v in want.items()}}
    for how in ("once", "twice"):
        layout = shards.fsdp_layout(GroupedLayout.of_tree(local))
        reduce = shards.batch_mean(mesh, layout)
        if how == "twice":             # the split leaf summed over data too
            reduce.whole = tuple(sum(map(math.prod, g.shapes))
                                 for g in layout.groups)
        got, _ = streaming_sgd(loss_of(shards.gather), local, {"x": rows},
                               0.1, layout=layout, reduce=reduce)
        out[how] = {k: shards.gather_exact(k, v).clone()
                    for k, v in got.items()}
    return out


def _grads_on_threads(model, shards, local, batch, mesh):
    """Whether one microbatch's gradient on the shards is the same when
    the backward (and so each block's recompute) runs on another thread,
    where no shards are installed, as the autograd engine runs a CUDA
    backward."""
    import threading

    from repro_torch.runtime.shardctx import model_shards_scope
    from repro_torch.runtime.steps import batch_rows

    rows, axes = batch_rows(batch, mesh)
    micro = {k: v[0] for k, v in rows.items()}
    grads = []
    for other in (False, True):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in bridge.flatten_tree(local).items()}
        with model_shards_scope(shards.with_batch(axes)):
            loss = model.loss_fn(bridge.unflatten_tree(params), micro)
        out = []

        def run():
            out.extend(torch.autograd.grad(loss, list(params.values())))
        if other:
            t = threading.Thread(target=run)
            t.start()
            t.join()
        else:
            run()
        grads.append(out)
    return all(torch.equal(a, b) for a, b in zip(*grads))


def _rank_steps(rank, inits):
    """Each rank: every case's step on its shards, gathered whole; rank
    0 also the single-rank step. Then the toy."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.describe import chip_bytes
    from repro_torch.launch.specs import param_specs
    from repro_torch.models.transformer import build_model
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import make_meta_train_step

    sh.FSDP_THRESHOLD_BYTES = THRESHOLD
    res = {}
    for name, (arch, sizes, axes) in CASES.items():
        model = build_model(_cfg(get_arch, arch))
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(model.cfg.vocab_size).items()}
        mesh = sh.make_mesh(sizes, axes, "cpu")
        step = make_meta_train_step(model, beta=BETA, alpha=ALPHA,
                                    mesh=mesh)
        shards = step.shards
        local = bridge.lm_shards_from_jax(inits[arch], model.jax_layout,
                                          shards, "cpu")
        new, metrics = step(local, batch, ALPHA)
        specs = bridge.flatten_tree(param_specs(model.cfg, mesh))
        res[name] = {
            "phi": _flat(bridge.lm_params_to_jax(
                bridge.whole_tree(new, shards), model.jax_layout)),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "bytes": sh.per_device_param_bytes(new),
            "chip_bytes": chip_bytes(model.cfg, sh.MeshShape(axes, sizes)),
            "local_shapes_match": all(
                tuple(v.shape) == shards.local_shape(k) for k, v in
                bridge.flatten_tree(new).items()),
            "specs_match": all(specs[k].spec == shards.specs[k]
                               for k in specs),
            "data_split": sum(d is not None
                              for d in shards.data_dims.values()),
            "model_split": sum(d is not None for d in shards.dims.values())}
        res[name]["backward_on_another_thread"] = _grads_on_threads(
            model, shards, local, batch, mesh)
        if rank == 0:
            one, m1 = make_meta_train_step(model, beta=BETA, alpha=ALPHA)(
                bridge.lm_params_from_jax(inits[arch], model.jax_layout,
                                          "cpu"), batch, ALPHA)
            res[name]["one_rank"] = (
                _flat(bridge.lm_params_to_jax(one, model.jax_layout)),
                {k: float(v) for k, v in m1.items()})
    res["toy"] = _toy_rank(rank)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.configs import get_arch
    from repro.models import build_model

    root = tmp_path_factory.mktemp("production")
    jax_out = str(root / "jax.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_production_step as t; "
         f"t.jax_side({jax_out!r})"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        inits = {arch: jax.tree.map(np.asarray, build_model(_cfg(
            get_arch, arch)).init(jax.random.PRNGKey(0))) for arch in ARCHS}
        ranks = run_ranks(_rank_steps, 4, str(root / "ranks"), inits,
                          device="cpu", timeout=600)
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
    finally:
        proc.kill()
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    return {"ranks": ranks, "jax": want}


def _close(got_phi, got_m, want_phi, want_m, tol, name):
    assert set(got_phi) == set(want_phi), name
    for k, v in want_phi.items():
        np.testing.assert_allclose(got_phi[k], v, rtol=tol, atol=tol,
                                   err_msg=f"{name} {k}")
    for k, v in want_m.items():
        assert abs(got_m[k] - v) <= tol * max(1.0, abs(v)), (name, k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_production_step_matches_the_jax_step(runs, name):
    got = runs["ranks"][0][name]
    want_phi, want_m = runs["jax"][name]
    _close(got["phi"], got["metrics"], want_phi, want_m, TOL, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_production_step_matches_the_single_rank_step(runs, name):
    got = runs["ranks"][0][name]
    one_phi, one_m = got["one_rank"]
    _close(got["phi"], got["metrics"], one_phi, one_m, ONE_RANK_TOL, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_holds_the_same_model(runs, name):
    first = runs["ranks"][0][name]
    for r in runs["ranks"][1:]:
        for k, v in first["phi"].items():
            np.testing.assert_array_equal(r[name]["phi"][k], v)
        assert r[name]["metrics"] == first["metrics"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_exactly_the_specs_bytes(runs, name):
    for r in runs["ranks"]:
        got = r[name]
        assert got["bytes"] == got["chip_bytes"], name
        assert got["local_shapes_match"] and got["specs_match"], name
        assert got["data_split"] > 0 and got["model_split"] > 0, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_backward_reads_no_thread_state(runs, name):
    """A block's recompute in the backward takes the shards it was built
    with: on the card the autograd engine runs it on a thread of its
    own."""
    assert all(r[name]["backward_on_another_thread"] for r in runs["ranks"])


def test_a_gradient_is_summed_over_the_batch_ranks_once(runs):
    for r in runs["ranks"]:
        toy = r["toy"]
        for k, v in toy["want"].items():
            torch.testing.assert_close(toy["once"][k], v, rtol=1e-6,
                                       atol=1e-6)
        # the split leaf summed over data again, as if it were whole,
        # adds the other rank's part of its gradient: caught
        assert not torch.allclose(toy["twice"]["a"], toy["want"]["a"],
                                  rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(toy["twice"]["b"], toy["want"]["b"],
                                   rtol=1e-6, atol=1e-6)


def test_batch_rows_follow_token_spec():
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.steps import batch_rows

    class Mesh(sh.MeshShape):
        def coordinate(self, ax):
            return {"pod": 1, "data": 0, "model": 1}[ax]

    batch = {"tokens": torch.arange(2 * 4 * 3).reshape(2, 4, 3)}
    mesh = Mesh(("pod", "data", "model"), (2, 1, 2))
    rows, axes = batch_rows(batch, mesh)
    assert axes == ("pod", "data")
    assert torch.equal(rows["tokens"], batch["tokens"][:, 2:4])
    odd = {"tokens": torch.zeros(2, 3, 5)}       # 3 rows: kept whole
    rows, axes = batch_rows(odd, mesh)
    assert axes is None and rows["tokens"] is odd["tokens"]
