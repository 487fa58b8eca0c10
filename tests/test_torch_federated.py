"""Pod-client mode (``core/federated.py::make_pod_client_meta_step``) and
the cohort step on a data mesh (``runtime/steps.py::
make_meta_train_step(mesh=)``, the launcher's ``--mesh data``), two gloo
ranks on the CPU, against the JAX package's steps on a forced 2-device
mesh: ``("pod", "data")`` of shape (2, 1), and ``("data",)`` of 2.

One module fixture starts the two ranks once (a ``FileStore`` under
``tmp_path``) and, at the same time, the JAX side in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=2``. Both take the
JAX package's init of the reduced mamba2-130m, tinyllama-1.1b and
mixtral-8x22b (fp32, 2 layers; on the data mesh the MoE blocks dispatch
the whole microbatch's tokens, one capacity and one aux loss, as the
JAX step does) and the same batch, (K = 2, mb = 4, 24) tokens: new phi leaf
by leaf and the three losses within 1e-4 (the tolerance of the one-rank
round in ``tests/test_torch_lm.py``); both ranks bit for bit; at
``alpha=0`` phi comes back unchanged, exactly.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.federated import make_pod_client_meta_step  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.runtime.ranks import run_ranks  # noqa: E402
from repro_torch.runtime.sharding import make_mesh  # noqa: E402
from repro_torch.runtime.steps import make_meta_train_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("mamba2-130m", "tinyllama-1.1b", "mixtral-8x22b")
BETA, ALPHA = 0.02, 0.5
SHAPE = (2, 4, 24)
TOL = 1e-4
# (step, alpha): the pod round, its alpha=0 identity, the data-mesh round
RUNS = (("pod", ALPHA), ("pod", 0.0), ("data", ALPHA))


def _cfg(get, arch):
    return dataclasses.replace(get(arch).reduced(), num_layers=2,
                               dtype="float32")


def _batch(vocab, seed=1):
    r = np.random.default_rng(seed)
    tok = r.integers(0, vocab, SHAPE).astype(np.int32)
    lab = np.concatenate([tok[..., 1:], np.full(SHAPE[:-1] + (1,), -1,
                                                np.int32)], axis=-1)
    return {"tokens": tok, "labels": lab}


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in bridge.flatten_tree(tree).items()}


def jax_side(out_path):
    """The JAX package's pod-client step on a (2, 1) ("pod", "data")
    mesh and its cohort step on a 2-device ("data",) mesh."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.core.federated import make_pod_client_meta_step as jpod
    from repro.runtime.shardctx import mesh_context
    from repro.runtime.steps import make_meta_train_step as jmeta

    devs = np.array(jax.devices()[:2])
    pod_mesh = Mesh(devs.reshape(2, 1), ("pod", "data"))
    data_mesh = Mesh(devs, ("data",))
    res = {}
    for arch in ARCHS:
        cfg = _cfg(jget_arch, arch)
        model = jbuild(cfg)
        phi = model.init(jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()}
        for kind, alpha in RUNS:
            mesh = pod_mesh if kind == "pod" else data_mesh
            with mesh_context(mesh):
                p = jax.device_put(phi, NamedSharding(mesh, P()))
                if kind == "pod":
                    step = jpod(model, mesh, beta=BETA, alpha=alpha)
                    b = batch
                else:
                    step = jmeta(model, beta=BETA, alpha=alpha)
                    b = jax.device_put(batch, NamedSharding(
                        mesh, P(None, "data", None)))
                new, metrics = jax.jit(step)(p, b, jnp.float32(alpha))
            res[(arch, kind, alpha)] = (
                _flat(jax.tree.map(np.asarray, new)),
                {k: float(v) for k, v in metrics.items()})
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _rank_steps(rank, inits):
    """Each rank: the same runs through the port's steps."""
    pod_mesh = make_mesh((2, 1), ("pod", "data"), "cpu")
    data_mesh = make_mesh((2,), ("data",), "cpu")
    res = {}
    for arch in ARCHS:
        model = build_model(_cfg(get_arch, arch))
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(model.cfg.vocab_size).items()}
        for kind, alpha in RUNS:
            phi = bridge.lm_params_from_jax(inits[arch], model.jax_layout,
                                            "cpu")
            if kind == "pod":
                step = make_pod_client_meta_step(model, pod_mesh, beta=BETA,
                                                 alpha=alpha)
            else:
                step = make_meta_train_step(model, beta=BETA, alpha=alpha,
                                            mesh=data_mesh)
            new, metrics = step(phi, batch, alpha)
            res[(arch, kind, alpha)] = (
                _flat(bridge.lm_params_to_jax(new, model.jax_layout)),
                {k: float(v) for k, v in metrics.items()})
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pods")
    jax_out = str(root / "jax.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.path.join(REPO, "tests")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_federated as t; "
         f"t.jax_side({jax_out!r})"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        inits = {arch: jax.tree.map(np.asarray, jbuild(_cfg(
            jget_arch, arch)).init(jax.random.PRNGKey(0))) for arch in ARCHS}
        ranks = run_ranks(_rank_steps, 2, str(root / "ranks"), inits,
                          device="cpu")
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
    finally:
        proc.kill()
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    return {"ranks": ranks, "jax": want, "inits": inits}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["pod", "data"])
def test_step_matches_the_jax_mesh_step(runs, arch, kind):
    got_phi, got_m = runs["ranks"][0][(arch, kind, ALPHA)]
    want_phi, want_m = runs["jax"][(arch, kind, ALPHA)]
    assert set(got_phi) == set(want_phi)
    for path, v in want_phi.items():
        np.testing.assert_allclose(got_phi[path], v, rtol=TOL, atol=TOL,
                                   err_msg=str(path))
    for k, v in want_m.items():
        assert abs(got_m[k] - v) <= TOL * max(1.0, abs(v)), (k, got_m, v)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0]}_{r[1]}")
def test_ranks_agree_bit_for_bit(runs, arch, run):
    a, b = (r[(arch,) + run] for r in runs["ranks"])
    for path in a[0]:
        np.testing.assert_array_equal(a[0][path], b[0][path])
    assert a[1] == b[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_alpha_zero_is_the_identity(runs, arch):
    init = _flat(runs["inits"][arch])
    for side in (runs["ranks"][0], runs["jax"]):
        got, _ = side[(arch, "pod", 0.0)]
        for path, v in init.items():
            np.testing.assert_array_equal(got[path], v, err_msg=str(path))


def test_pod_mode_needs_a_pod_axis():
    model = build_model(_cfg(get_arch, "mamba2-130m"))
    with pytest.raises(ValueError, match="multi-pod mesh"):
        make_pod_client_meta_step(model, make_mesh((1,), ("data",), "cpu"))
