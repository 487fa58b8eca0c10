"""Carrying weights across: checkpoints the JAX package writes are read
by the port's ``load_params`` and equal the JAX leaves; the NumPy
bridge round-trips exactly."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.configs.paper_models import SINE_MLP  # noqa: E402
from repro.core import run_federated  # noqa: E402
from repro.core.strategies import TinyReptileStrategy  # noqa: E402
from repro.data import SineTasks  # noqa: E402
from repro.models.paper_nets import init_paper_model  # noqa: E402
from repro.models.paper_nets import paper_model_loss  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.checkpoint import (latest_checkpoint,  # noqa: E402
                                    list_checkpoints, load_params,
                                    restore_checkpoint, verify_checkpoint)


@pytest.fixture(scope="module")
def phi():
    return jax.tree.map(np.asarray, init_paper_model(SINE_MLP,
                                                     jax.random.PRNGKey(0)))


def test_bridge_roundtrip_keeps_values_and_dtypes():
    rng = np.random.default_rng(0)
    tree = {"w0": rng.normal(size=(3, 4)).astype(np.float32),
            "q": {"a": rng.integers(-127, 128, (5,)).astype(np.int8),
                  "b": rng.integers(-9, 9, (2, 2)).astype(np.int32)},
            "h": rng.normal(size=(7,)).astype(np.float16)}
    t = params_from_numpy(tree, "cpu")
    assert t["q"]["a"].dtype == torch.int8 and t["h"].dtype == torch.float16
    back = params_to_numpy(t)
    for path in (("w0",), ("q", "a"), ("q", "b"), ("h",)):
        a, b = tree, back
        for k in path:
            a, b = a[k], b[k]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_params_reads_jax_checkpoints(phi, tmp_path):
    """A bare ``save_checkpoint`` snapshot and a ``run_federated``
    round-state checkpoint both load into the port bit for bit."""
    save_checkpoint(str(tmp_path / "bare"), phi, step=0)
    template = params_from_numpy(phi, "cpu")
    bare = load_params(str(tmp_path / "bare"), template)
    for leaf in phi:
        np.testing.assert_array_equal(bare[leaf], phi[leaf])

    loss = functools.partial(paper_model_loss, SINE_MLP)
    out = run_federated(
        phi, SineTasks(), TinyReptileStrategy(loss, use_pallas=False),
        rounds=4, clients_per_round=2, support=8, seed=0,
        ckpt_dir=str(tmp_path / "round"), ckpt_every=2, ckpt_async=False)
    trained = load_params(str(tmp_path / "round"), template)
    for leaf in phi:
        np.testing.assert_array_equal(trained[leaf],
                                      np.asarray(out["params"][leaf]))
    paths = list_checkpoints(str(tmp_path / "round"))
    assert paths and latest_checkpoint(str(tmp_path / "round")) == paths[-1]
    assert all(verify_checkpoint(p) for p in paths)


def test_restore_skips_corrupt_snapshot_and_checks_dtypes(phi, tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, phi, step=1)
    newer = save_checkpoint(d, jax.tree.map(lambda a: a + 1, phi), step=2)
    with open(newer, "r+b") as f:             # tear the newest payload
        f.truncate(64)
    tree, step, _ = restore_checkpoint(d, phi)
    assert step == 1
    np.testing.assert_array_equal(tree["w1"], phi["w1"])
    as_int = {k: v.astype(np.int32) for k, v in phi.items()}
    with pytest.raises(TypeError, match="cast"):
        restore_checkpoint(d, as_int)
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(d, {"nope": phi["w0"]})
