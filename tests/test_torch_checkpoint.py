"""Carrying weights across: checkpoints the JAX package writes are read
by the port's ``load_params`` and equal the JAX leaves; the NumPy
bridge round-trips exactly.

The write side (the port's counterparts of ``tests/test_checkpoint.py``):
mixed-dtype round trips, checksums and the fallback past torn or
corrupted snapshots, retention, the async writer, ``RoundState``, and
interchange with the JAX package both ways on the same keys, dtypes and
values; a bf16 leaf goes to disk as the JAX package writes one (raw
``|V2`` bits).
"""
import functools
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.core import pool as jpool  # noqa: E402
from repro.configs.paper_models import SINE_MLP  # noqa: E402
from repro.core import run_federated  # noqa: E402
from repro.core.strategies import TinyReptileStrategy  # noqa: E402
from repro.data import SineTasks  # noqa: E402
from repro.models.paper_nets import init_paper_model  # noqa: E402
from repro.models.paper_nets import paper_model_loss  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.checkpoint import (latest_checkpoint,  # noqa: E402
                                    list_checkpoints, load_params,
                                    restore_checkpoint, verify_checkpoint)
from repro_torch.core.pool import PoolState  # noqa: E402
from repro_torch.testing import faults  # noqa: E402


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


# ---------------------------------------------------------------------------
# the write side

def _mixed_tree(rng):
    """The dtypes the engine snapshots: fp32 phi leaves (tensors), int8
    FedBuff slabs, int32 counters, int64 bills (arrays)."""
    return {
        "phi": {"w": torch.tensor(rng.normal(size=(4, 5)),
                                  dtype=torch.float32),
                "b": torch.tensor(rng.normal(size=5), dtype=torch.float32)},
        "buf": torch.tensor(rng.integers(-128, 128, size=(3, 7)),
                            dtype=torch.int8),
        "count": np.asarray(rng.integers(0, 9, size=3), np.int32),
        "bills": np.asarray(rng.integers(0, 2 ** 40, size=4), np.int64),
    }


def _flat_np(tree):
    from repro_torch.checkpoint.ckpt import _leaves, _to_numpy
    return [(k, _to_numpy(v)) for k, v in _leaves(tree)]


def _assert_tree_equal(a, b):
    la, lb = _flat_np(a), _flat_np(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


def _roundtrip(seed, d):
    tree = _mixed_tree(np.random.default_rng(seed))
    tckpt.save_checkpoint(d, tree, step=seed, extra={"seed": seed})
    got, step, extra = restore_checkpoint(d, tree)
    assert step == seed and extra == {"seed": seed}
    _assert_tree_equal(got, tree)


def test_mixed_dtype_roundtrip_property(tmp_path):
    """Bit-exact save and restore over fp32/int8/int32/int64 leaves for a
    sweep of seeded random trees."""
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.given(st.integers(0, 40))
    @hypothesis.settings(deadline=None, max_examples=20, derandomize=True)
    def inner(seed):
        _roundtrip(seed, str(tmp_path / f"h{seed}"))

    inner()


@pytest.mark.parametrize("seed", range(8))
def test_mixed_dtype_roundtrip_seeds(seed, tmp_path):
    _roundtrip(seed, str(tmp_path))


def test_dtype_mismatch_raises_unless_cast(tmp_path):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, {"w": torch.ones(2, 3)}, step=1)
    bad = {"w": torch.ones(2, 3, dtype=torch.int8)}
    with pytest.raises(TypeError, match="cast"):
        restore_checkpoint(d, bad)
    got, _, _ = restore_checkpoint(d, bad, cast=True)
    assert got["w"].dtype == np.int8
    np.testing.assert_array_equal(got["w"], np.ones((2, 3), np.int8))


@pytest.mark.parametrize("template,error", [
    ({"w": torch.ones(3, 2)}, ValueError),
    ({"w": torch.ones(2, 3), "extra": torch.ones(2, 3)}, KeyError)])
def test_structural_mismatches_are_not_swallowed(tmp_path, template, error):
    """A wrong template raises at once; only corruption falls back."""
    d = str(tmp_path)
    tckpt.save_checkpoint(d, {"w": torch.ones(2, 3)}, step=1)
    with pytest.raises(error):
        restore_checkpoint(d, template)


def test_verify_checkpoint_catches_bit_flips(tmp_path):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, {"w": torch.arange(64.0)}, step=3)
    path = list_checkpoints(d)[-1]
    assert verify_checkpoint(path)
    size = os.path.getsize(path)
    faults.flip_bytes(path, offset=40, count=4)
    assert os.path.getsize(path) == size
    assert not verify_checkpoint(path)


W256 = np.arange(256, dtype=np.float32)


@pytest.mark.parametrize("rot", ["stale_latest", "torn", "flipped"])
def test_rot_falls_back_with_a_warning(tmp_path, caplog, rot):
    """A stale LATEST pointer (scan instead), a truncated newest payload
    and corrupted leaves under an intact size each restore the newest
    snapshot still sound, with a warning."""
    d = str(tmp_path)
    tckpt.save_checkpoint(d, {"w": W256}, step=1)
    tckpt.save_checkpoint(d, {"w": W256 + 1}, step=2)
    newest = list_checkpoints(d)[-1]
    if rot == "stale_latest":
        faults.make_stale_latest(d)
    elif rot == "torn":
        faults.truncate_file(newest)
    else:
        faults.flip_bytes(newest, offset=200, count=16)
    with caplog.at_level(logging.WARNING, "repro_torch.checkpoint.ckpt"):
        got, step, _ = restore_checkpoint(d, {"w": W256})
    want = (2, W256 + 1) if rot == "stale_latest" else (1, W256)
    assert step == want[0]
    np.testing.assert_array_equal(got["w"], want[1])
    assert any(("LATEST" if rot == "stale_latest" else "falling back")
               in r.message for r in caplog.records)


def test_all_corrupt_raises_empty_dir_distinct(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(16.0)}
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, tree)
    tckpt.save_checkpoint(d, tree, step=1)
    faults.truncate_file(list_checkpoints(d)[0], keep_bytes=4)
    with pytest.raises(ValueError, match="torn or corrupted"):
        restore_checkpoint(d, tree)


def test_retention_keeps_last_k(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(d, {"w": torch.full((8,), float(step))},
                              step=step, keep=2)
    paths = list_checkpoints(d)
    assert [os.path.basename(p) for p in paths] == [
        "ckpt_00000004.npz", "ckpt_00000005.npz"]
    assert all(os.path.exists(p[:-4] + ".json") for p in paths)
    assert sorted(os.listdir(d)) == ["LATEST", "ckpt_00000004.json",
                                     "ckpt_00000004.npz",
                                     "ckpt_00000005.json",
                                     "ckpt_00000005.npz"]
    _, step, _ = restore_checkpoint(d, {"w": torch.ones(8)})
    assert step == 5


def test_async_writer_durable_and_ordered(tmp_path):
    d = str(tmp_path)
    w = tckpt.AsyncCheckpointWriter(d, keep=10)
    for step in (1, 2, 3):
        w.submit({"w": torch.full((8,), float(step))}, step,
                 extra={"step": step})
    w.close()
    assert [os.path.basename(p) for p in list_checkpoints(d)] == [
        "ckpt_00000001.npz", "ckpt_00000002.npz", "ckpt_00000003.npz"]
    got, step, extra = restore_checkpoint(d, {"w": torch.ones(8)})
    assert step == 3 and extra == {"step": 3}
    np.testing.assert_array_equal(got["w"], np.full(8, 3.0, np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        w.submit({"w": torch.ones(8)}, 4)


def test_async_writer_propagates_worker_errors(tmp_path):
    d = str(tmp_path)
    w = tckpt.AsyncCheckpointWriter(d)
    with faults.crash_at_round(1):
        w.submit({"w": torch.ones(4)}, 1)
        with pytest.raises(faults.SimulatedPreemption):
            w.close()
    _, step, _ = restore_checkpoint(d, {"w": torch.ones(4)})
    assert step == 1          # durable before the hook fired


def _round_state():
    rng = np.random.default_rng(0)
    host_rng = np.random.default_rng(123)
    host_rng.integers(0, 10, size=5)               # advance it
    ps = PoolState(
        torch.tensor([3, -1], dtype=torch.int32),
        torch.tensor([0, 3], dtype=torch.int32),
        torch.tensor([1, 0], dtype=torch.int32),
        {"q": {"w0": torch.tensor(rng.integers(-128, 128, (2, 9)),
                                  dtype=torch.int8)},
         "exp": {"w0": torch.tensor([-7, -6], dtype=torch.int32)}},
        torch.tensor([4, 2 ** 30], dtype=torch.int32),
        torch.tensor(1, dtype=torch.int32), torch.tensor(2, dtype=torch.int32))
    state = tckpt.RoundState(
        round=12, phi={"w0": torch.tensor(rng.normal(size=(4, 5)),
                                          dtype=torch.float32)},
        pool_state=ps, per_client_bytes=[10, 20],
        comm_bytes=30, history=[{"round": 4, "query_loss": 1.25}],
        host={"rng": host_rng.bit_generator.state},
        fingerprint={"seed": 5, "strategy": "TifedStrategy"})
    return state, host_rng


def test_round_state_roundtrip(tmp_path):
    """The engine's carry: phi, a PoolState (int8 codes, int32
    exponents, counters), bills, history and the host RNG."""
    state, host_rng = _round_state()
    d = str(tmp_path)
    tckpt.save_round_state(d, state)
    got = tckpt.restore_round_state(d, phi=state.phi,
                                    pool_state=state.pool_state,
                                    per_client_bytes=np.zeros(2, np.int64))
    assert got.round == 12 and got.comm_bytes == 30
    assert got.history == state.history
    assert got.fingerprint == state.fingerprint
    assert isinstance(got.pool_state, PoolState)
    _assert_tree_equal(got.phi, state.phi)
    _assert_tree_equal(got.pool_state, state.pool_state)
    assert list(got.per_client_bytes) == [10, 20]
    restored = np.random.default_rng()
    restored.bit_generator.state = got.host["rng"]
    np.testing.assert_array_equal(restored.integers(0, 1000, 8),
                                  host_rng.integers(0, 1000, 8))
    # an unbuffered pool state holds only its three identity arrays
    tckpt.save_round_state(str(tmp_path / "u"), tckpt.RoundState(
        round=1, phi=state.phi, pool_state=PoolState(
            *(getattr(state.pool_state, f) for f in
              ("last_seen", "staleness", "checkins")))))
    with np.load(list_checkpoints(str(tmp_path / "u"))[0]) as z:
        assert sorted(k for k in z.files if k.startswith("pool")) == [
            "pool/0", "pool/1", "pool/2"]


def _np_round_state(state):
    """The same state with NumPy leaves and the JAX package's PoolState."""
    def cv(t):
        return {k: cv(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.numpy()
    ps = state.pool_state
    return dict(
        round=state.round, phi=cv(state.phi),
        pool_state=jpool.PoolState(*(None if getattr(ps, f) is None else
                                     cv(getattr(ps, f)) for f in (
            "last_seen", "staleness", "checkins", "buf_updates",
            "buf_round", "buf_count", "flushes"))),
        per_client_bytes=np.asarray(state.per_client_bytes, np.int64),
        comm_bytes=state.comm_bytes, history=state.history,
        host=state.host, fingerprint=state.fingerprint)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_round_state_interchange_with_the_jax_package(tmp_path, writer):
    """A round state written by either package restores in the other, on
    the same keys, dtypes and values; so does a bare tree."""
    state, _ = _round_state()
    jstate = jckpt.RoundState(**_np_round_state(state))
    d = str(tmp_path)
    if writer == "torch":
        tckpt.save_round_state(d, state)
        tckpt.save_checkpoint(str(tmp_path / "bare"), state.phi, 7)
        got = jckpt.restore_round_state(
            d, phi=jstate.phi, pool_state=jstate.pool_state,
            per_client_bytes=jstate.per_client_bytes)
        tree, step, _ = jckpt.restore_checkpoint(str(tmp_path / "bare"),
                                                 jstate.phi)
    else:
        jckpt.save_round_state(d, jstate)
        jckpt.save_checkpoint(str(tmp_path / "bare"), jstate.phi, 7)
        got = tckpt.restore_round_state(
            d, phi=state.phi, pool_state=state.pool_state,
            per_client_bytes=np.zeros(2, np.int64))
        tree, step, _ = restore_checkpoint(str(tmp_path / "bare"),
                                           state.phi)
    assert step == 7
    _assert_tree_equal(tree, state.phi)
    assert got.round == 12 and got.comm_bytes == 30
    assert got.history == state.history and got.host == jstate.host
    assert got.fingerprint == state.fingerprint
    _assert_tree_equal(got.phi, state.phi)
    for f in ("last_seen", "staleness", "checkins", "buf_updates",
              "buf_round", "buf_count", "flushes"):
        _assert_tree_equal(getattr(got.pool_state, f),
                           getattr(state.pool_state, f))
    with np.load(list_checkpoints(d)[-1]) as z:
        assert sorted(z.files) == [
            "__extra__", "__step__", "bills", "phi/w0", "pool/0", "pool/1",
            "pool/2", "pool/3/exp/w0", "pool/3/q/w0", "pool/4", "pool/5",
            "pool/6"]


def test_bf16_leaf_is_written_as_raw_bits(tmp_path):
    """A bf16 tensor goes to disk as the JAX package writes an ml_dtypes
    bfloat16 leaf, 2-byte raw bits (``|V2``); it reads back bit-exact into
    a bf16 template, and only a ``|V2`` array restores there."""
    w = torch.tensor([0.1, -3.5, 1e30, float("inf"), 2 ** -130],
                     dtype=torch.bfloat16)
    d = str(tmp_path)
    tckpt.save_checkpoint(d, {"w": w}, 3)
    with np.load(list_checkpoints(d)[0]) as z:
        assert z["w"].dtype == np.dtype("V2")
        raw = z["w"].view(np.int16)
    np.testing.assert_array_equal(raw, w.view(torch.int16).numpy())
    got, _, _ = restore_checkpoint(d, {"w": torch.zeros(5,
                                                        dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    # the JAX package's own bf16 file reads the same
    jckpt.save_checkpoint(str(tmp_path / "j"), {"w": jax.numpy.asarray(
        w.float().numpy(), jax.numpy.bfloat16)}, 3)
    with np.load(list_checkpoints(str(tmp_path / "j"))[0]) as z:
        np.testing.assert_array_equal(z["w"].view(np.int16), raw)
    got, _, _ = restore_checkpoint(str(tmp_path / "j"), {
        "w": torch.zeros(5, dtype=torch.bfloat16)})
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    tckpt.save_checkpoint(str(tmp_path / "f"), {"w": w.float()}, 1)
    for cast in (False, True):
        with pytest.raises(TypeError):
            restore_checkpoint(str(tmp_path / "f"),
                               {"w": torch.zeros(5, dtype=torch.bfloat16)},
                               cast=cast)
