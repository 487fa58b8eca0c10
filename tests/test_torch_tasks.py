"""The port's copy of ``data/tasks.py`` against the JAX package's: the
same seeded draws must give bit-equal blocks and leave the generator in
the same state, since the host RNG order is the engine's parity
contract."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import tasks as jtasks  # noqa: E402
from repro_torch.data import tasks as ttasks  # noqa: E402

DISTS = {"sine": ("SineTasks", {}),
         "omniglot": ("OmniglotTasks", dict(num_classes=40)),
         "kws": ("KWSTasks", {})}


def _pair(kind):
    cls, kw = DISTS[kind]
    return getattr(jtasks, cls)(**kw), getattr(ttasks, cls)(**kw)


def _assert_same(want, got, rng_w, rng_g):
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert rng_w.bit_generator.state == rng_g.bit_generator.state


@pytest.mark.parametrize("kind", sorted(DISTS))
@pytest.mark.parametrize("mode", ["batch", "stream"])
@pytest.mark.parametrize("masked", [False, True])
def test_reference_block_is_bit_equal(kind, mode, masked):
    jd, td = _pair(kind)
    part = (np.array([[True, False, True], [False, True, False]])
            if masked else None)
    rw, rg = np.random.default_rng(3), np.random.default_rng(3)
    _assert_same(jd.sample_support_block_reference(rw, 2, 3, 4, mode, part),
                 td.sample_support_block_reference(rg, 2, 3, 4, mode, part),
                 rw, rg)


@pytest.mark.parametrize("kind", sorted(DISTS))
@pytest.mark.parametrize("masked", [False, True])
def test_vectorized_block_is_bit_equal(kind, masked):
    jd, td = _pair(kind)
    part = (np.array([[True, True, False], [False, True, True]])
            if masked else None)
    rw, rg = np.random.default_rng(5), np.random.default_rng(5)
    _assert_same(jd.sample_support_block(rw, 2, 3, 5, "batch", part),
                 td.sample_support_block(rg, 2, 3, 5, "batch", part), rw, rg)


@pytest.mark.parametrize("kind", sorted(DISTS))
def test_client_support_is_bit_equal(kind):
    jd, td = _pair(kind)
    streams = [np.random.default_rng(seed) for seed in
               ([7, 0x9E37, 1], [7, 2, 1, 0]) * 2]
    jx, jy = jd.sample_client_support(streams[0], streams[1], 6)
    tx, ty = td.sample_client_support(streams[2], streams[3], 6)
    _assert_same({"x": jx, "y": jy}, {"x": tx, "y": ty}, streams[1],
                 streams[3])
    assert streams[0].bit_generator.state == streams[2].bit_generator.state


@pytest.mark.parametrize("kind", sorted(DISTS))
def test_task_views_are_bit_equal(kind):
    """A task's support batch, query batch and stream, and a pool
    client's stable task."""
    jd, td = _pair(kind)
    rw, rg = np.random.default_rng(11), np.random.default_rng(11)
    jt, tt = jd.sample_task(rw), td.sample_task(rg)
    assert jt.task_id == tt.task_id
    _assert_same(jt.support_batch(rw, 3), tt.support_batch(rg, 3), rw, rg)
    _assert_same(jt.query_batch(rw, 2), tt.query_batch(rg, 2), rw, rg)
    for (jx, jy), (tx, ty) in zip(jt.support_stream(rw, 2),
                                  tt.support_stream(rg, 2)):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    assert jd.materialize_client(5, 1).task_id == \
        td.materialize_client(5, 1).task_id
