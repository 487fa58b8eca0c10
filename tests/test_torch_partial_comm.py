"""TinyMetaFed's partial communication on the port
(``PartialCommChannel``, ``core/threefry.py``), held against the JAX
package on the CPU.

The keep masks derive from ``jax.random.permutation`` keyed by
``mask_seed``; the port draws the same permutations in NumPy, so its
masks, chunk ids, billing and training runs equal the JAX package's:
masks and bytes exactly, fp32 params at 1e-4. The contracts of the
partial-channel cases of tests/test_pipeline.py and tests/test_schedule.py
are ported alongside.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs.paper_models import SINE_MLP as J_SINE  # noqa: E402
from repro.data import SineTasks as JSine  # noqa: E402
from repro.models.paper_nets import paper_model_loss as j_loss  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import FlatLayout  # noqa: E402
from repro_torch.configs.paper_models import SINE_MLP  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.data import SineTasks  # noqa: E402
from repro_torch.models.paper_nets import paper_model_loss  # noqa: E402

from test_torch_engine import assert_same_run, init  # noqa: E402,F401

JLOSS = functools.partial(j_loss, J_SINE)
TLOSS = functools.partial(paper_model_loss, SINE_MLP)
EVAL = dict(num_tasks=2, support=4, k_steps=2, lr=0.02, query=8)
P = 1153
TREE_BYTES = P * 4


def _vec(seed, n):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n,)).astype(np.float32))


def _tree(init):
    return {k: torch.from_numpy(np.array(v)) for k, v in init.items()}


# -- the key-derived permutations ---------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_threefry_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    np.testing.assert_array_equal(tkey, np.asarray(key))
    for i in range(3):
        fk = jax.random.fold_in(key, i)
        tfk = threefry.fold_in(tkey, i)
        np.testing.assert_array_equal(tfk, np.asarray(fk))
        np.testing.assert_array_equal(threefry.split(tfk),
                                      np.asarray(jax.random.split(fk)))
        np.testing.assert_array_equal(
            threefry.random_bits32(tfk, 9),
            np.asarray(jax.random.bits(fk, (9,), jnp.uint32)))
        # 1024 and 32: one sort; 2000: two (3 ln n > ln 2^32)
        for n in (1, 32, 1024, 2000):
            np.testing.assert_array_equal(
                threefry.permutation(tfk, n),
                np.asarray(jax.random.permutation(fk, n)))


@pytest.mark.parametrize("fraction,rotate", [(0.25, False), (0.5, False),
                                             (0.25, True), (0.4, True)])
def test_masks_match_jax(init, fraction, rotate):
    """Fixed masks, chunk ids and each round's rotating masks equal the
    JAX package's, leaf for leaf, and the flat mask state is their
    concatenation in the layout's order."""
    tch = tcore.PartialCommChannel(fraction=fraction, rotate=rotate,
                                   mask_seed=3)
    jch = jcore.PartialCommChannel(fraction=fraction, rotate=rotate,
                                   mask_seed=3)
    tree = _tree(init)
    jtree = {k: jnp.asarray(v) for k, v in init.items()}
    layout = FlatLayout.of(tree)
    fixed, ids = tch.flat_mask_state(layout, "cpu")
    for r in range(3):
        got = tch.mask_tree(tree, round_index=r)
        want = jch.mask_tree(jtree, round_index=r)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        flat = fixed if ids is None else tch.masks_for_round(
            ids, torch.tensor([r], dtype=torch.int32))
        assert torch.equal(flat, layout.pack(got))
    if rotate:
        got = tch.chunk_id_tree(tree)
        for k, v in jch.chunk_id_tree(jtree).items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


# -- accounting ---------------------------------------------------------------

def test_partial_channel_accounting(init):
    ch = tcore.PartialCommChannel(fraction=0.25)
    want = sum(max(1, int(round(0.25 * v.size))) * 4 for v in init.values())
    assert ch.payload_bytes(init) == want
    assert ch.payload_bytes(init) == \
        jcore.PartialCommChannel(fraction=0.25).payload_bytes(init)
    assert ch.round_bytes(init, 3) == 2 * 3 * want
    assert want < TREE_BYTES // 3                 # genuinely partial
    assert tcore.PartialCommChannel(fraction=1.0).payload_bytes(init) == \
        TREE_BYTES
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError):
            tcore.PartialCommChannel(fraction=bad)


def test_rotating_payload_bytes_reports_chunk_not_fraction():
    ch = tcore.PartialCommChannel(fraction=0.4, rotate=True)
    tree = {"w": torch.zeros(100)}
    assert ch.rotation_period == 3
    assert ch.kept_entries(100) == 34                   # ceil(100/3), not 40
    assert ch.payload_bytes(tree) == ch.payload_bytes_at(tree, 0) == 34 * 4
    assert int(ch.mask_tree(tree, round_index=0)["w"].sum()) == 34
    assert tcore.PartialCommChannel(fraction=0.4).kept_entries(100) == 40


def test_rotation_period_ceil():
    assert tcore.PartialCommChannel(fraction=0.5,
                                    rotate=True).rotation_period == 2
    assert tcore.PartialCommChannel(fraction=0.25,
                                    rotate=True).rotation_period == 4
    assert tcore.PartialCommChannel(fraction=1 / 3,
                                    rotate=True).rotation_period == 3
    assert tcore.PartialCommChannel(fraction=1.0,
                                    rotate=True).rotation_period == 1


@pytest.mark.parametrize("fraction,n", [(0.5, 128), (0.25, 10), (0.3, 7)])
def test_rotating_masks_cover_everything_once_per_period(fraction, n):
    ch = tcore.PartialCommChannel(fraction=fraction, rotate=True)
    tree = {"w": torch.zeros(n)}
    period = ch.rotation_period
    assert period == int(np.ceil(1.0 / fraction - 1e-9))
    seen = torch.zeros(n, dtype=torch.int64)
    total_bytes = 0
    for r in range(period):
        m = ch.mask_tree(tree, round_index=r)["w"]
        assert int(m.sum()) == ch.kept_entries_at(n, r)
        seen += m
        total_bytes += ch.payload_bytes_at(tree, r)
    assert (seen == 1).all()
    assert total_bytes == n * 4
    assert torch.equal(ch.mask_tree(tree, round_index=0)["w"],
                       ch.mask_tree(tree, round_index=period)["w"])
    assert not torch.equal(ch.mask_tree(tree, round_index=0)["w"],
                           ch.mask_tree(tree, round_index=1)["w"])


# -- the masked wire ----------------------------------------------------------

def test_partial_channel_masks_uplink_delta():
    ref, sent = {"w": _vec(0, 128)}, {"w": _vec(1, 128)}
    ch = tcore.PartialCommChannel(fraction=0.5)
    got = ch.transmit(sent, ref=ref)["w"]
    from_sent, from_ref = got == sent["w"], got == ref["w"]
    assert (from_sent | from_ref).all()
    assert int(from_sent.sum()) == ch.kept_entries(128)
    assert torch.equal(ch.transmit(sent, ref=ref)["w"], got)
    assert torch.equal(ch.transmit(sent)["w"], sent["w"])   # downlink exact


def test_partial_channel_int8_keeps_server_values_exact():
    ref, sent = {"w": _vec(2, 128)}, {"w": _vec(3, 128)}
    ch = tcore.PartialCommChannel(dtype="int8", fraction=0.5)
    got = ch.transmit(sent, ref=ref)["w"]
    wired = tcore.CommChannel("int8").transmit(sent)["w"]
    from_ref, from_wire = got == ref["w"], got == wired
    assert (from_ref | from_wire).all()
    assert int(from_ref.sum()) >= 128 - ch.kept_entries(128)


def test_partial_channel_wire_gating():
    ref, sent = {"w": _vec(4, 64)}, {"w": _vec(5, 64)}
    acct = tcore.PartialCommChannel(dtype="float16", quantize=False,
                                    fraction=0.5)
    assert torch.equal(acct.transmit(sent)["w"], sent["w"])
    up = acct.transmit(sent, ref=ref)["w"]
    assert ((up == sent["w"]) | (up == ref["w"])).all()
    assert acct.payload_bytes(ref) == acct.kept_entries(64) * 2
    ch = tcore.PartialCommChannel(dtype="int8", fraction=0.5)
    down = ch.transmit(sent)["w"]
    wired = tcore.CommChannel("int8").transmit(sent)["w"]
    exact = down == sent["w"]
    assert (exact | (down == wired)).all()
    assert int(exact.sum()) >= 64 - ch.kept_entries(64)
    full = tcore.PartialCommChannel(dtype="int8", fraction=1.0)
    assert torch.equal(full.transmit(sent)["w"], wired)


def test_rotating_uplink_rotates_the_kept_set():
    ref, sent = {"w": _vec(6, 64)}, {"w": _vec(7, 64)}
    ch = tcore.PartialCommChannel(fraction=0.5, rotate=True)
    from0 = ch.transmit(sent, ref=ref, round_index=0)["w"] == sent["w"]
    from1 = ch.transmit(sent, ref=ref, round_index=1)["w"] == sent["w"]
    assert int(from0.sum()) == ch.kept_entries_at(64, 0)
    assert int(from1.sum()) == ch.kept_entries_at(64, 1)
    assert not (from0 & from1).any()
    assert (from0 | from1).all()


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
def test_flat_wire_matches_the_tree_wire_and_jax(init, dtype):
    """transmit_flat on the engine's (C, P) buffers equals transmit on
    the leaf tree and the JAX package's transmit, down and up."""
    ch = tcore.PartialCommChannel(dtype=dtype, fraction=0.25)
    jch = jcore.PartialCommChannel(dtype=dtype, fraction=0.25)
    tree = _tree(init)
    layout = FlatLayout.of(tree)
    phi = layout.pack(tree)
    rng = np.random.default_rng(8)
    res = {k: torch.from_numpy((np.asarray(v)[None] + rng.normal(
        size=(3,) + v.shape)).astype(np.float32)) for k, v in init.items()}
    masks, _ = ch.flat_mask_state(layout, "cpu")
    down = ch.transmit_flat(layout, phi, masks=masks)
    assert torch.equal(down, layout.pack(ch.transmit(tree)))
    up = ch.transmit_flat(layout, layout.pack(res, batch_dims=1), ref=phi,
                          masks=masks)
    assert torch.equal(up, layout.pack(ch.transmit(res, ref=tree),
                                       batch_dims=1))
    jup = jch.transmit({k: jnp.asarray(v.numpy()) for k, v in res.items()},
                       ref={k: jnp.asarray(v) for k, v in init.items()})
    for k, v in layout.views(up).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jup[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# -- training runs against the JAX package ------------------------------------

@pytest.mark.parametrize("case", ["tinyreptile_fixed", "tinyreptile_rotating",
                                  "fedsgd_zeros_ref", "reptile_rotating_pp",
                                  "tinyreptile_int8"])
def test_partial_runs_match_jax(init, case):
    """The masked uplink falls back to the server's phi (or to zeros for
    FedSGD's gradients); the rotating mask follows the round index read
    on the device; bills are the round-exact fraction per participant."""
    name, kw, ch = {
        "tinyreptile_fixed": ("tinyreptile_train", dict(
            rounds=12, beta=0.02, support=8, seed=1, eval_every=6,
            eval_kwargs=EVAL), dict(fraction=0.5)),
        "tinyreptile_rotating": ("tinyreptile_train", dict(
            rounds=10, beta=0.02, support=4, seed=1, eval_every=5,
            eval_kwargs=EVAL), dict(fraction=0.25, rotate=True)),
        "fedsgd_zeros_ref": ("fedsgd_train", dict(
            rounds=10, beta=0.02, support=4, clients_per_round=2, seed=0),
            dict(fraction=0.5)),
        "reptile_rotating_pp": ("reptile_train", dict(
            rounds=8, beta=0.02, support=4, epochs=2, clients_per_round=4,
            seed=2), dict(fraction=0.5, rotate=True)),
        "tinyreptile_int8": ("tinyreptile_train", dict(
            rounds=10, beta=0.02, support=4, seed=3, clients_per_round=2),
            dict(dtype="int8", fraction=0.3)),
    }[case]
    jkw, tkw = {}, {}
    if case == "reptile_rotating_pp":
        jkw["sampling"] = jcore.PartialParticipation(0.5)
        tkw["sampling"] = tcore.PartialParticipation(0.5)
    jch, tch = jcore.PartialCommChannel(**ch), tcore.PartialCommChannel(**ch)
    jout = getattr(jcore, name)(JLOSS, init, JSine(), channel=jch, **kw,
                                **jkw)
    tout = getattr(tcore, name)(TLOSS, init, SineTasks(), channel=tch,
                                device="cpu", **kw, **tkw)
    assert_same_run(tout, jout)
    rounds = kw["rounds"]
    clients = kw.get("clients_per_round", 1)
    if case == "reptile_rotating_pp":
        clients = tcore.PartialParticipation(0.5).cohort(clients)
    want = sum(2 * clients * tch.payload_bytes_at(init, r)
               for r in range(rounds))
    assert tout["comm_bytes"] == want == sum(tout["per_client_bytes"])


def test_partial_transfer_with_a_quantizing_wire_raises(init):
    """Transfer uplinks raw batches: a partial channel that also quantizes
    would mask them by their own tree, which the port refuses; the exact
    partial wire passes them through."""
    def run(channel):
        return tcore.run_federated(init, SineTasks(),
                                   tcore.TransferStrategy(TLOSS), rounds=2,
                                   clients_per_round=2, channel=channel,
                                   device="cpu")

    with pytest.raises(NotImplementedError, match="raw data"):
        run(tcore.PartialCommChannel(dtype="int8", fraction=0.5))
    out = run(tcore.PartialCommChannel(fraction=0.5))
    assert all(torch.isfinite(v).all() for v in out["params"].values())
