"""The engine's LM route beyond Reptile, held against the JAX engine on
the CPU: FedAvg, FedSGD and Transfer on the reduced mamba2, one run over
``PartialCommChannel(0.25)``, and one pooled run (a vectorized
``ClientPool`` of LM clients under ``DiurnalAvailability`` with
``BufferedAggregation``). The setting and tolerances are
``test_torch_lm_engine.py``'s; the pool state is held exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

from repro import core as jcore  # noqa: E402
from repro_torch import core as tcore  # noqa: E402

from test_torch_lm_engine import (assert_same_lm_run,  # noqa: E402,F401
                                  mamba2)


@pytest.mark.parametrize("strategy,skw", [
    ("FedAvgStrategy", dict(epochs=2)),
    ("FedSGDStrategy", {}),
    ("TransferStrategy", {}),
])
def test_baselines_match_jax(mamba2, strategy, skw):  # noqa: F811
    jout, tout = mamba2.run(strategy, skw, seed=5)
    assert_same_lm_run(tout, jout)
    assert ("comm_bytes" in tout) == (strategy != "TransferStrategy")


def test_partial_wire_matches_jax(mamba2):  # noqa: F811
    jout, tout = mamba2.run(
        "ReptileStrategy", dict(epochs=2), seed=6,
        jkw=dict(channel=jcore.PartialCommChannel(fraction=0.25)),
        tkw=dict(channel=tcore.PartialCommChannel(fraction=0.25)))
    assert_same_lm_run(tout, jout)
    # a quarter of every leaf (max(1, round(n / 4)) entries) crosses the
    # wire, both ways, 2 clients a round for 2 rounds
    wire = tcore.PartialCommChannel(fraction=0.25)
    assert tout["comm_bytes"] == 2 * 2 * 2 * wire.payload_bytes(mamba2.init)
    assert wire.payload_bytes(mamba2.init) < tcore.CommChannel().payload_bytes(
        mamba2.init) / 3


def test_pooled_buffered_fleet_matches_jax(mamba2):  # noqa: F811
    jd, td = mamba2.dists()

    def fleet(core, dist):
        return dict(
            pool=core.ClientPool(dist, 16, seed=2, sampler="vectorized"),
            sampling=core.DiurnalAvailability(period=6,
                                              sampler="vectorized"),
            buffered=core.BufferedAggregation(3))

    jout, tout = mamba2.run("TinyReptileStrategy", seed=7, rounds=4,
                            jkw=fleet(jcore, jd), tkw=fleet(tcore, td))
    assert_same_lm_run(tout, jout)
    assert set(tout["pool_state"]) == set(jout["pool_state"])
    for k, v in jout["pool_state"].items():
        np.testing.assert_array_equal(np.asarray(tout["pool_state"][k]),
                                      np.asarray(v), err_msg=k)
    assert tout["pool_state"]["checkins"].sum() > 0
