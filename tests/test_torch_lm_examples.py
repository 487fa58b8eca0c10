"""The port's examples on the CPU, held against the JAX package: the
quickstart (``repro_torch/examples/quickstart.py``) at 20 rounds and the
LM meta-training example (``repro_torch/examples/llm_meta_training.py``)
at its own 30 rounds, on both families, each from the JAX package's
init.

The quickstart's query MSEs equal the JAX engine's runs with the JAX
example's settings within 1e-4 (the int8 wire within 1e-3: a last-bit
difference can cross an int8 rounding boundary), its bills exactly. The
LM example's per-round meta losses equal the jitted JAX
``make_meta_train_step`` on the same client batches within 1e-4, its
checkpoint round trip holds, and its greedy sample equals the jitted
JAX ``decode_fn``'s tokens.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small tensors; the suite runs in parallel workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.examples import llm_meta_training, quickstart  # noqa: E402

QS_ROUNDS = 20


def test_quickstart_matches_the_jax_runs(capsys):
    from repro import core as jcore
    from repro.configs.paper_models import SINE_MLP
    from repro.data import SineTasks
    from repro.models.paper_nets import init_paper_model, paper_model_loss

    init = {k: np.asarray(v) for k, v in init_paper_model(
        SINE_MLP, jax.random.PRNGKey(0)).items()}
    got = quickstart.main(["--rounds", str(QS_ROUNDS), "--device", "cpu"],
                          params=init)
    out = capsys.readouterr().out
    for line in ("params = 1153", "random init", "TinyReptile     :",
                 "Reptile (serial)", "transfer        :",
                 "transfer model predicts ~0", "TinyReptile int8"):
        assert line in out, line
    loss = functools.partial(paper_model_loss, SINE_MLP)
    ev, dist = quickstart.EVAL, SineTasks()
    run = dict(rounds=QS_ROUNDS, eval_every=QS_ROUNDS, eval_kwargs=ev,
               seed=1)
    want = {
        "random_init": jcore.evaluate_init(
            loss, init, dist, np.random.default_rng(7), **ev)["query_loss"],
        "tinyreptile": jcore.tinyreptile_train(
            loss, init, dist, alpha=1.0, beta=0.02, support=32, **run),
        "reptile": jcore.reptile_train(
            loss, init, dist, alpha=1.0, beta=0.02, support=32, epochs=8,
            **run),
        "transfer": jcore.transfer_train(loss, init, dist, beta=0.02, **run),
        "tinyreptile_int8": jcore.tinyreptile_train(
            loss, init, dist, alpha=1.0, beta=0.02, support=32,
            channel=jcore.CommChannel("int8"), **run)}
    np.testing.assert_allclose(got["random_init"], want["random_init"],
                               rtol=1e-4)
    for key in ("tinyreptile", "reptile", "transfer", "tinyreptile_int8"):
        np.testing.assert_allclose(
            got[key], want[key]["history"][-1]["query_loss"],
            rtol=1e-3 if key.endswith("int8") else 1e-4, err_msg=key)
    assert got["comm_bytes"] == want["tinyreptile"]["comm_bytes"]
    assert got["comm_bytes_int8"] == want["tinyreptile_int8"]["comm_bytes"]
    assert got["comm_bytes"] == 4 * got["comm_bytes_int8"]
    assert len(got["transfer_predictions"]) == 9


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_llm_meta_training_matches_the_jax_step(arch, capsys):
    from repro.configs import get_arch
    from repro.data import LMClientStream
    from repro.models import build_model
    from repro.runtime.steps import make_meta_train_step, microbatch

    jm = build_model(get_arch(arch).reduced())
    init = jm.init(jax.random.PRNGKey(0))
    got = llm_meta_training.main([arch, "--device", "cpu"],
                                 init_params=init)
    out = capsys.readouterr().out
    assert "checkpoint round-trip ok (round 30" in out
    assert f"greedy sample: {got['greedy']}" in out
    # the JAX example's loop, on the same client batches
    ex = llm_meta_training
    clients = [LMClientStream(jm.cfg.vocab_size, c) for c in
               range(ex.CLIENTS)]
    step = jax.jit(make_meta_train_step(jm, beta=0.02, alpha=1.0))
    rng = np.random.default_rng(0)
    phi, want = init, []
    for _ in range(ex.ROUNDS):
        client = clients[int(rng.integers(len(clients)))]
        batch = jax.tree.map(jnp.asarray, client.batch(rng, ex.BATCH,
                                                       ex.SEQ))
        phi, m = step(phi, microbatch(batch, ex.K))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4, atol=1e-4)
    assert want[-1] < want[0]
    cache = jm.init_cache(1, ex.CACHE_LEN)
    decode = jax.jit(jm.decode_fn)
    tok, tokens = jnp.asarray([[1]], jnp.int32), []
    for t in range(ex.NEW_TOKENS):
        logits, cache = decode(phi, {"tokens": tok, "cache": cache,
                                     "cache_len": jnp.int32(t)})
        tok = jnp.argmax(logits[:, 0], -1)[:, None].astype(jnp.int32)
        tokens.append(int(tok[0, 0]))
    assert got["greedy"] == tokens
