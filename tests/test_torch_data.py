"""``repro_torch.data`` and ``repro_torch.runtime`` against the JAX package.

Tokens are held to the reference's bit for bit: the port rebuilds
``jax.random``'s threefry2x32, key derivation and uniform bits in exact
integer arithmetic, and the Gumbel argmax breaks no tie differently on
these shapes (those of ``tests/test_integration.py`` and the reduced
smollm vocab).  Also ported from the reference's tests: elastic
re-sharding, the pipeline state round trip and the straggler policy; and
the supervisor's restart loop.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: E402
from repro_torch.runtime import failures  # noqa: E402
from repro_torch.runtime.stragglers import (  # noqa: E402
    StragglerConfig, StragglerMonitor, rebalance_quanta)


@pytest.mark.parametrize("seed,seq,vocab,batch", [
    (7, 32, 256, 8),          # the training tests' shape (reduced smollm)
    (5, 16, 100, 8),          # tests/test_integration.py's pipeline shapes
    (0, 64, 49152, 2),        # smollm's full vocab
])
def test_synth_batch_tokens_equal_reference(seed, seq, vocab, batch):
    from repro.data.pipeline import DataConfig as RefConfig
    from repro.data.pipeline import synth_batch as ref_batch

    for step in range(3):
        want = ref_batch(RefConfig(seed=seed, global_batch=batch,
                                   seq_len=seq, vocab=vocab), step, 0, batch)
        got = pipeline.synth_batch(DataConfig(seed=seed, global_batch=batch,
                                              seq_len=seq, vocab=vocab),
                                   step, 0, batch, device="cpu")
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{k} step {step}")


def test_threefry_and_keys_equal_reference():
    import jax

    key = jax.random.PRNGKey(123456789)
    mine = pipeline.prng_key(123456789)
    assert tuple(int(v) for v in np.asarray(key)) == mine
    for data in (0, 1, 2 ** 31 + 5, 2 ** 32 - 1):
        key = jax.random.fold_in(key, data)
        mine = pipeline.fold_in(mine, data)
        assert tuple(int(v) for v in np.asarray(key)) == mine
    bits = jax.random.bits(key, (1000,), dtype=np.uint32)
    np.testing.assert_array_equal(
        pipeline.random_bits(mine, 1000, "cpu").numpy(),
        np.asarray(bits).astype(np.int64))
    u = jax.random.uniform(key, (1000,), dtype=np.float32,
                           minval=np.finfo(np.float32).tiny, maxval=1.0)
    got = pipeline.uniform(pipeline.random_bits(mine, 1000, "cpu"),
                           float(np.finfo(np.float32).tiny), 1.0)
    assert got.numpy().tobytes() == np.asarray(u).tobytes()


def test_stub_embeds_and_mrope_positions_are_pure_in_the_quantum():
    """Stub-frontend embeddings are indexed by the global quantum, so a
    shard's slice equals the same rows of the whole step's draw."""
    dcfg = DataConfig(seed=3, global_batch=4, seq_len=8, vocab=64,
                      embed_dim=16, mrope=True)
    full = pipeline.synth_batch(dcfg, 2, 0, 4, device="cpu")
    part = pipeline.synth_batch(dcfg, 2, 1, 3, device="cpu")
    assert "tokens" not in full
    assert full["embeds"].shape == (4, 8, 16)
    assert full["embeds"].dtype == torch.float32
    torch.testing.assert_close(part["embeds"], full["embeds"][1:3],
                               rtol=0, atol=0)
    torch.testing.assert_close(part["targets"], full["targets"][1:3],
                               rtol=0, atol=0)
    assert 0.015 < float(full["embeds"].std()) < 0.025
    assert full["positions"].shape == (4, 3, 8)
    assert full["positions"][2, 1].tolist() == list(range(8))


def test_data_pipeline_elastic_resharding():
    dcfg = DataConfig(seed=5, global_batch=8, seq_len=16, vocab=100)
    one = DataPipeline(dcfg, shard=0, num_shards=1, device="cpu")
    b_full = one.next_batch()
    shards = [DataPipeline(dcfg, shard=i, num_shards=4, device="cpu")
              for i in range(4)]
    parts = [p.next_batch() for p in shards]
    merged = torch.cat([p["tokens"] for p in parts])
    np.testing.assert_array_equal(b_full["tokens"].numpy(), merged.numpy())
    with pytest.raises(ValueError, match="does not split"):
        DataPipeline(dcfg, shard=0, num_shards=3, device="cpu")


def test_data_pipeline_state_roundtrip():
    dcfg = DataConfig(seed=6, global_batch=4, seq_len=8, vocab=50)
    p = DataPipeline(dcfg, device="cpu")
    p.next_batch()
    p.next_batch()
    state = p.state.to_dict()
    q = DataPipeline(dcfg, state=type(p.state).from_dict(state),
                     device="cpu")
    np.testing.assert_array_equal(p.next_batch()["tokens"].numpy(),
                                  q.next_batch()["tokens"].numpy())
    assert next(iter(q))["tokens"].shape == (4, 8)


def test_straggler_monitor_and_rebalance():
    hosts = [f"h{i}" for i in range(4)]
    mon = StragglerMonitor(hosts, StragglerConfig(patience=2))
    actions = {}
    for _ in range(4):
        times = {"h0": 1.0, "h1": 1.0, "h2": 1.0, "h3": 2.0}
        actions = mon.record_step(times)
    assert actions.get("h3") == "rebalance"
    assignment = {h: 4 for h in hosts}
    new = rebalance_quanta(assignment, ["h3"])
    assert new["h3"] == 3 and sum(new.values()) == 16
    # persistent extreme straggler -> evict
    mon2 = StragglerMonitor(hosts, StragglerConfig(patience=2))
    for _ in range(4):
        actions = mon2.record_step(
            {"h0": 1.0, "h1": 1.0, "h2": 1.0, "h3": 10.0})
    assert actions.get("h3") == "evict"


def test_straggler_policy_equals_reference():
    from repro.runtime import stragglers as ref

    hosts = [f"h{i}" for i in range(5)]
    rng = np.random.default_rng(4)
    mine = StragglerMonitor(hosts, StragglerConfig(patience=3))
    theirs = ref.StragglerMonitor(hosts, ref.StragglerConfig(patience=3))
    for _ in range(12):
        times = {h: float(t) for h, t in zip(
            hosts, rng.gamma(4.0, 0.25, len(hosts)) * [1, 1, 1, 2.2, 4])}
        assert mine.record_step(times) == theirs.record_step(times)
    assign = {h: 6 for h in hosts}
    assert rebalance_quanta(assign, ["h3", "h4"]) == \
        ref.rebalance_quanta(assign, ["h3", "h4"])


def test_run_supervised_restores_and_gives_up():
    saved = {}
    fail_once = {3, 5}

    def step_fn(state, step):
        if step in fail_once:
            fail_once.discard(step)
            raise failures.SimulatedFailure(f"at {step}")
        return {"step": step + 1, "acc": state["acc"] + [step]}

    class State(dict):
        step = property(lambda self: self["step"])

    report = failures.run_supervised(
        lambda: State(step=0, acc=[]),
        lambda: State(saved["s"]) if saved else None,
        lambda st, s: State(step_fn(st, s)),
        lambda st, s: saved.__setitem__("s", dict(st)),
        total_steps=7, ckpt_every=2)
    assert report.restarts == 2 and report.completed_steps == 7
    assert [f[0] for f in report.failures] == [3, 5]
    assert saved["s"]["acc"] == list(range(7))

    def always(_st, _s):
        raise failures.SimulatedFailure("down")

    with pytest.raises(failures.SimulatedFailure):
        failures.run_supervised(lambda: State(step=0, acc=[]), lambda: None,
                                always, lambda st, s: None, total_steps=2,
                                ckpt_every=1,
                                cfg=failures.SupervisorConfig(max_restarts=2))
    assert failures.exponential_backoff(0.5, 3) == 4.0
