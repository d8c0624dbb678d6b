"""The port's stream stores against one-shot ``groupby_agg`` and against
the JAX package's stores fed the same batches: batch order, coalescing,
shards, windows with late rows, the partial planner, and states carried
between the packages.  Every store runs on the CPU (``device="cpu"``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.stream as ref_stream  # noqa: E402
from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro.ops import partial as ref_partial  # noqa: E402
from repro.ops import plan as ref_plan  # noqa: E402
from repro_torch import stream  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.obs import fingerprint as fp  # noqa: E402
from repro_torch.ops import groupby_agg, partial as port_partial  # noqa: E402
from repro_torch.ops import plan as port_plan  # noqa: E402

G = 29
AGGS = ("sum", "count", "mean", "var", "std", "min", "max", ("sum", 1))
CPU = "cpu"
SPEC = ReproSpec(dtype=torch.float32, L=2)
RSPEC = RefSpec(dtype=jnp.float32, L=2)
NB = 6


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """One torch thread per test process: the suite runs several worker
    processes on the host at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n=3000, seed=0, spread=15.0):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n, 2)) *
         np.exp(rng.uniform(-spread, spread, (n, 2)))).astype(np.float32)
    k = rng.integers(0, G, n).astype(np.int32)
    return v, k


def _batches(v, k, nb, seed):
    """``nb`` equal batches in a permuted order (equal sizes: the JAX
    package's eager stage compiles once per shape)."""
    rng = np.random.default_rng(seed)
    idx = np.array_split(np.arange(v.shape[0]), nb)
    return [(v[idx[i]], k[idx[i]]) for i in rng.permutation(nb)]


@pytest.fixture(scope="module")
def dataset():
    v, k = _data()
    res, tab = groupby_agg(v, k, G, AGGS, SPEC, return_table=True,
                           device=CPU)
    want = {"stream/table": fp.fingerprint_table(tab),
            "stream/results": fp.fingerprint_results(res)}
    # the JAX package's store fed the batches of every test below
    ref = ref_stream.StreamStore(G, AGGS, RSPEC)
    for b in _batches(v, k, NB, seed=1):
        ref.ingest(*b)
    assert ref.fingerprints() == want
    return v, k, want


@pytest.mark.parametrize("coalesce", [1, 3, "auto"])
@pytest.mark.parametrize("seed", [1, 2])
def test_store_equals_oneshot_for_orders_and_coalescing(dataset, coalesce,
                                                        seed):
    v, k, want = dataset
    store = stream.StreamStore(G, AGGS, SPEC, coalesce=coalesce, device=CPU)
    ref = ref_stream.StreamStore(G, AGGS, RSPEC, coalesce=coalesce)
    for i, b in enumerate(_batches(v, k, NB, seed)):
        store.ingest(*b)
        ref.ingest(*b)
        if i == 2:
            store.query()                 # a query mid-stream changes nothing
    assert store.fingerprints() == want == ref.fingerprints()
    assert store.rows == v.shape[0] and store.batches == NB


def test_store_prepare_commit_and_empty_batches(dataset):
    v, k, want = dataset
    store = stream.StreamStore(G, AGGS, SPEC, coalesce=2, device=CPU)
    assert store.prepare(v[:0], k[:0]) is None
    for bv, bk in _batches(v, k, NB, seed=3):
        st = store.prepare(torch.from_numpy(bv), torch.from_numpy(bk))
        assert st.table.k.device.type == "cpu"
        store.commit(st, len(bk))
        store.ingest(bv[:0], bk[:0])
    assert store.fingerprints() == want
    assert store.pending_bytes == 0
    assert port_partial.state_nbytes(store.state()) == sum(
        t.numel() * t.element_size() for t in (
            *store.state().table, store.state().minv, store.state().maxv,
            store.state().rows))


def test_warmup_leaves_the_store_untouched(dataset):
    v, k, want = dataset
    store = stream.StreamStore(G, AGGS, SPEC, device=CPU)
    before = store.fingerprints()
    assert store.warmup(500) >= 0.0
    assert store.fingerprints() == before and store.batches == 0
    for b in _batches(v, k, NB, seed=1):
        store.ingest(*b)
    assert store.fingerprints() == want


def test_snapshot_restart_is_bit_exact(dataset, tmp_path):
    v, k, want = dataset
    batches = _batches(v, k, NB, seed=2)
    store = stream.StreamStore(G, AGGS, SPEC, device=CPU)
    for b in batches[:3]:
        store.ingest(*b)
    store.snapshot(str(tmp_path))
    store = stream.StreamStore.restore(str(tmp_path), device=CPU)
    for b in batches[3:]:
        store.ingest(*b)
    assert store.fingerprints() == want


@pytest.mark.parametrize("policy", ["round_robin", "key_hash"])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_sharded_store_equals_oneshot_and_reference(dataset, shards,
                                                    policy):
    v, k, want = dataset
    store = stream.ShardedStreamStore(G, AGGS, SPEC, num_shards=shards,
                                      policy=policy, device=CPU)
    for b in _batches(v, k, NB, seed=shards):
        store.ingest(*b)
    # ``want`` is also the JAX package's store fed these rows (the
    # fixture); its sharded store splits every batch the same way, and the
    # parts are prepared by the same stage, so the shards hold its states
    assert store.fingerprints() == want
    assert store.rows == v.shape[0]
    ref = ref_stream.ShardedStreamStore(G, AGGS, RSPEC, num_shards=shards,
                                        policy=policy)
    for (i, pv, pk), (j, rv, rk) in zip(store._split(v, k),
                                        ref._split(v, k), strict=True):
        assert i == j
        assert np.array_equal(np.asarray(pv), rv)
        assert np.array_equal(np.asarray(pk), rk)


def test_key_hash_split_of_negative_and_large_keys():
    store = stream.ShardedStreamStore(G, AGGS, SPEC, num_shards=4,
                                      policy="key_hash", device=CPU)
    ref = ref_stream.ShardedStreamStore(G, AGGS, RSPEC, num_shards=4,
                                        policy="key_hash")
    k = np.array([-1, 0, 1, 2 ** 31 - 1, -2 ** 31, 7, 12345], np.int32)
    v = np.arange(k.size, dtype=np.float32)
    got = [(i, np.asarray(pk)) for i, _, pk in store._split(v, k)]
    want = [(j, rk) for j, _, rk in ref._split(v, k)]
    assert [i for i, _ in got] == [j for j, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))


def _window_feed(nb=6, rows=20, seed=5):
    """Batch ``i`` holds ``rows`` rows in each of windows i + 2, i and
    i - 3 (late at retention 3): late drops and evictions, and one row
    count per window partial."""
    rng = np.random.default_rng(seed)
    feed = []
    for i in range(nb):
        t = np.concatenate([5.0 * w + rng.uniform(0.0, 5.0, rows)
                            for w in (i + 2, i, i - 3)])
        v = (rng.standard_normal((3 * rows, 2)) *
             np.exp(rng.uniform(-6, 6, (3 * rows, 2)))).astype(np.float32)
        k = rng.integers(0, G, 3 * rows).astype(np.int32)
        feed.append((v, k, t))
    return feed


def test_windowed_store_with_late_rows_equals_reference():
    kw = dict(width=5.0, retention=3)
    port = stream.WindowedStore(G, AGGS, SPEC, device=CPU, **kw)
    ref = ref_stream.WindowedStore(G, AGGS, RSPEC, **kw)
    feed = _window_feed()
    for b in feed:
        port.ingest(*b)
        ref.ingest(*b)
    assert port.late_dropped == ref.late_dropped > 0
    assert port.evictions == ref.evictions > 0
    assert port.live_wids() == ref.live_wids()
    assert port.fingerprints() == ref.fingerprints()
    # each retained window equals one-shot groupby_agg over its rows, and
    # the sliding total over the ring equals one-shot over all of them
    rows = [(v[t // 5.0 == w], k[t // 5.0 == w])
            for w in port.live_wids() for v, k, t in feed]
    allv = np.concatenate([r[0] for r in rows])
    allk = np.concatenate([r[1] for r in rows])
    res = groupby_agg(allv, allk, G, AGGS, SPEC, device=CPU)
    total = port.query_sliding(3)
    assert fp.fingerprint_results(total) == fp.fingerprint_results(res)
    for w in port.live_wids():
        sel = [(v[t // 5.0 == w], k[t // 5.0 == w]) for v, k, t in feed]
        one, tab = groupby_agg(np.concatenate([s[0] for s in sel]),
                               np.concatenate([s[1] for s in sel]), G, AGGS,
                               SPEC, return_table=True, device=CPU)
        assert port.fingerprints()[f"window/{w}/table"] == \
            fp.fingerprint_table(tab)
        assert fp.fingerprint_results(port.query(w)) == \
            fp.fingerprint_results(one)


def test_windowed_store_takes_tensors_and_batching_is_free():
    kw = dict(width=5.0, retention=3)
    feed = _window_feed(nb=4)
    a = stream.WindowedStore(G, AGGS, SPEC, device=CPU, **kw)
    for v, kk, t in feed:
        a.ingest(torch.from_numpy(v), torch.from_numpy(kk),
                 torch.from_numpy(t))
    b = stream.WindowedStore(G, AGGS, SPEC, device=CPU, **kw)
    v = np.concatenate([f[0] for f in feed])
    kk = np.concatenate([f[1] for f in feed])
    t = np.concatenate([f[2] for f in feed])
    b.ingest(v, kk, t)
    # the final ring is the same; only the late count depends on batching
    assert a.fingerprints() == b.fingerprints()
    with pytest.raises(ValueError, match="disagree"):
        a.ingest(v[:3], kk[:2], t[:3])


PLAN_CASES = [(2048, 129, 6, None), (1 << 20, 4, 6, (0, 2)),
              (100, 13, 7, None), (4096, 1, 4, None), (50, 1000, 3, (1, 2)),
              (1, 29, 1, None)]


@pytest.mark.parametrize("n,g,ncols,levels", PLAN_CASES)
def test_plan_partial_on_the_cpu_equals_reference(n, g, ncols, levels):
    for method in ("auto", "scatter"):
        got = port_plan.plan_partial(n, g, SPEC, ncols=ncols, backend="cpu",
                                     method=method, levels=levels,
                                     calibration=None)
        want = ref_plan.plan_partial(n, g, RSPEC, ncols=ncols,
                                     backend="cpu", method=method,
                                     levels=levels, calibration=None)
        assert (got.coalesce, got.pipeline, got.agg.method) == \
            (want.coalesce, want.pipeline, want.agg.method)
        assert got.merge_rows == want.merge_rows


def test_plan_partial_on_the_card_prices_the_merge_in_ns():
    plan = port_plan.plan_partial(1 << 20, 4, SPEC, ncols=6,
                                  backend="cuda", calibration=None)
    assert plan.agg.method == "pallas"
    elements = 4 * 6 * SPEC.L
    assert plan.merge_rows == pytest.approx(
        port_plan._CUDA_MERGE_NS * elements / plan.agg.cost)
    assert 1 <= plan.coalesce <= 64 and plan.pipeline >= 1
    # an explicit method has no cost of its own: the cold model prices it
    forced = port_plan.plan_partial(1 << 20, 4, SPEC, ncols=6,
                                    backend="cuda", method="scatter",
                                    calibration=None)
    assert forced.agg.cost == 0.0 and forced.merge_rows > 0
    flat = port_plan.plan_partial(1 << 20, 1, SPEC, ncols=4,
                                  backend="cuda", calibration=None)
    assert flat.agg.method == "rsum"


def test_pipeline_runs_partial_aggs_own_stage(dataset):
    v, k, _ = dataset
    sig = port_partial.AggSignature.build(AGGS, G, SPEC)
    pipe = port_partial.pipeline_for(sig, device=CPU)
    assert pipe is port_partial.pipeline_for(sig, device=CPU)
    got = pipe(v[:700], k[:700])
    want = port_partial.partial_agg(v[:700], k[:700], G, AGGS, SPEC,
                                    device=CPU)
    for a, b in zip((*got.table, got.minv, got.maxv, got.rows),
                    (*want.table, want.minv, want.maxv, want.rows)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_states_cross_between_the_packages(dataset, direction):
    v, k, want = dataset
    half = v.shape[0] // 2
    if direction == "port_to_reference":
        st = port_partial.partial_agg(v[:half], k[:half], G, AGGS, SPEC,
                                      device=CPU)
        leaves, sig_json = state_to_numpy(st)
        sig = ref_partial.AggSignature.from_json(sig_json)
        from repro.core.accumulator import ReproAcc
        carried = ref_partial.PartialState(
            table=ReproAcc(*map(jnp.asarray, leaves[:3])),
            minv=jnp.asarray(leaves[3]), maxv=jnp.asarray(leaves[4]),
            rows=jnp.asarray(leaves[5]), sig=sig)
        other = ref_partial.partial_agg(v[half:], k[half:], G, AGGS, RSPEC)
        merged = ref_partial.merge(carried, other)
        res = ref_partial.finalize(merged)
        from repro.obs import fingerprint as ref_fp
        assert ref_fp.fingerprint_table(merged.table) == want["stream/table"]
        assert ref_fp.fingerprint_results(res) == want["stream/results"]
    else:
        st = ref_partial.partial_agg(v[:half], k[:half], G, AGGS, RSPEC)
        leaves = (st.table.k, st.table.C, st.table.e1, st.minv, st.maxv,
                  st.rows)
        carried = state_from_numpy([np.asarray(x) for x in leaves],
                                   st.sig.to_json(), device=CPU)
        other = port_partial.partial_agg(v[half:], k[half:], G, AGGS, SPEC,
                                         device=CPU)
        merged = port_partial.merge(other, carried)
        assert fp.fingerprint_table(merged.table) == want["stream/table"]
        assert fp.fingerprint_results(port_partial.finalize(merged)) == \
            want["stream/results"]
