"""Durability in the port against the JAX package: the WAL's bytes, logs
and snapshots crossing between the packages, the checkpoint layout, and
the chaos matrix of ``tests/test_chaos.py`` on the port's stores.

Every store here runs on the CPU (``device="cpu"``); files go under
``tmp_path``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.stream as ref_stream  # noqa: E402
from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro.runtime import faultinject as ref_faults  # noqa: E402
from repro.stream import wal as ref_wal  # noqa: E402
from repro_torch import stream  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.obs import fingerprint as fp  # noqa: E402
from repro_torch.runtime import faultinject  # noqa: E402
from repro_torch.runtime.failures import exponential_backoff  # noqa: E402
from repro_torch.stream import wal  # noqa: E402

G = 13
AGGS = ("sum", "count", "mean", "var", "std", "min", "max", ("sum", 1))
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """One torch thread per test process: the suite runs several worker
    processes on the host at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs():
    return ReproSpec(dtype=torch.float32), RefSpec(dtype=jnp.float32)


def _batches(nb=6, seed=0, n=1500, ncols=2):
    """A fixed batch sequence: a wide magnitude spread, an empty batch,
    signed zeros, one group never touched."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n, ncols)) *
         np.exp(rng.uniform(-9, 9, (n, ncols)))).astype(np.float32)
    v[5] = [-0.0, 0.0]
    k = rng.integers(0, G - 1, n).astype(np.int32)
    idx = np.array_split(np.arange(n), nb)
    out = [(v[i], k[i]) for i in idx]
    out.insert(2, (v[:0], k[:0]))
    return out


def _feed(store, batches, tagged):
    for i, (v, k) in enumerate(batches):
        if tagged:
            store.ingest(v, k, client="c", seq=i)
        else:
            store.ingest(v, k)


# ---------------------------------------------------------------------------
# the WAL's bytes and the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tagged", [False, True], ids=["untagged", "tagged"])
def test_wal_bytes_equal_reference_and_logs_cross(tmp_path, tagged):
    spec, rspec = _specs()
    batches = _batches()
    port = stream.StreamStore(G, AGGS, spec, wal=tmp_path / "port.wal",
                              device=CPU)
    ref = ref_stream.StreamStore(G, AGGS, rspec, wal=str(tmp_path / "r.wal"))
    _feed(port, batches, tagged)
    _feed(ref, batches, tagged)
    port.wal.close()
    ref.wal.close()
    assert (tmp_path / "port.wal").read_bytes() == \
        (tmp_path / "r.wal").read_bytes()
    assert port.fingerprints() == ref.fingerprints()
    # each package recovers the other's log to the other's fingerprints
    from_ref = stream.StreamStore.recover(tmp_path / "r.wal", device=CPU)
    from_port = ref_stream.StreamStore.recover(str(tmp_path / "port.wal"))
    assert from_ref.fingerprints() == ref.fingerprints()
    assert from_port.fingerprints() == port.fingerprints()
    if tagged:
        assert from_ref.ingest(*batches[0], client="c", seq=0)["duplicate"]
    from_ref.wal.close()
    from_port.wal.close()


def _balanced_batches(nb=4, per_group=6, seed=1):
    """Batches holding every group ``per_group`` times, so every shard of
    a key-hash split sees the same row count in every batch (the JAX
    package compiles its eager stage once per shape)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        k = rng.permutation(np.repeat(np.arange(G, dtype=np.int32),
                                      per_group))
        v = (rng.standard_normal((k.size, 2)) *
             np.exp(rng.uniform(-9, 9, (k.size, 2)))).astype(np.float32)
        out.append((v, k))
    return out


@pytest.mark.parametrize("policy", ["round_robin", "key_hash"])
def test_sharded_wal_bytes_equal_reference(tmp_path, policy):
    spec, rspec = _specs()
    batches = _balanced_batches()
    port = stream.ShardedStreamStore(G, AGGS, spec, num_shards=3,
                                     policy=policy, wal=tmp_path / "p.wal",
                                     device=CPU)
    ref = ref_stream.ShardedStreamStore(G, AGGS, rspec, num_shards=3,
                                        policy=policy,
                                        wal=str(tmp_path / "r.wal"))
    _feed(port, batches, True)
    _feed(ref, batches, True)
    port.wal.close()
    ref.wal.close()
    assert (tmp_path / "p.wal").read_bytes() == \
        (tmp_path / "r.wal").read_bytes()
    # replay onto another shard count in the other package
    got = stream.ShardedStreamStore.recover(tmp_path / "r.wal",
                                            num_shards=2, device=CPU)
    assert got.fingerprints() == ref.fingerprints() == port.fingerprints()
    got.wal.close()


WAGGS = ("sum", "count", "min")


def _window_feed(nb=6, rows=12, seed=4):
    """Batch ``i`` holds ``rows`` rows in each of the windows i + 2, i and
    i - 3: with width 4 and retention 3 the last are late and the ring
    evicts as the watermark moves, and every window's partial has
    ``rows`` rows (one shape for the JAX package to compile)."""
    rng = np.random.default_rng(seed)
    feed = []
    for i in range(nb):
        t = np.concatenate([4.0 * w + rng.uniform(0.0, 4.0, rows)
                            for w in (i + 2, i, i - 3)])
        v = (rng.standard_normal(3 * rows) *
             np.exp(rng.uniform(-6, 6, 3 * rows))).astype(np.float32)
        k = rng.integers(0, 5, 3 * rows).astype(np.int32)
        feed.append((v, k, t))
    return feed


def test_windowed_wal_bytes_equal_reference(tmp_path):
    spec, rspec = _specs()
    kw = dict(width=4.0, retention=3)
    port = stream.WindowedStore(5, WAGGS, spec, wal=tmp_path / "p.wal",
                                device=CPU, **kw)
    ref = ref_stream.WindowedStore(5, WAGGS, rspec,
                                   wal=str(tmp_path / "r.wal"), **kw)
    for i, b in enumerate(_window_feed()):
        port.ingest(*b, client="w", seq=i)
        ref.ingest(*b, client="w", seq=i)
    port.wal.close()
    ref.wal.close()
    assert port.late_dropped == ref.late_dropped > 0
    assert port.evictions == ref.evictions > 0
    assert (tmp_path / "p.wal").read_bytes() == \
        (tmp_path / "r.wal").read_bytes()
    got = stream.WindowedStore.recover(tmp_path / "r.wal", device=CPU)
    assert got.fingerprints() == ref.fingerprints()
    assert (got.late_dropped, got.evictions, got._wids) == \
        (ref.late_dropped, ref.evictions, ref._wids)
    got.wal.close()


ARRAYS = {
    "scalar": np.int32(7),
    "empty": np.zeros((0, 3), np.float32),
    "noncontig": np.arange(24, dtype=np.int64).reshape(4, 6)[:, ::2],
    "bigendian": np.arange(5, dtype=">f8"),
    "f32": np.float32([1.5, -0.0, np.inf]),
}


def test_array_codec_equals_reference():
    got = wal._pack_arrays(ARRAYS)
    assert got == ref_wal._pack_arrays(ARRAYS)
    back = wal._unpack_arrays(got)
    for name, a in ARRAYS.items():
        b = back[name]
        assert b.shape == np.asarray(a).shape
        assert np.array_equal(b, np.asarray(a)) or name == "f32"
        assert b.tobytes() == np.asarray(a).astype(
            np.asarray(a).dtype.newbyteorder("<")).tobytes()


def test_pack_parts_one_transfer_roundtrips_states():
    from repro_torch.ops.partial import partial_agg
    spec, _ = _specs()
    states = [partial_agg(v, k, G, AGGS, spec, device=CPU)
              for v, k in _batches(nb=3)[:2]]
    arrays = wal.pack_parts(states)
    assert sorted(arrays) == sorted(f"p{i}/{n}" for i in range(2)
                                    for n in wal._LEAVES)
    back = wal.unpack_parts(wal._unpack_arrays(wal._pack_arrays(arrays)),
                            states[0].sig, device=CPU)
    for a, b in zip(states, back):
        for x, y in zip(wal._leaves(a), wal._leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    # the packed host copy is the leaves' bytes, dtypes and shapes
    host = wal._to_host([s.table.k for s in states] + [states[0].rows])
    assert host[-1].shape == () and host[-1].dtype == np.int32
    assert all(h.tobytes() == s.table.k.numpy().tobytes()
               for h, s in zip(host, states))


def test_torn_tail_and_corrupt_record(tmp_path):
    spec, _ = _specs()
    batches = _batches()
    store = stream.StreamStore(G, AGGS, spec, wal=tmp_path / "a.wal",
                               device=CPU)
    _feed(store, batches, True)
    store.wal.close()
    path = tmp_path / "a.wal"
    size = path.stat().st_size
    with open(path, "r+b") as f:                   # a torn last record
        f.truncate(size - 7)
    log = wal.WriteAheadLog(path)
    assert log.truncated_bytes > 0 and log.last_seq == len(batches) - 2
    log.close()
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF                     # a flipped byte
    path.write_bytes(bytes(raw))
    seqs = [r.seq for r in wal.WriteAheadLog(path).records()]
    assert seqs == list(range(1, len(seqs) + 1))
    assert len(seqs) < len(batches) - 1


def test_walreader_tails_a_live_log(tmp_path):
    spec, _ = _specs()
    store = stream.StreamStore(G, AGGS, spec, wal=tmp_path / "a.wal",
                               device=CPU)
    reader = wal.WalReader(tmp_path / "a.wal")
    batches = _batches()
    store.ingest(*batches[0])
    assert [r.seq for r in reader.poll()] == [1]
    store.ingest(*batches[1])
    store.ingest(*batches[3])
    assert [r.seq for r in reader.poll()] == [2, 3]
    assert reader.poll() == []
    store.wal.close()


def test_wal_rejects_foreign_signature_and_kind(tmp_path):
    spec, _ = _specs()
    store = stream.StreamStore(G, AGGS, spec, wal=tmp_path / "a.wal",
                               device=CPU)
    store.wal.close()
    other = stream.StreamStore(G + 1, AGGS, spec, device=CPU).sig
    with pytest.raises(wal.WalError):
        wal.WriteAheadLog(tmp_path / "a.wal", sig=other)
    with pytest.raises(wal.WalError):
        wal.WriteAheadLog(tmp_path / "a.wal", kind="window")
    store = stream.StreamStore(G, AGGS, spec, device=CPU)
    store.ingest(*_batches()[0])
    log = wal.WriteAheadLog(tmp_path / "b.wal", sig=store.sig)
    log.append({"x": np.ones(2)}, meta={})
    with pytest.raises(ValueError, match="already holds"):
        stream.StreamStore(G, AGGS, spec, wal=log, device=CPU)
    log.close()


def test_dedup_index_and_backoff():
    d = wal.DedupIndex()
    assert d.reserve("a", 0) and d.reserve("a", 2)
    assert not d.reserve("a", 2) and d.seen("a", 2) and not d.seen("a", 1)
    assert d.reserve("a", 1) and d.clients() == {"a": 2}
    d.absorb_meta({"client": "b", "cseq": 0})
    d.absorb_meta({"shards": [0]})
    assert d.clients() == {"a": 2, "b": 0}
    assert [exponential_backoff(0.05, a) for a in range(4)] == \
        [0.05, 0.1, 0.2, 0.4]
    assert exponential_backoff(1.0, 10, cap_s=3.0) == 3.0
    assert exponential_backoff(0.0, 3) == 0.0


# ---------------------------------------------------------------------------
# snapshots and the checkpoint layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_restores_in_the_other_package(tmp_path, writer):
    spec, rspec = _specs()
    batches = _batches()
    port = stream.StreamStore(G, AGGS, spec, device=CPU)
    ref = ref_stream.StreamStore(G, AGGS, rspec)
    _feed(port, batches, False)
    _feed(ref, batches, False)
    snaps = str(tmp_path / "snaps")
    if writer == "port":
        port.snapshot(snaps)
        got = ref_stream.StreamStore.restore(snaps, verify=True)
        ref_ckpt.verify_value(
            {"table": {"k": got._state.table.k, "C": got._state.table.C,
                       "e1": got._state.table.e1},
             "minv": got._state.minv, "maxv": got._state.maxv,
             "rows": got._state.rows}, snaps)
    else:
        ref.snapshot(snaps)
        got = stream.StreamStore.restore(snaps, verify=True, device=CPU)
        assert got.device.type == "cpu"
    assert got.fingerprints() == port.fingerprints() == ref.fingerprints()
    assert got.batches == len(batches)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_windowed_snapshot_restores_in_the_other_package(tmp_path, writer):
    spec, rspec = _specs()
    kw = dict(width=4.0, retention=3)
    port = stream.WindowedStore(5, WAGGS, spec, device=CPU, **kw)
    ref = ref_stream.WindowedStore(5, WAGGS, rspec, **kw)
    for b in _window_feed(nb=3):
        port.ingest(*b)
        ref.ingest(*b)
    snaps = str(tmp_path / "snaps")
    if writer == "port":
        port.snapshot(snaps)
        got = ref_stream.WindowedStore.restore(snaps)
    else:
        ref.snapshot(snaps)
        got = stream.WindowedStore.restore(snaps, device=CPU)
    assert got.fingerprints() == port.fingerprints() == ref.fingerprints()
    assert got._wids == ref._wids and got.late_dropped == ref.late_dropped


def test_recover_from_reference_snapshot_plus_tail(tmp_path):
    spec, rspec = _specs()
    batches = _batches()
    ref = ref_stream.StreamStore(G, AGGS, rspec, wal=str(tmp_path / "a.wal"))
    for i, b in enumerate(batches):
        ref.ingest(*b, client="c", seq=i)
        if i == 3:
            ref.snapshot(str(tmp_path / "snaps"))
    ref.wal.close()
    got = stream.StreamStore.recover(tmp_path / "a.wal",
                                     str(tmp_path / "snaps"), device=CPU)
    assert got.fingerprints() == ref.fingerprints()
    assert got.rows == sum(len(k) for _, k in batches)
    assert got.ingest(*batches[1], client="c", seq=1)["duplicate"]
    got.wal.close()


def test_checkpoint_layout_and_verification(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": [torch.tensor(1.5, dtype=torch.float64),
                  (torch.zeros(3), torch.ones(2, dtype=torch.int64))]}
    path = ckpt.save(str(tmp_path), 4, tree, extra={"note": "x"})
    assert os.path.basename(path) == "step_00000004"
    manifest = ckpt.read_manifest(str(tmp_path))
    assert set(manifest) == {"step", "sha256", "tree_fingerprint", "env",
                             "arrays", "extra"}
    assert manifest["env"]["fingerprint_layout"] == fp.LAYOUT_VERSION
    assert manifest["arrays"]["b/1/1"] == {"shape": [2], "dtype": "int64"}
    # the JAX package reads it, and hashes the tree to the same digest
    rtree, extra = ref_ckpt.restore(str(tmp_path), {
        "a": 0, "b": [0, (0, 0)]})
    assert extra == {"note": "x"}
    assert ref_ckpt.verify_value(rtree, str(tmp_path)) == \
        manifest["tree_fingerprint"]
    got, _ = ckpt.restore(str(tmp_path), tree, device=CPU)
    assert ckpt.verify_value(got, str(tmp_path)) == \
        ckpt.checkpoint_fingerprint(str(tmp_path))["tree_fingerprint"]
    assert got["b"][1][1].dtype == torch.int64
    got["a"][0, 0] = 99
    with pytest.raises(IOError, match="does not match"):
        ckpt.verify_value(got, str(tmp_path))
    # a flipped byte in the npz fails its sha256
    npz = tmp_path / "step_00000004" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[-30] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        ckpt.restore(str(tmp_path), tree, device=CPU)


def test_async_checkpointer_keeps_the_latest(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    t = torch.zeros(4)
    for step in range(4):
        saver.save(step, {"t": t}, extra={"step": step})
        t += 1                           # the saved copy is unaffected
    saver.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    got, extra = ckpt.restore(str(tmp_path), {"t": t}, device=CPU)
    assert extra == {"step": 3} and torch.equal(got["t"], torch.full(
        (4,), 3.0))
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    ckpt.save(str(tmp_path), 0, {"t": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.restore(str(tmp_path), {"t": 0})
    for make in (lambda: stream.StreamStore(G, AGGS),
                 lambda: stream.ShardedStreamStore(G, AGGS),
                 lambda: stream.WindowedStore(G, AGGS, width=1.0),
                 lambda: stream.ReplicatedStore(
                     G, AGGS, wal_path=tmp_path / "r.wal")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_unavailable_storage_degrades_to_read_only(tmp_path):
    spec, _ = _specs()
    batches = _batches()
    store = stream.StreamStore(G, AGGS, spec, wal=tmp_path / "a.wal",
                               device=CPU)
    store.ingest(*batches[0])
    inj = faultinject.FaultInjector([("wal.append", 0, "unavailable")])
    with faultinject.active(inj):
        with pytest.raises(stream.WalUnavailable):
            store.ingest(*batches[1])
    assert store.read_only and store.rows == len(batches[0][1])
    with pytest.raises(stream.WalUnavailable):
        store.ingest(*batches[3])
    store.query()                                  # reads still served
    store.wal.close()


# ---------------------------------------------------------------------------
# the chaos matrix of tests/test_chaos.py, on the port
# ---------------------------------------------------------------------------

CG = 11
CAGGS = ("sum", "count", "mean", "min", "max")


def _chaos_batches(nb=9, seed=0, n=900):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n, 1)) *
         np.exp(rng.uniform(-8, 8, (n, 1)))).astype(np.float32)
    k = rng.integers(0, CG, n).astype(np.int32)
    idx = np.array_split(np.arange(n), nb)
    return [(v[i], k[i]) for i in idx]


@pytest.fixture(scope="module")
def chaos_reference():
    batches = _chaos_batches()
    ref = stream.StreamStore(CG, aggs=CAGGS, device=CPU)
    for b in batches:
        ref.ingest(*b)
    jref = ref_stream.StreamStore(CG, aggs=CAGGS)
    for b in batches:
        jref.ingest(*b)
    assert ref.fingerprints() == jref.fingerprints()
    return batches, ref.fingerprints(), ref.rows


def drive(faults, make, recover, batches, inj, snap_at=None,
          max_crashes=16):
    """The chaos client of ``tests/test_chaos.py``: at-least-once delivery
    with recovery on crash; returns the store and each retry's answer."""
    store, answers = make(), []
    crashes, snapped, retry = 0, False, False
    with faults.active(inj):
        i = 0
        while i < len(batches):
            try:
                if snap_at is not None and i == snap_at and not snapped:
                    store.snapshot()
                    snapped = True
                out = store.ingest(*batches[i], client="chaos", seq=i)
                if retry:
                    answers.append(bool(out.get("duplicate")))
                    retry = False
                i += 1
            except faults.InjectedCrash:
                crashes += 1
                assert crashes <= max_crashes, "crash loop"
                store = recover()
                retry = True
    return store, answers


SCENARIOS = [
    ("crash-before-log", [("wal.append", 4, "crash")]),
    ("crash-after-log", [("wal.append.logged", 4, "crash")]),
    ("torn-record", [("wal.append.logged", 4, "torn_tail")]),
    ("crash-in-commit", [("store.commit", 5, "crash")]),
    ("crash-mid-snapshot", [("ckpt.save", 0, "crash")]),
    ("corrupt-snapshot", [("ckpt.saved", 0, "corrupt"),
                          ("wal.append", 7, "crash")]),
    ("double-crash", [("wal.append", 2, "crash"),
                      ("wal.append.logged", 6, "crash")]),
]


def _plain(pkg, wal_path, snaps, **kw):
    cls = pkg.StreamStore

    def make():
        s = cls(CG, aggs=CAGGS, wal=wal_path, **kw)
        s.snapshot = lambda: cls.snapshot(s, snaps)
        return s

    def recover():
        s = cls.recover(wal_path, snaps, **kw)
        s.snapshot = lambda: cls.snapshot(s, snaps)
        return s
    return make, recover


def _sharded(pkg, wal_path, snaps, **kw):
    cls = pkg.ShardedStreamStore

    def make():
        s = cls(CG, aggs=CAGGS, num_shards=3, wal=wal_path, **kw)
        s.snapshot = lambda: cls.snapshot(s, snaps)
        return s

    def recover():
        # a shard count the writer never had: replay re-partitions
        s = cls.recover(wal_path, snaps, num_shards=2, **kw)
        s.snapshot = lambda: cls.snapshot(s, snaps)
        return s
    return make, recover


@pytest.mark.parametrize("name,points", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
@pytest.mark.parametrize("flavor", ["plain", "sharded"])
def test_fault_matrix_recovers_bit_identical(chaos_reference, tmp_path,
                                             flavor, name, points):
    batches, want, want_rows = chaos_reference
    build = _plain if flavor == "plain" else _sharded
    make, recover = build(stream, tmp_path / "a.wal",
                          str(tmp_path / "snaps"), device=CPU)
    inj = faultinject.FaultInjector(points, seed=7)
    store, answers = drive(faultinject, make, recover, batches, inj,
                           snap_at=4)
    assert inj.fired, f"scenario {name} never fired its fault"
    assert store.fingerprints() == want
    assert store.rows == want_rows
    store.wal.close()
    # the JAX package, driven by the same schedule, fires the same faults
    # and answers the same retries as duplicates or fresh
    rmake, rrecover = build(ref_stream, str(tmp_path / "r.wal"),
                            str(tmp_path / "rsnaps"))
    rinj = ref_faults.FaultInjector(points, seed=7)
    rstore, ranswers = drive(ref_faults, rmake, rrecover, batches, rinj,
                             snap_at=4)
    assert [f[:3] for f in inj.fired] == [f[:3] for f in rinj.fired]
    assert answers == ranswers
    assert rstore.fingerprints() == want
    rstore.wal.close()


def test_same_schedule_same_seed_replays_exactly(chaos_reference, tmp_path):
    batches, want, _ = chaos_reference
    points = [("wal.append.logged", 3, "torn_tail"),
              ("store.commit", 7, "crash")]
    fired, prints = [], []
    for run in ("a", "b"):
        path = tmp_path / f"{run}.wal"
        inj = faultinject.FaultInjector(points, seed=11)
        store, _ = drive(
            faultinject,
            lambda: stream.StreamStore(CG, aggs=CAGGS, wal=path, device=CPU),
            lambda: stream.StreamStore.recover(path, device=CPU), batches,
            inj)
        fired.append(inj.fired)
        prints.append(store.fingerprints())
        store.wal.close()
    assert fired[0] == fired[1] and len(fired[0]) == 2
    assert prints[0] == prints[1] == want


CATALOG = [
    ("wal.append", ("crash",)),
    ("wal.append.logged", ("crash", "torn_tail")),
    ("store.commit", ("crash",)),
    ("ckpt.save", ("crash",)),
]


def test_random_schedule_equals_reference():
    for seed in range(6):
        got = faultinject.random_schedule(seed, CATALOG, n_faults=3)
        want = ref_faults.random_schedule(seed, CATALOG, n_faults=3)
        assert [(p.site, p.hit, p.action) for p in got] == \
            [(p.site, p.hit, p.action) for p in want]
    with pytest.raises(ValueError):
        faultinject.FaultPoint("x", 0, "melt")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_chaos_sweep(chaos_reference, tmp_path, seed):
    batches, want, want_rows = chaos_reference
    points = faultinject.random_schedule(seed, CATALOG, n_faults=2)
    make, recover = _plain(stream, tmp_path / "a.wal",
                           str(tmp_path / "snaps"), device=CPU)
    inj = faultinject.FaultInjector(points, seed=seed)
    store, _ = drive(faultinject, make, recover, batches, inj, snap_at=4)
    assert store.fingerprints() == want
    assert store.rows == want_rows
    store.wal.close()


def test_windowed_chaos_preserves_decision_trail(tmp_path):
    rng = np.random.default_rng(2)
    feed, base = [], 0.0
    for _ in range(10):
        t = base + rng.uniform(-35.0, 15.0, 40)
        v = (rng.standard_normal(40) *
             np.exp(rng.uniform(-6, 6, 40))).astype(np.float32)
        k = rng.integers(0, 5, 40).astype(np.int32)
        feed.append((v, k, t))
        base += rng.uniform(0.0, 18.0)
    kw = dict(aggs=("sum", "count"), width=4.0, retention=6, device=CPU)
    plain = stream.WindowedStore(5, **kw)
    for b in feed:
        plain.ingest(*b)
    assert plain.late_dropped > 0 and plain.evictions > 0
    path = tmp_path / "w.wal"
    inj = faultinject.FaultInjector(
        [("wal.append.logged", 5, "torn_tail")], seed=3)
    store, _ = drive(
        faultinject, lambda: stream.WindowedStore(5, wal=path, **kw),
        lambda: stream.WindowedStore.recover(path, device=CPU), feed, inj)
    assert len(inj.fired) == 1
    assert store.fingerprints() == plain.fingerprints()
    assert (store.late_dropped, store.evictions, store._wids) == \
        (plain.late_dropped, plain.evictions, plain._wids)
    store.wal.close()


def test_failover_mid_stream_under_injected_crash(chaos_reference,
                                                  tmp_path):
    batches, want, want_rows = chaos_reference
    rep = stream.ReplicatedStore(CG, aggs=CAGGS, wal_path=tmp_path / "r.wal",
                                 snapshot_dir=str(tmp_path / "snaps"),
                                 device=CPU)
    inj = faultinject.FaultInjector([("wal.append", 5, "crash")], seed=0)
    with faultinject.active(inj):
        i = 0
        while i < len(batches):
            try:
                rep.ingest(*batches[i], client="chaos", seq=i)
                i += 1
            except faultinject.InjectedCrash:
                rep.crash_primary()
                assert rep.promote()["promoted"] == "follower0"
    assert len(inj.fired) == 1
    assert rep.fingerprints() == want
    assert rep.primary.rows == want_rows
    assert rep.ingest(*batches[0], client="chaos", seq=0)["duplicate"]
    rep.primary.wal.close()


def test_promotion_refuses_a_diverged_follower(chaos_reference, tmp_path):
    batches, _, _ = chaos_reference
    rep = stream.ReplicatedStore(CG, aggs=CAGGS, wal_path=tmp_path / "r.wal",
                                 device=CPU)
    for i, b in enumerate(batches[:4]):
        rep.ingest(*b, client="c", seq=i)
    rep.replicate()
    rep.followers[0].store.ingest(*batches[5])       # not in the log
    rep.crash_primary()
    with pytest.raises(stream.PromotionError):
        rep.promote()
    assert json.dumps(rep.query(), default=str)      # still served
