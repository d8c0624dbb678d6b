"""The port's stream service, in process (``handle()``) and over a socket
bound to port 0, and its NDJSON CLI on the CPU: concurrent writers equal
one-shot ``groupby_agg`` and the JAX package's store, exactly-once
redelivery, backpressure, deadlines, and recovery of the CLI from its WAL.
"""
import asyncio
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.stream as ref_stream  # noqa: E402
from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro_torch import stream  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.obs import fingerprint as fp  # noqa: E402
from repro_torch.ops import groupby_agg  # noqa: E402
from repro_torch.stream import service as svc_mod  # noqa: E402

G = 17
AGGS = ("sum", "count", "mean", "min", "max", ("sum", 1))
SPEC = ReproSpec(dtype=torch.float32, L=2)
CPU = "cpu"
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """One torch thread per test process: the suite runs several worker
    processes on the host at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(nb=8, n=2400, seed=0):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n, 2)) *
         np.exp(rng.uniform(-10, 10, (n, 2)))).astype(np.float32)
    k = rng.integers(0, G, n).astype(np.int32)
    idx = np.array_split(np.arange(n), nb)
    return [(v[i], k[i]) for i in idx]


@pytest.fixture(scope="module")
def reference():
    batches = _batches()
    v = np.concatenate([b[0] for b in batches])
    k = np.concatenate([b[1] for b in batches])
    res, tab = groupby_agg(v, k, G, AGGS, SPEC, return_table=True,
                           device=CPU)
    want = {"stream/table": fp.fingerprint_table(tab),
            "stream/results": fp.fingerprint_results(res)}
    ref = ref_stream.StreamStore(G, AGGS, RefSpec(dtype=jnp.float32, L=2))
    for b in batches:
        ref.ingest(*b)
    assert ref.fingerprints() == want
    return batches, want


async def _writers(service, batches, writers):
    async def writer(w):
        for j in range(w, len(batches), writers):
            out = await service.ingest(*batches[j], client=f"w{w}", seq=j)
            assert out["rows"] == len(batches[j][1])
    await asyncio.gather(*(writer(w) for w in range(writers)))


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "serialized"])
@pytest.mark.parametrize("shards", [1, 3])
def test_concurrent_writers_equal_oneshot(reference, pipelined, shards):
    batches, want = reference
    store = (stream.StreamStore(G, AGGS, SPEC, device=CPU) if shards == 1
             else stream.ShardedStreamStore(G, AGGS, SPEC, num_shards=shards,
                                            policy="key_hash", device=CPU))
    service = stream.StreamService(store, pipelined=pipelined,
                                   max_workers=3)

    async def run():
        await _writers(service, batches, writers=4)
        dup = await service.ingest(*batches[2], client="w2", seq=2)
        return dup, await service.fingerprints(), await service.stats()
    dup, got, stats = asyncio.run(run())
    service.close()
    assert dup == {"rows": 0, "duplicate": True}
    assert got == want
    assert stats["batches"] >= len(batches) and stats["rows"] == 2400


def test_stress_more_writers_than_cores(reference):
    """16 writers, a prepare pool wider than the host, a short switch
    interval: any interleaving commits every batch exactly once."""
    batches, want = reference
    many = [(v[i::2], k[i::2]) for v, k in batches for i in range(2)]
    store = stream.StreamStore(G, AGGS, SPEC, coalesce=3, device=CPU)
    service = stream.StreamService(store, max_workers=(os.cpu_count() or 1)
                                   + 2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        async def run():
            await asyncio.wait_for(_writers(service, many, writers=16), 120)
            return await service.fingerprints()
        got = asyncio.run(run())
    finally:
        sys.setswitchinterval(old)
        service.close()
    assert got == want and store.batches == len(many)


def test_handle_speaks_the_wire_protocol(reference, tmp_path):
    batches, want = reference
    service = stream.StreamService(stream.StreamStore(G, AGGS, SPEC,
                                                      device=CPU))

    async def run():
        outs = []
        for j, (v, k) in enumerate(batches):
            outs.append(await service.handle(
                {"op": "ingest", "values": v.tolist(), "keys": k.tolist(),
                 "client": "c", "seq": j}))
        outs.append(await service.handle(
            {"op": "ingest", "values": batches[0][0].tolist(),
             "keys": batches[0][1].tolist(), "client": "c", "seq": 0}))
        outs.append(await service.handle({"op": "fingerprints"}))
        outs.append(await service.handle({"op": "query"}))
        outs.append(await service.handle(
            {"op": "snapshot", "directory": str(tmp_path)}))
        outs.append(await service.handle({"op": "stats"}))
        outs.append(await service.handle({"op": "nope"}))
        outs.append(await service.handle({"op": "ingest", "values": [[1.0]],
                                          "keys": [1, 2]}))
        return outs
    outs = asyncio.run(run())
    service.close()
    assert all(o["ok"] for o in outs[:len(batches)])
    assert outs[len(batches)]["duplicate"] is True
    assert outs[len(batches) + 1]["fingerprints"] == want
    results = outs[len(batches) + 2]["results"]
    assert sorted(results) == sorted(["sum(0)", "count(*)", "mean(0)",
                                      "min(0)", "max(0)", "sum(1)"])
    assert len(results["count(*)"]) == G
    restored = stream.StreamStore.restore(str(tmp_path), device=CPU)
    assert restored.fingerprints() == want
    assert outs[-3]["wal_seq"] == 0 and not outs[-3]["read_only"]
    assert not outs[-2]["ok"] and "unknown op" in outs[-2]["error"]
    assert not outs[-1]["ok"] and "disagree" in outs[-1]["error"]


def test_backpressure_reject_retries_and_wait(reference):
    batches, want = reference
    nbytes = batches[0][0].nbytes + batches[0][1].nbytes
    for mode in ("reject", "wait"):
        store = stream.StreamStore(G, AGGS, SPEC, device=CPU)
        service = stream.StreamService(
            store, inflight_budget=nbytes + 1, backpressure=mode,
            max_retries=50, retry_backoff_s=0.001, max_workers=2)

        async def run():
            await _writers(service, batches, writers=4)
            return await service.fingerprints()
        assert asyncio.run(run()) == want
        service.close()
    with pytest.raises(ValueError, match="backpressure"):
        stream.StreamService(store, backpressure="drop")


class _GatedStore(stream.StreamStore):
    """A store whose ``prepare`` waits for a gate: the deadline must fire
    while the ingest cannot finish, whatever the machine's load."""

    gate = None

    def prepare(self, values, keys):
        assert self.gate.wait(60), "the test never opened the gate"
        return super().prepare(values, keys)


def test_deadline_answers_timeout_and_the_ingest_completes(reference):
    batches, _ = reference
    store = _GatedStore(G, AGGS, SPEC, device=CPU)
    store.gate = threading.Event()
    service = stream.StreamService(store, request_timeout=3.0)

    async def run():
        out = await service.handle(
            {"op": "ingest", "values": batches[0][0].tolist(),
             "keys": batches[0][1].tolist(), "client": "c", "seq": 0})
        store.gate.set()
        retry = await service.handle(
            {"op": "ingest", "values": batches[0][0].tolist(),
             "keys": batches[0][1].tolist(), "client": "c", "seq": 0})
        return out, retry, await service.handle({"op": "stats"})
    out, retry, stats = asyncio.run(run())
    service.close()
    assert out["ok"] is False and out["timeout"] is True
    assert retry["ok"] and (retry.get("duplicate") or retry["rows"])
    assert stats["rows"] == len(batches[0][1])


def test_serve_over_a_socket_on_port_0(reference):
    batches, want = reference

    async def run():
        server = await stream.serve(stream.StreamStore(G, AGGS, SPEC,
                                                       device=CPU), port=0)
        host, port = server.sockets[0].getsockname()[:2]
        reader, writer = await asyncio.open_connection(host, port,
                                                       limit=1 << 24)
        for j, (v, k) in enumerate(batches):
            writer.write(json.dumps({"op": "ingest", "values": v.tolist(),
                                     "keys": k.tolist()}).encode() + b"\n")
            await writer.drain()
            assert json.loads(await reader.readline())["ok"]
        writer.write(b"{not json\n" + json.dumps(
            {"op": "fingerprints"}).encode() + b"\n")
        await writer.drain()
        bad = json.loads(await reader.readline())
        fps = json.loads(await reader.readline())
        writer.close()
        await writer.wait_closed()
        server.close()
        await server.wait_closed()
        return bad, fps
    bad, fps = asyncio.run(asyncio.wait_for(run(), 120))
    assert not bad["ok"] and "bad json" in bad["error"]
    assert fps["fingerprints"] == want


def _start_cli(args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.stream.service", *args],
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    lines = []
    while True:
        line = proc.stdout.readline()
        if not line:
            proc.kill()
            raise AssertionError("service exited: " + "".join(lines))
        lines.append(line)
        if line.startswith("stream service on "):
            host, port = line.split()[3].rsplit(":", 1)
            return proc, host, int(port), lines


def _ask(host, port, reqs):
    async def run():
        reader, writer = await asyncio.open_connection(host, port,
                                                       limit=1 << 24)
        outs = []
        for req in reqs:
            writer.write(json.dumps(req).encode() + b"\n")
            await writer.drain()
            outs.append(json.loads(await reader.readline()))
        writer.close()
        await writer.wait_closed()
        return outs
    return asyncio.run(asyncio.wait_for(run(), 120))


def test_cli_on_the_cpu_recovers_from_its_wal(reference, tmp_path):
    batches, want = reference
    wal = str(tmp_path / "svc.wal")
    args = ["--groups", str(G), "--aggs", "sum", "count", "--port", "0",
            "--wal", wal, "--device", "cpu"]
    ingest = [{"op": "ingest", "values": v.tolist(), "keys": k.tolist(),
               "client": "c", "seq": j} for j, (v, k) in enumerate(batches)]
    proc, host, port, _ = _start_cli(args)
    try:
        outs = _ask(host, port, ingest + [{"op": "fingerprints"}])
    finally:
        proc.kill()                          # the process dies, the log stays
        proc.communicate(timeout=60)
    assert all(o["ok"] for o in outs)
    proc, host, port, lines = _start_cli(args)
    try:
        again = _ask(host, port, [ingest[-1], {"op": "fingerprints"}])
    finally:
        proc.kill()
        proc.communicate(timeout=60)
    assert any(line.startswith("recovered from") for line in lines)
    assert again[0]["duplicate"] is True
    assert again[1]["fingerprints"] == outs[-1]["fingerprints"]
    # the same batches into an in-process store: the same bits
    store = stream.StreamStore(G, ("sum", "count"), device=CPU)
    for b in batches:
        store.ingest(*b)
    assert again[1]["fingerprints"] == store.fingerprints()


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        svc_mod.main(["--groups", "3", "--port", "0"])
