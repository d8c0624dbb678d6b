"""Async ingest/query endpoint for the streaming aggregation store.

Concurrency model: ingest is a two-stage pipeline.  ``prepare`` — the
whole aggregation of a micro-batch into a :class:`PartialState` — is pure,
so the service runs it on a sized ``ThreadPoolExecutor`` with no lock
held.  Only ``commit`` mutates the store, behind a per-shard
``asyncio.Lock``.  Every admitted batch becomes a partial merged by the
exact commutative ``merge``, so any interleaving of writers yields the
bit-identical store state.

On the card every prepare worker launches on PyTorch's current stream of
its thread, which is the device's default stream: launches from all
workers serialize there, in the order they are issued.  That is what the
rsum kernel's per-(device, stream) workspace relies on, and it means a
state prepared on one worker is complete, in stream order, before any
merge that reads it.  The workers overlap their host work (the eager
launches and the planner), not their kernels.

Backpressure: admitted-but-uncommitted batches are metered against
``inflight_budget`` bytes; over budget, an ingest awaits capacity
(``backpressure="wait"``) or fails fast (``"reject"``) — a batch is
admitted exactly once or not at all.  ``query``/``fingerprints``/
``snapshot``/``stats`` drain in-flight prepares and take every shard lock
first.  ``pipelined=False`` is one global lock around whole store calls.

Wire protocol: newline-delimited JSON (NDJSON) over a plain socket:

  -> {"op": "ingest", "values": [[...], ...], "keys": [...],
      "client": "c0", "seq": 7}        # client/seq optional: exactly-once
  -> {"op": "query"}
  -> {"op": "fingerprints"}
  -> {"op": "snapshot", "directory": "..."}
  -> {"op": "stats"}
  <- {"ok": true, ...}  |  {"ok": false, "error": "..."}

CLI (on the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.stream.service --groups 64 \
      --aggs sum count mean --port 8765 [--device cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import dtype_name
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.failures import exponential_backoff
from repro_torch.stream.sharded import ShardedStreamStore
from repro_torch.stream.store import StreamStore, _delivery_meta, _nrows
from repro_torch.stream.wal import WalUnavailable

__all__ = ["Backpressure", "StreamService", "serve"]


def _batch(x):
    """A batch as it was given when it is a tensor, else a numpy array."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.nbytes)

#: default in-flight byte budget: plenty for thousands of typical
#: micro-batches, small enough that a runaway burst can't OOM the host
DEFAULT_INFLIGHT_BUDGET = 1 << 26  # 64 MiB


class Backpressure(RuntimeError):
    """Raised (and reported inline over the wire) when an ingest is
    refused because the in-flight queue is over budget."""


class StreamService:
    """Pipelined async facade over a :class:`StreamStore` /
    :class:`ShardedStreamStore` (or any object with the shard interface:
    ``_prepare_parts`` / ``_commit_part`` / ``num_shards`` plus
    ``query/fingerprints/snapshot``).

    Args:
      store: the underlying store.
      pipelined: run ``prepare`` on an executor outside the locks
        (default).  ``False``: one global lock around whole store calls.
      max_workers: prepare-pool size; default asks the store's planner
        (``pipeline_width`` of the first batch seen).
      inflight_budget: bytes of admitted-but-uncommitted batches allowed
        before backpressure engages.
      backpressure: ``"wait"`` (await capacity; default) or ``"reject"``
        (fail the over-budget ingest inline).
      max_retries: how many times an ingest refused by ``"reject"``
        backpressure is retried in-service before the refusal reaches the
        client.  Delays come from
        :func:`repro_torch.runtime.failures.exponential_backoff` —
        deterministic (no jitter), so retry schedules are reproducible.
      retry_backoff_s: the backoff base delay (0 disables sleeping).
      request_timeout: per-request deadline in seconds.  A request that
        misses it is answered ``{"ok": false, "timeout": true}`` while the
        underlying operation *runs to completion in the background* —
        cancelling a half-done commit could tear a batch, and completion
        keeps the exactly-once story simple: a client that saw a timeout
        retries with the same ``(client, seq)`` tag and is deduplicated.
    """

    def __init__(self, store, pipelined: bool = True,
                 max_workers: Optional[int] = None,
                 inflight_budget: int = DEFAULT_INFLIGHT_BUDGET,
                 backpressure: str = "wait", max_retries: int = 0,
                 retry_backoff_s: float = 0.05,
                 request_timeout: Optional[float] = None):
        if backpressure not in ("wait", "reject"):
            raise ValueError(
                f"backpressure must be 'wait' or 'reject', got "
                f"{backpressure!r}")
        self.store = store
        self.pipelined = bool(pipelined)
        self.backpressure = backpressure
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.request_timeout = request_timeout
        self._budget = int(inflight_budget)
        self._max_workers = max_workers
        self._executor: Optional[ThreadPoolExecutor] = None
        self._lock = asyncio.Lock()  # serialized mode: the one global lock
        nshards = getattr(store, "num_shards", 1)
        self._locks = [asyncio.Lock() for _ in range(nshards)]
        self._cond = asyncio.Condition()
        self._inflight = 0
        self._inflight_bytes = 0

    # -- serialized mode: one global lock around whole store calls ---------

    async def _run(self, fn, *args):
        loop = asyncio.get_running_loop()
        async with self._lock:
            return await loop.run_in_executor(None, fn, *args)

    # -- pipelined mode ----------------------------------------------------

    def _pool(self, batch_rows: int) -> ThreadPoolExecutor:
        """Prepare pool, sized lazily: the planner's pipeline width for the
        first batch size seen (or the explicit ``max_workers``)."""
        if self._executor is None:
            width = self._max_workers or max(
                self.store.pipeline_width(max(batch_rows, 1)), 1)
            self._executor = ThreadPoolExecutor(
                max_workers=width, thread_name_prefix="stream-prepare")
            obs_metrics.gauge("stream_service_prepare_workers").set(width)
            obs_trace.event("stream.pool", workers=width)
        return self._executor

    async def _admit(self, nbytes: int) -> None:
        """Count a batch into the in-flight queue, applying backpressure.
        A single over-budget batch is still admitted when the queue is
        empty (otherwise it could never run); budget only throttles
        *accumulation*."""
        async with self._cond:
            over = (lambda: self._inflight > 0
                    and self._inflight_bytes + nbytes > self._budget)
            if over():
                if self.backpressure == "reject":
                    obs_metrics.counter(
                        "stream_service_backpressure_rejects_total").inc()
                    raise Backpressure(
                        f"in-flight bytes {self._inflight_bytes} + {nbytes} "
                        f"exceed budget {self._budget}; retry later")
                obs_metrics.counter(
                    "stream_service_backpressure_waits_total").inc()
                with obs_trace.span("stream.backpressure", bytes=nbytes):
                    await self._cond.wait_for(lambda: not over())
            self._inflight += 1
            self._inflight_bytes += nbytes
            obs_metrics.gauge("stream_service_inflight").set(self._inflight)
            obs_metrics.gauge("stream_service_inflight_bytes").set(
                self._inflight_bytes)

    async def _release(self, nbytes: int) -> None:
        async with self._cond:
            self._inflight -= 1
            self._inflight_bytes -= nbytes
            obs_metrics.gauge("stream_service_inflight").set(self._inflight)
            obs_metrics.gauge("stream_service_inflight_bytes").set(
                self._inflight_bytes)
            self._cond.notify_all()

    async def _exclusive(self, fn, *args):
        """Run ``fn`` with the store quiesced: every in-flight prepare
        committed (drain) and every shard lock held (in index order, so two
        exclusive ops can't deadlock).  This is how ``query`` / ``snapshot``
        / ``stats`` keep their serialized-service contracts."""
        async with self._cond:
            await self._cond.wait_for(lambda: self._inflight == 0)
        loop = asyncio.get_running_loop()
        async with contextlib.AsyncExitStack() as stack:
            for lock in self._locks:
                await stack.enter_async_context(lock)
            return await loop.run_in_executor(None, fn, *args)

    async def _ingest_pipelined(self, values, keys, meta=None) -> dict:
        loop = asyncio.get_running_loop()
        v, k = _batch(values), _batch(keys)
        nbytes = _nbytes(v) + _nbytes(k)
        nrows = _nrows(v)
        await self._admit(nbytes)
        try:
            with obs_trace.span("stream.service_ingest", rows=nrows) as sp:
                parts = await loop.run_in_executor(
                    self._pool(nrows), self.store._prepare_parts, v, k)
                # the write-ahead step: one record for the whole batch,
                # before any shard lock is taken (WAL appends serialize on
                # the log's own lock; the fsync happens off the event loop)
                if meta is not None or \
                        getattr(self.store, "wal", None) is not None:
                    fresh = await loop.run_in_executor(
                        None, self.store._log_parts, parts, meta)
                    if not fresh:
                        obs_metrics.counter(
                            "stream_duplicate_deliveries_total").inc()
                        return {"rows": 0, "duplicate": True}
                out, rows = {}, 0
                for idx, state, n in parts:
                    async with self._locks[idx]:
                        out = await loop.run_in_executor(
                            None, self.store._commit_part, idx, state, n)
                    rows += n
                sp.set(parts=len(parts))
            out["rows"] = rows
            return out
        finally:
            await self._release(nbytes)

    # -- operations --------------------------------------------------------

    async def _ingest_once(self, values, keys, meta) -> dict:
        if self.pipelined:
            return await self._ingest_pipelined(values, keys, meta)
        if meta is not None:
            return await self._run(
                lambda: self.store.ingest(values, keys,
                                          client=meta["client"],
                                          seq=meta["cseq"]))
        return await self._run(self.store.ingest, values, keys)

    async def ingest(self, values, keys, client=None, seq=None) -> dict:
        t0 = time.perf_counter()
        meta = _delivery_meta(client, seq)
        dedup = getattr(self.store, "dedup", None)
        if meta is not None and dedup is not None and \
                dedup.seen(meta["client"], meta["cseq"]):
            obs_metrics.counter("stream_duplicate_deliveries_total").inc()
            return {"rows": 0, "duplicate": True}
        attempt = 0
        while True:
            try:
                out = await self._ingest_once(values, keys, meta)
                break
            except Backpressure:
                if attempt >= self.max_retries:
                    raise
                delay = exponential_backoff(self.retry_backoff_s, attempt)
                attempt += 1
                obs_metrics.counter(
                    "stream_service_ingest_retries_total").inc()
                if delay:
                    await asyncio.sleep(delay)
        obs_metrics.histogram("stream_service_ingest_seconds").observe(
            time.perf_counter() - t0)
        return out

    async def _guarded(self, fn, *args):
        return await (self._exclusive(fn, *args) if self.pipelined
                      else self._run(fn, *args))

    async def query(self) -> dict:
        out = await self._guarded(self.store.query)
        return {k: v.cpu().tolist() for k, v in out.items()}

    async def fingerprints(self) -> dict:
        return await self._guarded(self.store.fingerprints)

    async def snapshot(self, directory: str) -> str:
        return await self._guarded(self.store.snapshot, directory)

    async def stats(self) -> dict:
        # one closure, run with the store quiesced/locked: the three
        # counters are read as a consistent set, never mid-commit
        def read():
            return {"batches": self.store.batches,
                    "merged_batches": self.store.merged_batches,
                    "rows": self.store.rows,
                    "read_only": bool(getattr(self.store, "read_only",
                                              False)),
                    "wal_seq": int(getattr(self.store, "wal_seq", 0))}
        return await self._guarded(read)

    async def _with_deadline(self, coro):
        """Apply the per-request deadline.  The operation is shielded and
        left to finish in the background on timeout (see the class
        docstring for why cancellation would be worse)."""
        if self.request_timeout is None:
            return await coro
        task = asyncio.ensure_future(coro)
        try:
            return await asyncio.wait_for(asyncio.shield(task),
                                          self.request_timeout)
        except asyncio.TimeoutError:
            task.add_done_callback(lambda t: t.cancelled() or t.exception())
            raise

    async def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ingest":
            values = np.asarray(req["values"],
                                dtype_name(self.store.sig.spec.dtype))
            keys = np.asarray(req["keys"], np.int32)
            return {"ok": True,
                    **(await self.ingest(values, keys,
                                         client=req.get("client"),
                                         seq=req.get("seq")))}
        if op == "query":
            return {"ok": True, "results": await self.query()}
        if op == "fingerprints":
            return {"ok": True, "fingerprints": await self.fingerprints()}
        if op == "snapshot":
            return {"ok": True,
                    "path": await self.snapshot(req["directory"])}
        if op == "stats":
            return {"ok": True, **(await self.stats())}
        return {"ok": False, "error": f"unknown op {op!r}"}

    async def handle(self, req: dict) -> dict:
        try:
            return await self._with_deadline(self._dispatch(req))
        except asyncio.TimeoutError:
            obs_metrics.counter("stream_service_timeouts_total").inc()
            return {"ok": False, "timeout": True,
                    "error": f"deadline ({self.request_timeout}s) "
                             "exceeded; operation completes in background "
                             "— retry with the same (client, seq) tag"}
        except WalUnavailable as e:
            obs_metrics.counter("stream_service_errors_total").inc()
            return {"ok": False, "read_only": True,
                    "error": f"{type(e).__name__}: {e}"}
        except Exception as e:  # protocol boundary: report, don't die
            obs_metrics.counter("stream_service_errors_total").inc()
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    async def client(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter):
        obs_metrics.counter("stream_service_connections_total").inc()
        try:
            while True:
                try:
                    line = await reader.readline()
                except ValueError:
                    # line exceeded the stream limit: report and drop the
                    # connection (the buffer is beyond recovery)
                    writer.write(json.dumps(
                        {"ok": False,
                         "error": "line too long (raise serve(limit=...))"}
                    ).encode() + b"\n")
                    await writer.drain()
                    break
                if not line:
                    break
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"ok": False, "error": f"bad json: {e}"}
                else:
                    resp = await self.handle(req)
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def close(self) -> None:
        """Shut down the prepare pool (idempotent)."""
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None


#: per-line stream buffer: NDJSON ingest lines carry whole micro-batches as
#: text, so the asyncio default of 64 KiB (~1500 rows) is far too small
LINE_LIMIT = 2 ** 24


async def serve(store, host: str = "127.0.0.1", port: int = 0,
                limit: int = LINE_LIMIT, **service_kwargs):
    """Start the NDJSON endpoint; returns the ``asyncio.Server`` (its
    ``sockets[0].getsockname()`` carries the bound port when ``port=0``).
    Extra keyword args configure :class:`StreamService` (``pipelined``,
    ``max_workers``, ``inflight_budget``, ``backpressure``)."""
    service = StreamService(store, **service_kwargs)
    server = await asyncio.start_server(service.client, host, port,
                                        limit=limit)
    addr = server.sockets[0].getsockname()
    obs_trace.event("stream.serve", host=addr[0], port=addr[1],
                    G=store.sig.num_segments, device=str(store.device),
                    pipelined=service.pipelined,
                    shards=getattr(store, "num_shards", 1))
    return server


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.stream.service")
    ap.add_argument("--groups", type=int, required=True)
    ap.add_argument("--aggs", nargs="+", default=["sum"])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--shards", type=int, default=1,
                    help="shard count (>1 builds a ShardedStreamStore)")
    ap.add_argument("--policy", default="round_robin",
                    choices=["round_robin", "key_hash"])
    ap.add_argument("--serialized", action="store_true",
                    help="disable the prepare/commit pipeline")
    ap.add_argument("--wal", default=None, metavar="PATH",
                    help="write-ahead log file (durable ingest; an "
                         "existing log is recovered and resumed)")
    ap.add_argument("--snapshots", default=None, metavar="DIR",
                    help="snapshot directory consulted on recovery")
    ap.add_argument("--warmup", type=int, default=0, metavar="ROWS",
                    help="run the ingest path once for this batch size "
                         "(on the card: builds the kernels)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the store lives (default: the card)")
    args = ap.parse_args(argv)

    async def run():
        resume = args.wal is not None and os.path.exists(args.wal)
        dev = args.device
        if args.shards > 1:
            if resume:
                store = ShardedStreamStore.recover(
                    args.wal, args.snapshots, num_shards=args.shards,
                    policy=args.policy, device=dev)
            else:
                store = ShardedStreamStore(args.groups,
                                           aggs=tuple(args.aggs),
                                           num_shards=args.shards,
                                           policy=args.policy, wal=args.wal,
                                           device=dev)
        else:
            if resume:
                store = StreamStore.recover(args.wal, args.snapshots,
                                            device=dev)
            else:
                store = StreamStore(args.groups, aggs=tuple(args.aggs),
                                    wal=args.wal, device=dev)
        if resume:
            print(f"recovered from {args.wal}: wal_seq={store.wal_seq}, "
                  f"rows={store.rows}", flush=True)
        if args.warmup:
            dt = store.warmup(args.warmup)
            print(f"warmup({args.warmup} rows): {dt:.3f}s", flush=True)
        server = await serve(store, args.host, args.port,
                             pipelined=not args.serialized)
        addr = server.sockets[0].getsockname()
        print(f"stream service on {addr[0]}:{addr[1]} "
              f"(G={args.groups}, aggs={args.aggs}, shards={args.shards}, "
              f"device={store.device}); "
              f"NDJSON ops: ingest/query/fingerprints/snapshot/stats",
              flush=True)
        async with server:
            await server.serve_forever()

    asyncio.run(run())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
