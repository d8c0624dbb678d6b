"""Persistent streaming aggregation store: ingest micro-batches, query
anytime, snapshot/restore bit-exactly — on the card unless the caller asks
for the CPU.

The store is a thin client of the partial/merge/finalize algebra
(:mod:`repro_torch.ops.partial`): one :class:`PartialState` plus a small
coalescing buffer of not-yet-merged batch partials, every leaf a tensor on
the store's device.  Its invariants are inherited:

* **micro-batch-size and ingest-order invariance** — ``merge(partial(A),
  partial(B)) == partial(A ++ B)`` bit for bit, and the merge commutes;
* **restart invariance** — a snapshot stores the state's bytes, restore
  verifies them against the manifest's byte-layout fingerprint
  (:func:`repro_torch.checkpoint.ckpt.verify_value`), and merging is a
  function of those bytes only.

Each micro-batch runs :class:`~repro_torch.ops.partial.PartialPipeline`,
which is ``partial_agg``'s own stage: on the card the segment kernel (G >
1) or the rsum kernel (G == 1) runs once per batch.  Coalescing
(``coalesce="auto"``, :func:`repro_torch.ops.plan.plan_partial`) buffers
several partials per store merge; it moves throughput only, never bits.

The JAX package's stores take ``compiled=`` to route prepare and merge
through cached XLA executables.  Nothing is compiled here — the prepare
stage is eager torch plus the hand-written kernels, and ``flush`` calls
``merge_all`` — so the argument is gone.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.accumulator import ReproAcc
from repro_torch.core.types import ReproSpec, dtype_name
from repro_torch.device import resolve_device
from repro_torch.obs import fingerprint as obs_fp
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.ops.partial import (AggSignature, PartialState,
                                     empty_partial, finalize, merge_all,
                                     pipeline_for, state_nbytes)
from repro_torch.ops.plan import PartialPlan, plan_partial
from repro_torch.runtime import faultinject
from repro_torch.stream.wal import (DedupIndex, WalUnavailable,
                                    WriteAheadLog, pack_parts, unpack_parts)

__all__ = ["StreamStore"]


def _nrows(values) -> int:
    """Rows of a batch given as a tensor, an array or nested lists."""
    if isinstance(values, torch.Tensor):
        return int(values.shape[0]) if values.ndim else 0
    v = np.asarray(values)
    return int(v.shape[0]) if v.ndim else 0


def _on(x, device: torch.device) -> torch.Tensor:
    """``x`` (tensor on any device, array or lists) as a tensor on
    ``device``; a tensor already there is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if not a.flags.writeable:          # e.g. a replayed WAL record's bytes
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _delivery_meta(client, seq) -> Optional[dict]:
    if client is None or seq is None:
        return None
    return {"client": str(client), "cseq": int(seq)}


class _DurableMixin:
    """WAL logging + exactly-once delivery shared by the stores.  The owning
    class provides ``sig``, ``device``, ``num_shards`` and the
    ``_commit_part`` shard interface; this mixin provides the write-ahead
    step, the read-only degradation latch and the replay helper."""

    _wal_kind = "stream"

    def _wal_params(self) -> dict:
        return {}

    def _init_durability(self, wal) -> None:
        if wal is not None and not isinstance(wal, WriteAheadLog):
            wal = WriteAheadLog(wal, sig=self.sig, kind=self._wal_kind,
                                params=self._wal_params())
        if wal is not None:
            if wal.sig != self.sig:
                raise ValueError("WAL belongs to a different store "
                                 "signature")
            if wal.last_seq > 0:
                raise ValueError(
                    f"WAL {wal.path} already holds {wal.last_seq} records; "
                    "rebuild the store with recover() instead of attaching "
                    "a non-empty log to a fresh one")
        self._wal: Optional[WriteAheadLog] = wal
        self.wal_seq = 0 if wal is None else wal.last_seq
        self.dedup = DedupIndex()
        self.read_only = False

    @property
    def wal(self) -> Optional[WriteAheadLog]:
        return self._wal

    def _check_writable(self) -> None:
        if self.read_only:
            raise WalUnavailable(
                "store is serving read-only: its WAL became unavailable "
                "and unlogged ingest would be lost on the next crash")

    def _log_record(self, arrays, kind: str, rec_meta: dict,
                    meta: Optional[dict]) -> bool:
        """The write-ahead step: reserve the delivery tag (False — a
        duplicate, don't log or apply anything), then append one record if
        there is anything to log and a WAL is attached.  Must run before
        the batch is applied.  On storage failure the store latches
        read-only and raises :class:`WalUnavailable` — the batch was
        neither logged nor applied (the failed tag reservation is moot:
        every later ingest is refused, and recovery rebuilds the index
        from the log, which does not hold the failed record)."""
        self._check_writable()
        if meta is not None and \
                not self.dedup.reserve(meta["client"], meta["cseq"]):
            return False
        if self._wal is not None and arrays:
            try:
                self.wal_seq = self._wal.append(arrays, kind=kind,
                                                meta=rec_meta)
            except (WalUnavailable, OSError) as e:
                self.read_only = True
                obs_metrics.counter("stream_wal_degraded_total").inc()
                obs_trace.event("stream.wal_degraded", error=str(e))
                if isinstance(e, WalUnavailable):
                    raise
                raise WalUnavailable(str(e)) from e
        return True

    def _log_parts(self, parts, meta: Optional[dict] = None) -> bool:
        """One ``"parts"`` record covering *every* prepared part of a batch
        (atomic in the log, however many shards the batch split into).
        False when the delivery tag turned out to be a duplicate."""
        states = [s for _, s, _ in parts if s is not None]
        rec_meta = dict(meta or {})
        rec_meta["shards"] = [int(i) for i, s, _ in parts if s is not None]
        return self._log_record(pack_parts(states) if states else {},
                                "parts", rec_meta, meta)

    def _apply_record(self, rec) -> None:
        """Replay one WAL record into the store, without re-logging it."""
        if rec.kind != "parts":
            raise ValueError(f"cannot replay record kind {rec.kind!r} "
                             "into a stream store")
        shards = rec.meta.get("shards") or [0]
        parts = unpack_parts(rec.arrays, self.sig, self.device)
        for i, (orig_idx, st) in enumerate(zip(shards, parts)):
            self._commit_part(int(orig_idx) % self.num_shards, st,
                              int(rec.arrays[f"p{i}/rows"]))

    def _replay(self, wal: WriteAheadLog, from_seq: int) -> int:
        """Apply every record with ``seq > from_seq``; absorb *every*
        record's delivery tag (duplicate suppression must cover retries of
        batches that are already inside the snapshot).  Replay never
        appends, so running it twice is idempotent by the seq cut."""
        applied = 0
        with obs_trace.span("stream.wal_replay", from_seq=from_seq):
            for rec in wal.records():
                self.dedup.absorb_meta(rec.meta)
                if rec.seq > from_seq:
                    self._apply_record(rec)
                    applied += 1
        obs_metrics.counter("stream_wal_replayed_records_total").inc(applied)
        return applied

    def _attach_wal(self, wal: WriteAheadLog) -> None:
        self._wal = wal
        self.wal_seq = wal.last_seq


def _state_tree(state: PartialState) -> dict:
    """The state as the plain-dict tree checkpoints store (the JAX
    package's layout, so snapshots cross between the packages)."""
    return {"table": {"k": state.table.k, "C": state.table.C,
                      "e1": state.table.e1},
            "minv": state.minv, "maxv": state.maxv, "rows": state.rows}


def _tree_state(tree: dict, sig: AggSignature) -> PartialState:
    t = tree["table"]
    return PartialState(table=ReproAcc(k=t["k"], C=t["C"], e1=t["e1"]),
                        minv=tree["minv"], maxv=tree["maxv"],
                        rows=tree["rows"], sig=sig)


class StreamStore(_DurableMixin):
    """Incrementally aggregated GROUPBY state over an unbounded row stream.

    Args:
      num_segments / aggs / spec / method / levels / check_finite: as in
        :func:`repro_torch.ops.groupby_agg`; fixed for the store's lifetime
        and recorded in its :class:`AggSignature`.
      coalesce: micro-batches to buffer per store merge.  ``"auto"``
        (default) lets :func:`plan_partial` pick from the first batch's
        size; an int pins it.  Throughput knob only.
      wal: a :class:`~repro_torch.stream.wal.WriteAheadLog` (or a path to
        create one) that every ingested delta is appended to before it is
        applied; ``recover(wal, snapshot_dir)`` rebuilds the store
        bit-exactly after a crash, and client-tagged deliveries commit
        exactly once.  An attached log must be empty.
      device: where the state lives and batches are aggregated (``None``:
        the card).
    """

    def __init__(self, num_segments: int, aggs=("sum",),
                 spec: Optional[ReproSpec] = None, method: str = "auto",
                 levels="auto", check_finite: bool = False,
                 coalesce="auto", wal=None, device=None):
        self.device = resolve_device(device)
        self.sig = AggSignature.build(aggs, num_segments, spec)
        self.method = method
        self.levels = tuple(levels) if isinstance(levels, list) else levels
        self.check_finite = check_finite
        self._pipeline = pipeline_for(self.sig, method, self.levels,
                                      check_finite, self.device)
        self._coalesce = coalesce
        self._state = empty_partial(num_segments, self.sig.aggs,
                                    self.sig.spec, device=self.device)
        self._pending: list[PartialState] = []
        self._plan = None
        self.batches = 0
        self.merged_batches = 0
        self._t_first_ingest: Optional[float] = None
        self._t_first_result: Optional[float] = None
        self._init_durability(wal)

    # -- ingest ------------------------------------------------------------

    def _ensure_plan(self, n: int) -> PartialPlan:
        if self._plan is None:
            self._plan = plan_partial(
                max(n, 1), self.sig.num_segments, self.sig.spec,
                ncols=max(self.sig.ncols, 1), backend=self.device.type,
                method=self.method)
        return self._plan

    def _coalesce_target(self, n: int) -> int:
        if self._coalesce != "auto":
            return max(int(self._coalesce), 1)
        return self._ensure_plan(n).coalesce

    def pipeline_width(self, n: int) -> int:
        """Concurrent ``prepare`` workers worth running for ``n``-row
        batches (the planner's Amdahl bound; see ``PartialPlan.pipeline``)."""
        return self._ensure_plan(n).pipeline

    def prepare(self, values, keys) -> Optional[PartialState]:
        """Stage 1 of ingest: aggregate one micro-batch (numpy arrays or
        tensors on any device, moved to the store's device) into a
        mergeable :class:`PartialState` — pure, touches no store state,
        safe on any number of threads.  ``None`` for an empty batch."""
        n = _nrows(values)
        if not n:
            return None
        t0 = time.perf_counter()
        with obs_trace.span("stream.prepare", rows=n):
            st = self._pipeline(values, keys)
        obs_metrics.histogram("stream_prepare_seconds").observe(
            time.perf_counter() - t0)
        return st

    def commit(self, state: Optional[PartialState], rows: int) -> dict:
        """Stage 2 of ingest: append a prepared partial to the coalescing
        buffer and flush when the planner's depth is reached.  The only
        stage that mutates the store; callers running ``prepare``
        concurrently serialize ``commit``, in any order."""
        self._check_writable()
        faultinject.fire("store.commit")
        t0 = time.perf_counter()
        n = int(rows)
        with obs_trace.span("stream.commit", rows=n) as sp:
            if state is not None:
                self._pending.append(state)
                if len(self._pending) >= self._coalesce_target(n):
                    self.flush()
            self.batches += 1
            if self._t_first_ingest is None:
                self._t_first_ingest = t0
            sp.set(pending=len(self._pending))
        obs_metrics.counter("stream_batches_total").inc()
        obs_metrics.counter("stream_rows_total").inc(n)
        obs_metrics.histogram("stream_commit_seconds").observe(
            time.perf_counter() - t0)
        obs_metrics.gauge("stream_pending_partials").set(len(self._pending))
        return {"rows": n, "batches": self.batches,
                "pending": len(self._pending),
                "merged": self.merged_batches}

    def _duplicate(self) -> dict:
        obs_metrics.counter("stream_duplicate_deliveries_total").inc()
        return {"rows": 0, "duplicate": True, "batches": self.batches,
                "pending": len(self._pending),
                "merged": self.merged_batches}

    def ingest(self, values, keys, client=None, seq=None) -> dict:
        """Aggregate one micro-batch into the store:
        ``commit(prepare(values, keys))``, with the write-ahead step
        between them when a WAL is attached.  Returns ``{rows, batches,
        pending, merged}``.  ``client``/``seq`` tag the delivery for
        exactly-once commit: a redelivered tag is answered
        ``{"duplicate": True}`` without touching the state."""
        meta = _delivery_meta(client, seq)
        if meta is not None and self.dedup.seen(meta["client"],
                                                meta["cseq"]):
            return self._duplicate()
        with obs_trace.span("stream.ingest"):
            st = self.prepare(values, keys)
            n = _nrows(values) if st is not None else 0
            if not self._log_parts([(0, st, n)], meta):
                return self._duplicate()
            return self.commit(st, n)

    # Uniform shard interface (the pipelined service drives stores through
    # these, so a plain store is the one-shard case of ShardedStreamStore).

    num_shards = 1

    def _prepare_parts(self, values, keys):
        """``[(shard_index, prepared_state_or_None, rows)]`` — pure."""
        return [(0, self.prepare(values, keys), _nrows(values))]

    def _commit_part(self, idx: int, state: Optional[PartialState],
                     rows: int) -> dict:
        assert idx == 0
        return self.commit(state, rows)

    def flush(self) -> None:
        """Merge every buffered partial into the persistent state."""
        if not self._pending:
            return
        t0 = time.perf_counter()
        with obs_trace.span("stream.merge", pending=len(self._pending)):
            self._state = merge_all([self._state] + self._pending)
        self.merged_batches += len(self._pending)
        self._pending = []
        obs_metrics.histogram("stream_merge_seconds").observe(
            time.perf_counter() - t0)

    @property
    def pending_bytes(self) -> int:
        """Bytes held by not-yet-merged partials (bounded by the coalescing
        depth)."""
        return sum(state_nbytes(s) for s in self._pending)

    def warmup(self, batch_rows: int) -> float:
        """Run the ingest path once for ``batch_rows``-sized batches into
        throwaways — ``prepare`` of a synthetic batch with a wide magnitude
        spread, one coalescing-depth merge and one ``finalize`` — and
        return the seconds spent.  On the card this builds the kernels the
        planner picks (their first use runs ``nvcc``), which would
        otherwise sit inside the first ingest's time to first result.  The
        store's state, counters and fingerprints are untouched."""
        n = max(int(batch_rows), 1)
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        nvals = max((int(c) + 1 for a in self.sig.aggs for c in a[1:]),
                    default=1)
        # magnitudes span wide but square-safely (var's sq column stays
        # finite in float32), signs mixed, every group id exercised
        mag = 10.0 ** rng.uniform(-18.0, 15.0, size=(n, nvals))
        v = (rng.standard_normal((n, nvals)) * mag).astype(
            dtype_name(self.sig.spec.dtype))
        k = (np.arange(n) % self.sig.num_segments).astype(np.int32)
        st = self.prepare(v, k)
        if st is not None:
            scratch = empty_partial(self.sig.num_segments, self.sig.aggs,
                                    self.sig.spec, device=self.device)
            depth = self._coalesce_target(n)
            finalize(merge_all([scratch] + [st] * depth))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        obs_trace.event("stream.warmup", rows=n, seconds=dt)
        obs_metrics.gauge("stream_warmup_seconds").set(dt)
        return dt

    # -- query -------------------------------------------------------------

    def state(self) -> PartialState:
        """The merged :class:`PartialState` over every ingested row."""
        self.flush()
        return self._state

    def query(self) -> dict:
        """Finalized results over everything ingested so far (a pure
        function of the canonical state: a query never perturbs the
        stream)."""
        with obs_trace.span("stream.query"):
            out = finalize(self.state())
        if self._t_first_result is None and self._t_first_ingest is not None:
            self._t_first_result = time.perf_counter()
            ttfr = self._t_first_result - self._t_first_ingest
            obs_metrics.gauge("stream_ttfr_seconds").set(ttfr)
            obs_trace.event("stream.ttfr", seconds=ttfr)
        obs_metrics.counter("stream_queries_total").inc()
        return out

    def fingerprints(self) -> dict:
        """Byte-layout digests of the current state and its finalized
        results — comparable with a one-shot ``groupby_agg(...,
        return_table=True)`` over the same rows, and with the JAX
        package's store."""
        st = self.state()
        return {"stream/table": obs_fp.fingerprint_table(st.table),
                "stream/results": obs_fp.fingerprint_results(finalize(st))}

    @property
    def rows(self) -> int:
        return int(self.state().rows)

    # -- snapshot / restore ------------------------------------------------

    def snapshot(self, directory: str, step: Optional[int] = None,
                 keep: int = 3) -> str:
        """Atomic checkpoint of the merged state; the manifest carries the
        signature and the state's byte-layout fingerprint."""
        st = self.state()
        if step is None:
            latest = ckpt.latest_step(directory)
            step = 0 if latest is None else latest + 1
        extra = {"kind": "stream_store",
                 "sig": self.sig.to_json(),
                 "batches": self.batches,
                 "wal_seq": self.wal_seq,
                 "fingerprints": self.fingerprints()}
        path = ckpt.save(directory, step, _state_tree(st), extra=extra,
                         keep=keep)
        obs_metrics.counter("stream_snapshots_total").inc()
        return path

    @classmethod
    def restore(cls, directory: str, step: Optional[int] = None,
                method: str = "auto", levels="auto",
                check_finite: bool = False, coalesce="auto",
                verify: bool = True, device=None) -> "StreamStore":
        """Rebuild a store from a snapshot (either package's), bit-exactly:
        the signature comes from the manifest, and with ``verify`` the
        restored tree is checked against the manifest's
        ``tree_fingerprint``."""
        manifest = ckpt.read_manifest(directory, step)
        extra = manifest["extra"]
        if extra.get("kind") != "stream_store":
            raise ValueError(f"checkpoint in {directory} is not a stream "
                             f"store snapshot (kind={extra.get('kind')!r})")
        sig = AggSignature.from_json(extra["sig"])
        store = cls(sig.num_segments, aggs=sig.aggs, spec=sig.spec,
                    method=method, levels=levels, check_finite=check_finite,
                    coalesce=coalesce, device=device)
        skeleton = _state_tree(store._state)
        tree, _ = ckpt.restore(directory, skeleton, step=manifest["step"],
                               device=store.device)
        if verify:
            ckpt.verify_value(tree, directory, step=manifest["step"])
        store._state = _tree_state(tree, sig)
        store.batches = int(extra.get("batches", 0))
        store.merged_batches = store.batches
        store.wal_seq = int(extra.get("wal_seq", 0))
        obs_metrics.counter("stream_restores_total").inc()
        return store

    @classmethod
    def recover(cls, wal, snapshot_dir: Optional[str] = None,
                method: str = "auto", levels="auto",
                check_finite: bool = False, coalesce="auto",
                device=None) -> "StreamStore":
        """Rebuild a crashed store from durable state only: the newest
        verifiable snapshot plus an idempotent replay of every strictly
        newer WAL record (either package's log).  Opening the log
        truncates a torn tail first; the dedup index is rebuilt from the
        record metas, and the WAL stays attached for new ingest."""
        if not isinstance(wal, WriteAheadLog):
            wal = WriteAheadLog(wal)
        with obs_trace.span("stream.recover", wal_last_seq=wal.last_seq):
            kwargs = dict(method=method, levels=levels,
                          check_finite=check_finite, coalesce=coalesce,
                          device=device)
            store = None
            if snapshot_dir is not None:
                store = _restore_best_snapshot(cls, snapshot_dir, wal.sig,
                                               kwargs)
            if store is None:
                store = cls(wal.sig.num_segments, aggs=wal.sig.aggs,
                            spec=wal.sig.spec, **kwargs)
            store._replay(wal, from_seq=store.wal_seq)
            store._attach_wal(wal)
        obs_metrics.counter("stream_recoveries_total").inc()
        return store


def _restore_best_snapshot(cls, directory: str, sig, kwargs):
    """Newest snapshot in ``directory`` that restores *and* verifies, or
    None.  A corrupt snapshot is skipped loudly, not trusted silently."""
    if not os.path.isdir(directory):
        return None
    steps = sorted((int(d.split("_")[1]) for d in os.listdir(directory)
                    if d.startswith("step_")), reverse=True)
    for step in steps:
        try:
            store = cls.restore(directory, step=step, verify=True, **kwargs)
        except Exception as e:  # corrupt/partial/foreign: fall back
            obs_metrics.counter("stream_snapshot_rejects_total").inc()
            obs_trace.event("stream.snapshot_rejected", step=step,
                            error=f"{type(e).__name__}: {e}")
            continue
        if store.sig != sig:
            obs_metrics.counter("stream_snapshot_rejects_total").inc()
            continue
        return store
    return None
