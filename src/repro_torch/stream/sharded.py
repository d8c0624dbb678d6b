"""Sharded streaming store: N independent :class:`StreamStore` shards
behind the single-store interface, merged exactly at query time.

Each shard owns a private state and coalescing buffer, so under the
pipelined service each shard commits behind its own lock.  The queryable
state is ``merge_all`` over the shard states; since the merge is
commutative and associative over states with equal signatures, any
assignment of batches to shards is another partition of the row multiset
and the result is bit-identical to a single store.

Two deterministic assignment policies, the JAX package's:

* ``"round_robin"`` — whole batches cycle through shards in arrival order;
* ``"key_hash"`` — rows split by a fixed avalanche hash of the group key
  (the same multiplier and shift), so a group's rows always land on the
  same shard.  The split runs on the store's device: a card batch is
  hashed and partitioned on the card.
"""
from __future__ import annotations

import itertools
import os
from typing import Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.types import ReproSpec
from repro_torch.obs import fingerprint as obs_fp
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.ops.partial import (AggSignature, PartialState, finalize,
                                     merge_all)
from repro_torch.stream.store import (StreamStore, _DurableMixin,
                                      _delivery_meta, _nrows, _on,
                                      _restore_best_snapshot, _state_tree,
                                      _tree_state)
from repro_torch.stream.wal import WriteAheadLog

__all__ = ["ShardedStreamStore"]

# Fibonacci-multiply avalanche (the 64-bit golden-ratio constant); >> 33
# keeps the well-mixed high bits so ``% nshards`` is unbiased even for
# sequential keys.  Fixed: the hash is part of the deterministic assignment.
# torch has no uint64 arithmetic on the card, so the product is taken in
# int64 (the same bits mod 2^64) as its signed spelling, and the logical
# shift masks off the sign the arithmetic shift drags in.
_HASH_MULT = 0x9E3779B97F4A7C15 - (1 << 64)
_HASH_SHIFT = 33

_POLICIES = ("round_robin", "key_hash")


class ShardedStreamStore(_DurableMixin):
    """N independent shard stores presenting the one-store interface.

    Args:
      num_segments / aggs / spec / method / levels / check_finite /
        coalesce / device: as in :class:`StreamStore`; applied to every
        shard (all shards share one :class:`AggSignature`).
      num_shards: shard count.  Throughput/layout knob only — the merged
        state is bit-identical for any value (pinned by tests).
      policy: ``"round_robin"`` (whole batches cycle shards) or
        ``"key_hash"`` (rows split by group-key hash).
      wal: as in :class:`StreamStore` — one log for the whole sharded
        store, not one per shard.  A batch that splits across shards is
        logged as *one* record (all parts, with their shard indices), so
        the log is atomic per batch and a replay onto any other shard
        count is just another legal partition of the row multiset.
    """

    def __init__(self, num_segments: int, aggs=("sum",),
                 spec: Optional[ReproSpec] = None, method: str = "auto",
                 levels="auto", check_finite: bool = False,
                 coalesce="auto", num_shards: int = 2,
                 policy: str = "round_robin", wal=None, device=None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if policy not in _POLICIES:
            raise ValueError(f"unknown policy {policy!r}; want {_POLICIES}")
        self.num_shards = int(num_shards)
        self.policy = policy
        self._shards = [
            StreamStore(num_segments, aggs=aggs, spec=spec, method=method,
                        levels=levels, check_finite=check_finite,
                        coalesce=coalesce, device=device)
            for _ in range(self.num_shards)]
        self.sig = self._shards[0].sig
        self.device = self._shards[0].device
        # itertools.count is GIL-atomic, so round-robin assignment needs no
        # lock even when many service workers prepare concurrently.
        self._rr = itertools.count()
        self._init_durability(wal)

    # -- assignment --------------------------------------------------------

    def _split(self, values, keys):
        """Deterministic batch -> [(shard_index, values, keys)] assignment,
        on the store's device."""
        if self.num_shards == 1:
            return [(0, values, keys)]
        if self.policy == "round_robin":
            return [(next(self._rr) % self.num_shards, values, keys)]
        v = _on(values, self.device)
        k = _on(keys, self.device).reshape(-1)
        h = (k.to(torch.int64) * _HASH_MULT >> _HASH_SHIFT) \
            & ((1 << (64 - _HASH_SHIFT)) - 1)
        shard = h % self.num_shards
        out = []
        for idx in torch.unique(shard).tolist():
            mask = shard == idx
            out.append((int(idx), v[mask], k[mask]))
        return out

    # -- uniform shard interface (what the pipelined service drives) ------

    def _prepare_parts(self, values, keys):
        """``[(shard_index, prepared_state_or_None, rows)]`` — pure (the
        round-robin counter ticks, but which shard a batch lands on never
        affects the merged bits)."""
        return [(idx, self._shards[idx].prepare(v, k), _nrows(v))
                for idx, v, k in self._split(values, keys)]

    def _commit_part(self, idx: int, state: Optional[PartialState],
                     rows: int) -> dict:
        return self._shards[idx].commit(state, rows)

    def ingest(self, values, keys, client=None, seq=None) -> dict:
        """Aggregate one micro-batch across the shards (serial composition
        of the two pipeline stages, like :meth:`StreamStore.ingest`), with
        one write-ahead record covering every part when a WAL is attached.
        ``client``/``seq`` tag the delivery for exactly-once commit."""
        meta = _delivery_meta(client, seq)
        if meta is not None and self.dedup.seen(meta["client"],
                                                meta["cseq"]):
            obs_metrics.counter("stream_duplicate_deliveries_total").inc()
            return {"rows": 0, "duplicate": True, "batches": self.batches,
                    "pending": sum(len(s._pending) for s in self._shards),
                    "merged": self.merged_batches}
        self._check_writable()
        with obs_trace.span("stream.ingest", shards=self.num_shards):
            parts = self._prepare_parts(values, keys)
            if not self._log_parts(parts, meta):
                obs_metrics.counter(
                    "stream_duplicate_deliveries_total").inc()
                return {"rows": 0, "duplicate": True,
                        "batches": self.batches,
                        "pending": sum(len(s._pending)
                                       for s in self._shards),
                        "merged": self.merged_batches}
            rows = 0
            for idx, state, n in parts:
                self._commit_part(idx, state, n)
                rows += n
        return {"rows": rows, "batches": self.batches,
                "pending": sum(len(s._pending) for s in self._shards),
                "merged": self.merged_batches}

    # -- query (exact merge over shards) -----------------------------------

    def flush(self) -> None:
        for s in self._shards:
            s.flush()

    def state(self) -> PartialState:
        """``merge_all`` over the shard states — the partition of rows into
        shards is erased by associativity+commutativity, so this equals the
        single-store state bit for bit."""
        states = [s.state() for s in self._shards]
        if len(states) == 1:
            return states[0]
        with obs_trace.span("stream.shard_merge", shards=len(states)):
            return merge_all(states)

    def query(self) -> dict:
        with obs_trace.span("stream.query", shards=self.num_shards):
            out = finalize(self.state())
        obs_metrics.counter("stream_queries_total").inc()
        return out

    def fingerprints(self) -> dict:
        st = self.state()
        return {"stream/table": obs_fp.fingerprint_table(st.table),
                "stream/results": obs_fp.fingerprint_results(finalize(st))}

    @property
    def rows(self) -> int:
        return int(self.state().rows)

    @property
    def batches(self) -> int:
        return sum(s.batches for s in self._shards)

    @property
    def merged_batches(self) -> int:
        return sum(s.merged_batches for s in self._shards)

    @property
    def pending_bytes(self) -> int:
        return sum(s.pending_bytes for s in self._shards)

    def pipeline_width(self, n: int) -> int:
        """Worthwhile concurrent ``prepare`` workers: the per-shard Amdahl
        width scales by the shard count (commits no longer serialize on one
        buffer), still clamped to the cores actually present."""
        cores = os.cpu_count() or 1
        return max(1, min(cores,
                          self._shards[0].pipeline_width(n) * self.num_shards))

    def warmup(self, batch_rows: int) -> float:
        """Run the ingest path once (:meth:`StreamStore.warmup`; the shards
        share one prepare pipeline, so one shard's warmup serves all)."""
        return self._shards[0].warmup(batch_rows)

    # -- snapshot / restore ------------------------------------------------

    def snapshot(self, directory: str, step: Optional[int] = None,
                 keep: int = 3) -> str:
        """Checkpoint the *merged* state in the flat single-store layout.

        Sharding is an execution-time layout, not a logical one, so the
        snapshot is deliberately shard-count-agnostic: a
        :class:`StreamStore` — or a :class:`ShardedStreamStore` with any
        other shard count — restores it bit-exactly.
        """
        st = self.state()
        if step is None:
            latest = ckpt.latest_step(directory)
            step = 0 if latest is None else latest + 1
        extra = {"kind": "stream_store",
                 "sig": self.sig.to_json(),
                 "batches": self.batches,
                 "num_shards": self.num_shards,
                 "policy": self.policy,
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
                num_shards: int = 2, policy: str = "round_robin",
                verify: bool = True, device=None) -> "ShardedStreamStore":
        """Rebuild from any stream-store snapshot: the merged state lands in
        shard 0 (one more legal partition of the row multiset), subsequent
        ingest spreads across shards as usual."""
        manifest = ckpt.read_manifest(directory, step)
        extra = manifest["extra"]
        if extra.get("kind") != "stream_store":
            raise ValueError(f"checkpoint in {directory} is not a stream "
                             f"store snapshot (kind={extra.get('kind')!r})")
        sig = AggSignature.from_json(extra["sig"])
        store = cls(sig.num_segments, aggs=sig.aggs, spec=sig.spec,
                    method=method, levels=levels, check_finite=check_finite,
                    coalesce=coalesce, num_shards=num_shards, policy=policy,
                    device=device)
        shard0 = store._shards[0]
        skeleton = _state_tree(shard0._state)
        tree, _ = ckpt.restore(directory, skeleton, step=manifest["step"],
                               device=store.device)
        if verify:
            ckpt.verify_value(tree, directory, step=manifest["step"])
        shard0._state = _tree_state(tree, sig)
        shard0.batches = int(extra.get("batches", 0))
        shard0.merged_batches = shard0.batches
        store.wal_seq = int(extra.get("wal_seq", 0))
        obs_metrics.counter("stream_restores_total").inc()
        return store

    @classmethod
    def recover(cls, wal, snapshot_dir: Optional[str] = None,
                method: str = "auto", levels="auto",
                check_finite: bool = False, coalesce="auto",
                num_shards: int = 2, policy: str = "round_robin",
                device=None) -> "ShardedStreamStore":
        """Rebuild from (newest verifiable snapshot + WAL replay), exactly
        as :meth:`StreamStore.recover` — the shard count and policy may
        differ from the crashed store's, because both the snapshot layout
        and the per-record shard indices (applied modulo the live shard
        count) are just partitions the merge algebra erases."""
        if not isinstance(wal, WriteAheadLog):
            wal = WriteAheadLog(wal)
        with obs_trace.span("stream.recover", wal_last_seq=wal.last_seq,
                            shards=num_shards):
            kwargs = dict(method=method, levels=levels,
                          check_finite=check_finite, coalesce=coalesce,
                          num_shards=num_shards, policy=policy,
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
