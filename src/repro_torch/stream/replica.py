"""Replicated streaming store: one logging primary, N log-tailing
followers, bit-verified failover.

A follower tails the primary's WAL read-only
(:class:`~repro_torch.stream.wal.WalReader`) and applies records through
the replay path recovery uses, so a caught-up follower's state is
bit-identical to the primary's merged state.  Promotion makes that a gate:

1. the candidate follower drains the log (``catch_up``);
2. a reference store is rebuilt from durable state only —
   ``recover(wal, snapshot_dir)``;
3. the candidate's fingerprints must equal the reference's; on a match
   the candidate takes over the WAL's append handle and becomes primary,
   otherwise :class:`PromotionError`.

Followers keep their state on the device their ``store_kwargs`` name (the
card by default), like the primary.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.stream.store import StreamStore
from repro_torch.stream.wal import WalReader, WalUnavailable, WriteAheadLog

__all__ = ["Follower", "PromotionError", "ReplicatedStore"]


class PromotionError(RuntimeError):
    """The candidate follower's fingerprints do not match the state
    rebuilt from durable data — promotion refused."""


class Follower:
    """A read-only replica: a fresh store fed solely by tailing the WAL.

    The follower's store has no WAL of its own (it must never append to
    the shared log); its dedup index is rebuilt from the record metas it
    applies, so it is promotion-ready with exactly-once suppression
    intact.
    """

    def __init__(self, wal_path: str, store_cls=StreamStore,
                 name: str = "follower", **store_kwargs):
        self._reader = WalReader(wal_path)
        sig = self._reader.sig
        self.store = store_cls(sig.num_segments, aggs=sig.aggs,
                               spec=sig.spec, **store_kwargs)
        self.name = name

    @property
    def applied_seq(self) -> int:
        return self._reader.last_seq

    def catch_up(self) -> int:
        """Apply every record appended since the last call; returns how
        many were applied."""
        applied = 0
        for rec in self._reader.poll():
            self.store.dedup.absorb_meta(rec.meta)
            self.store._apply_record(rec)
            applied += 1
        if applied:
            obs_metrics.counter(
                "stream_replica_applied_records_total").inc(applied)
        return applied

    def lag(self, primary_seq: int) -> int:
        return max(int(primary_seq) - self.applied_seq, 0)

    def fingerprints(self) -> dict:
        return self.store.fingerprints()

    def query(self) -> dict:
        return self.store.query()


class ReplicatedStore:
    """Primary + followers behind one ingest/query interface.

    Args:
      num_segments / aggs / spec: the store shape, as in
        :class:`StreamStore`.
      wal_path: the shared log.  The primary owns its append handle;
        followers tail it read-only.
      snapshot_dir: where :meth:`snapshot` writes and what promotion's
        reference rebuild reads.
      num_followers: replica count (0 is legal — failover then degrades
        to a plain ``recover``).
      store_cls / store_kwargs: the store implementation (flat by
        default; :class:`~repro_torch.stream.sharded.ShardedStreamStore` with
        ``num_shards=...`` works unchanged, since followers apply records
        through the same shard-agnostic replay path).
    """

    def __init__(self, num_segments: int, aggs=("sum",), spec=None, *,
                 wal_path: str, snapshot_dir: Optional[str] = None,
                 num_followers: int = 1, store_cls=StreamStore,
                 **store_kwargs):
        self.wal_path = wal_path
        self.snapshot_dir = snapshot_dir
        self._store_cls = store_cls
        self._store_kwargs = dict(store_kwargs)
        self.primary: Optional[object] = store_cls(
            num_segments, aggs=aggs, spec=spec, wal=wal_path,
            **store_kwargs)
        self.followers = [
            Follower(wal_path, store_cls=store_cls, name=f"follower{i}",
                     **store_kwargs)
            for i in range(int(num_followers))]
        self._t_crash: Optional[float] = None

    # -- normal operation --------------------------------------------------

    def ingest(self, values, keys, client=None, seq=None) -> dict:
        if self.primary is None:
            raise WalUnavailable("no primary: the store crashed and has "
                                 "not been failed over (promote())")
        return self.primary.ingest(values, keys, client=client, seq=seq)

    def replicate(self) -> dict:
        """Let every follower drain the log; returns {name: applied}."""
        return {f.name: f.catch_up() for f in self.followers}

    def query(self) -> dict:
        if self.primary is not None:
            return self.primary.query()
        if self.followers:             # degraded: serve from a replica
            return self.followers[0].query()
        raise WalUnavailable("no primary and no followers to serve reads")

    def fingerprints(self) -> dict:
        src = self.primary if self.primary is not None else \
            self.followers[0].store
        return src.fingerprints()

    def snapshot(self, step: Optional[int] = None, keep: int = 3) -> str:
        if self.snapshot_dir is None:
            raise ValueError("ReplicatedStore built without snapshot_dir")
        return self.primary.snapshot(self.snapshot_dir, step=step,
                                     keep=keep)

    @property
    def read_only(self) -> bool:
        return self.primary is None or self.primary.read_only

    # -- failover ----------------------------------------------------------

    def crash_primary(self) -> None:
        """Kill the primary (test/chaos hook): its live state is discarded
        and its WAL handle closed, exactly what a process death leaves
        behind.  Queries keep being served by followers until
        :meth:`promote`."""
        if self.primary is not None and self.primary.wal is not None:
            self.primary.wal.close()
        self.primary = None
        self._t_crash = time.perf_counter()
        obs_metrics.counter("stream_primary_crashes_total").inc()
        obs_trace.event("stream.primary_crashed")

    def promote(self, follower: Optional[Follower] = None) -> dict:
        """Fail over onto ``follower`` (default: first), gated on bitwise
        agreement with the durable truth.  Returns a report with the
        catch-up count, the matched fingerprints and failover timings
        (detect → promoted → first verified query)."""
        if self.primary is not None:
            raise RuntimeError("promote() with a live primary; "
                               "crash_primary() first")
        t0 = time.perf_counter()
        with obs_trace.span("stream.promote") as sp:
            if follower is None:
                if not self.followers:
                    raise PromotionError("no follower to promote")
                follower = self.followers[0]
            applied = follower.catch_up()
            # durable truth, independently rebuilt (verifies snapshots,
            # truncates the — now ownerless — torn tail if any)
            reference = self._store_cls.recover(
                WriteAheadLog(self.wal_path), self.snapshot_dir,
                **self._store_kwargs)
            want = reference.fingerprints()
            got = follower.fingerprints()
            if got != want:
                obs_metrics.counter(
                    "stream_promotions_refused_total").inc()
                raise PromotionError(
                    f"follower {follower.name} diverged from durable "
                    f"state: {got} != {want}")
            # the candidate takes over the (already-recovered) log handle
            follower.store._attach_wal(reference.wal)
            self.primary = follower.store
            self.followers = [f for f in self.followers if f is not follower]
            t_promoted = time.perf_counter()
            self.primary.query()        # first verified read post-failover
            t_query = time.perf_counter()
            sp.set(follower=follower.name, applied=applied)
        report = {
            "promoted": follower.name,
            "caught_up_records": applied,
            "wal_seq": self.primary.wal_seq,
            "fingerprints": want,
            "seconds": {
                "detect_to_promoted": (
                    t_promoted - self._t_crash
                    if self._t_crash is not None else t_promoted - t0),
                "promote": t_promoted - t0,
                "first_query": t_query - t_promoted,
                "total": (t_query - self._t_crash
                          if self._t_crash is not None else t_query - t0),
            },
        }
        obs_metrics.counter("stream_promotions_total").inc()
        obs_trace.event("stream.promoted", **{
            "follower": follower.name, "applied": applied})
        return report
