"""Event-time windows as a ring of mergeable partial states.

A window is a partial aggregate over the rows whose event time lands in
it, so tumbling windows are a ring of :class:`PartialState` slots and a
sliding window of ``n`` widths is ``merge_all`` over the last ``n`` slots.

Event-time mechanics, decided on the host as in the JAX package:

* window id ``wid = floor(t / width)``; slot ``wid % retention``;
* the **watermark** is the max event time seen (order-invariant);
* a row is **accepted** iff its window is within ``retention`` of the
  watermark's window; older rows are counted in ``late_dropped``;
* a slot is **evicted** (reset to the merge identity) when a newer window
  claims its residue class.

Each touched window's rows are aggregated by ``partial_agg`` on the
store's device: a batch is moved there once and split per window there.
The final queryable state — every window within retention of the final
watermark — is invariant under arrival order and micro-batching; only the
``late_dropped`` count depends on the order.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.types import ReproSpec
from repro_torch.device import resolve_device
from repro_torch.obs import fingerprint as obs_fp
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.ops.partial import (AggSignature, PartialState,
                                     empty_partial, finalize, merge,
                                     merge_all, partial_agg)
from repro_torch.stream.store import (_DurableMixin, _delivery_meta, _on,
                                      _restore_best_snapshot, _state_tree,
                                      _tree_state)
from repro_torch.stream.wal import WriteAheadLog

__all__ = ["WindowedStore"]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class WindowedStore(_DurableMixin):
    """Tumbling/sliding event-time windows over a row stream.

    Args:
      num_segments / aggs / spec / method / levels / check_finite /
        device: as in :class:`~repro_torch.stream.StreamStore`.
      width:     tumbling window width, in event-time units (> 0).
      retention: ring length — number of most-recent windows kept queryable
        (and the late-arrival horizon).  Sliding queries can span up to
        ``retention`` windows.
      wal: optional write-ahead log (kind ``"window"``).  Unlike the flat
        store, the logged unit is the raw ``(values, keys, times)`` batch
        — acceptance and eviction depend on the watermark *at arrival*, so
        replay must re-run the arrival sequence, not merge deltas
        (DESIGN.md §16.4).  Replay in log order reproduces every
        watermark, late-drop and eviction decision, hence the final ring,
        bit for bit — including the order-dependent ``late_dropped``
        counter.
    """

    def __init__(self, num_segments: int, aggs=("sum",),
                 spec: Optional[ReproSpec] = None, *, width: float,
                 retention: int = 8, method: str = "auto", levels="auto",
                 check_finite: bool = False, wal=None, device=None):
        if width <= 0:
            raise ValueError("window width must be positive")
        if retention < 1:
            raise ValueError("retention must be at least 1 window")
        self.device = resolve_device(device)
        self.sig = AggSignature.build(aggs, num_segments, spec)
        self.width = float(width)
        self.retention = int(retention)
        self.method = method
        self.levels = levels
        self.check_finite = check_finite
        self._empty = empty_partial(num_segments, self.sig.aggs,
                                    self.sig.spec, device=self.device)
        self._wids = [None] * self.retention     # window id per slot
        self._slots = [self._empty] * self.retention
        self._max_wid: Optional[int] = None      # watermark window
        self.late_dropped = 0                    # best-effort, order-dependent
        self.evictions = 0
        self.batches = 0
        self._init_durability(wal)

    _wal_kind = "window"

    def _wal_params(self) -> dict:
        return {"width": self.width, "retention": self.retention}

    # -- ingest ------------------------------------------------------------

    def _wid(self, t: float) -> int:
        return int(np.floor(t / self.width))

    @property
    def watermark_wid(self) -> Optional[int]:
        return self._max_wid

    def _slot_for(self, wid: int) -> Optional[int]:
        """Claim the slot for ``wid``, evicting an older occupant; None if
        the window is beyond retention (caller counts it as late)."""
        if self._max_wid is not None and \
                wid <= self._max_wid - self.retention:
            return None
        i = wid % self.retention
        cur = self._wids[i]
        if cur is None or cur < wid:
            if cur is not None:
                self.evictions += 1
            self._wids[i] = wid
            self._slots[i] = self._empty
        elif cur > wid:
            # occupant is newer: cur >= wid + retention, so wid is beyond
            # retention of the watermark that admitted cur
            return None
        return i

    def ingest(self, values, keys, times, client=None, seq=None) -> dict:
        """Aggregate one micro-batch of (value row, key, event time).

        Window ids, the watermark and late drops are decided on the host
        from ``times``; the rows of each touched window are aggregated on
        the store's device and merged into its slot.  With a WAL attached
        the batch is logged as one ``"rows"`` record (host copies of the
        rows) before it touches the ring.  ``client``/``seq`` tag the
        delivery for exactly-once commit.  Returns
        ``{rows, accepted, late_dropped, watermark_wid}``.
        """
        if isinstance(values, torch.Tensor) or isinstance(keys, torch.Tensor):
            v, k = _on(values, self.device), _on(keys, self.device)
        else:
            v, k = np.asarray(values), np.asarray(keys)
        if v.ndim == 1:
            v = v[:, None]
        k = k.reshape(-1)
        if isinstance(times, torch.Tensor):
            times = times.cpu().numpy()
        t = np.asarray(times, np.float64).reshape(-1)
        if not (v.shape[0] == k.shape[0] == t.shape[0]):
            raise ValueError("values/keys/times disagree on the row count")
        meta = _delivery_meta(client, seq)
        dup = {"rows": 0, "duplicate": True, "accepted": 0,
               "late_dropped": 0, "watermark_wid": self._max_wid}
        if meta is not None and self.dedup.seen(meta["client"],
                                                meta["cseq"]):
            obs_metrics.counter("stream_duplicate_deliveries_total").inc()
            return dup
        record = {}
        if self._wal is not None:
            record = {"values": _host(v), "keys": _host(k), "times": t}
        if not self._log_record(record, "rows", dict(meta or {}), meta):
            obs_metrics.counter("stream_duplicate_deliveries_total").inc()
            return dup
        return self._apply(v, k, t)

    def _apply(self, v, k, t) -> dict:
        """Windowing proper — shared by live ingest and WAL replay, so both
        take bit-identical decisions.  ``t`` is a host float64 array; ``v``
        and ``k`` move to the store's device once, and each window's rows
        are picked there."""
        n = int(v.shape[0])
        accepted = dropped = 0
        with obs_trace.span("stream.window_ingest", rows=n) as sp:
            if n:
                v, k = _on(v, self.device), _on(k, self.device)
                wids = np.floor(t / self.width).astype(np.int64)
                # advance the watermark first: rows of this very batch may
                # push older rows of the same batch past retention on some
                # *other* arrival order — accepting them here too would make
                # acceptance depend on batching
                batch_max = int(wids.max())
                if self._max_wid is None or batch_max > self._max_wid:
                    self._max_wid = batch_max
                order = np.argsort(wids, kind="stable")
                uniq, starts = np.unique(wids[order], return_index=True)
                bounds = list(starts[1:]) + [n]
                for wid, lo, hi in zip(uniq.tolist(), starts, bounds):
                    i = self._slot_for(wid)
                    if i is None:
                        dropped += int(hi - lo)
                        continue
                    sel = torch.from_numpy(order[lo:hi]).to(self.device)
                    st = partial_agg(v[sel], k[sel], self.sig.num_segments,
                                     aggs=self.sig.aggs, spec=self.sig.spec,
                                     method=self.method, levels=self.levels,
                                     check_finite=self.check_finite,
                                     device=self.device)
                    self._slots[i] = merge(self._slots[i], st)
                    accepted += int(hi - lo)
            self.batches += 1
            self.late_dropped += dropped
            sp.set(accepted=accepted, late_dropped=dropped,
                   watermark_wid=self._max_wid)
        obs_metrics.counter("stream_window_rows_total").inc(accepted)
        obs_metrics.counter("stream_window_late_total").inc(dropped)
        return {"rows": n, "accepted": accepted, "late_dropped": dropped,
                "watermark_wid": self._max_wid}

    def _apply_record(self, rec) -> None:
        if rec.kind != "rows":
            raise ValueError(f"cannot replay record kind {rec.kind!r} "
                             "into a windowed store")
        self._apply(rec.arrays["values"], rec.arrays["keys"],
                    rec.arrays["times"])

    # -- query -------------------------------------------------------------

    def live_wids(self) -> list:
        """Window ids currently retained, oldest first."""
        lo = (self._max_wid - self.retention + 1
              if self._max_wid is not None else 0)
        return sorted(w for w in self._wids if w is not None and w >= lo)

    def window_state(self, wid: int) -> PartialState:
        """The partial state of one tumbling window (the merge identity for
        retained-but-untouched windows); raises for evicted windows."""
        lo = (self._max_wid - self.retention + 1
              if self._max_wid is not None else 0)
        if wid < lo:
            raise KeyError(f"window {wid} is beyond retention "
                           f"(watermark window {self._max_wid}, "
                           f"retention {self.retention})")
        i = wid % self.retention
        if self._wids[i] != wid:
            return self._empty
        return self._slots[i]

    def query(self, wid: int) -> dict:
        """Finalized results for one tumbling window."""
        return finalize(self.window_state(wid))

    def query_sliding(self, nwin: int, end_wid: Optional[int] = None) -> dict:
        """Finalized results over the sliding window of ``nwin`` tumbling
        widths ending at ``end_wid`` (default: the watermark window) — an
        exact k-way ``merge_all`` over the ring, bit-identical to a
        one-shot aggregate over those windows' rows."""
        if not 1 <= nwin <= self.retention:
            raise ValueError(
                f"sliding span must be in [1, retention={self.retention}]")
        if end_wid is None:
            end_wid = self._max_wid
        if end_wid is None:
            return finalize(self._empty)
        states = [self.window_state(w)
                  for w in range(end_wid - nwin + 1, end_wid + 1)]
        with obs_trace.span("stream.window_query", nwin=nwin,
                            end_wid=int(end_wid)):
            out = finalize(merge_all(states))
        obs_metrics.counter("stream_queries_total").inc()
        return out

    def fingerprints(self) -> dict:
        """Per-live-window and sliding-total digests of tables+results."""
        fps = {}
        for w in self.live_wids():
            st = self.window_state(w)
            fps[f"window/{w}/table"] = obs_fp.fingerprint_table(st.table)
            fps[f"window/{w}/results"] = obs_fp.fingerprint_results(
                finalize(st))
        return fps

    # -- snapshot / restore ------------------------------------------------

    def snapshot(self, directory: str, step: Optional[int] = None,
                 keep: int = 3) -> str:
        """Atomic checkpoint of the ring (every slot, occupied or identity),
        watermark and counters; value-verifiable like the flat store."""
        if step is None:
            latest = ckpt.latest_step(directory)
            step = 0 if latest is None else latest + 1
        tree = {"slots": [_state_tree(s) for s in self._slots]}
        extra = {"kind": "stream_window",
                 "sig": self.sig.to_json(),
                 "width": self.width, "retention": self.retention,
                 "wids": [w if w is None else int(w) for w in self._wids],
                 "max_wid": self._max_wid,
                 "late_dropped": self.late_dropped,
                 "evictions": self.evictions, "batches": self.batches,
                 "wal_seq": self.wal_seq,
                 "fingerprints": self.fingerprints()}
        path = ckpt.save(directory, step, tree, extra=extra, keep=keep)
        obs_metrics.counter("stream_snapshots_total").inc()
        return path

    @classmethod
    def restore(cls, directory: str, step: Optional[int] = None,
                method: str = "auto", levels="auto",
                check_finite: bool = False, verify: bool = True,
                device=None) -> "WindowedStore":
        manifest = ckpt.read_manifest(directory, step)
        extra = manifest["extra"]
        if extra.get("kind") != "stream_window":
            raise ValueError(f"checkpoint in {directory} is not a windowed "
                             f"store snapshot (kind={extra.get('kind')!r})")
        sig = AggSignature.from_json(extra["sig"])
        store = cls(sig.num_segments, aggs=sig.aggs, spec=sig.spec,
                    width=extra["width"], retention=int(extra["retention"]),
                    method=method, levels=levels, check_finite=check_finite,
                    device=device)
        skeleton = {"slots": [_state_tree(store._empty)
                              for _ in range(store.retention)]}
        tree, _ = ckpt.restore(directory, skeleton, step=manifest["step"],
                               device=store.device)
        if verify:
            ckpt.verify_value(tree, directory, step=manifest["step"])
        store._slots = [_tree_state(s, sig) for s in tree["slots"]]
        store._wids = [w if w is None else int(w) for w in extra["wids"]]
        store._max_wid = extra["max_wid"]
        store.late_dropped = int(extra["late_dropped"])
        store.evictions = int(extra["evictions"])
        store.batches = int(extra["batches"])
        store.wal_seq = int(extra.get("wal_seq", 0))
        obs_metrics.counter("stream_restores_total").inc()
        return store

    @classmethod
    def recover(cls, wal, snapshot_dir: Optional[str] = None, *,
                width: Optional[float] = None, retention: int = 8,
                method: str = "auto", levels="auto",
                check_finite: bool = False, device=None) -> "WindowedStore":
        """Rebuild from (newest verifiable snapshot + WAL replay of the
        strictly newer ``"rows"`` records, in log order).  ``width`` /
        ``retention`` default to the log's header params (recorded at
        creation), so recovery from a bare log is self-describing."""
        if not isinstance(wal, WriteAheadLog):
            wal = WriteAheadLog(wal, kind="window")
        with obs_trace.span("stream.recover", wal_last_seq=wal.last_seq):
            store = None
            if snapshot_dir is not None:
                store = _restore_best_snapshot(
                    cls, snapshot_dir, wal.sig,
                    dict(method=method, levels=levels,
                         check_finite=check_finite, device=device))
            if store is None:
                width = width if width is not None else \
                    wal.params.get("width")
                retention = int(wal.params.get("retention", retention))
                if width is None:
                    raise ValueError(
                        "recovering a windowed store without a usable "
                        "snapshot requires width=... (the log header "
                        "carries none)")
                store = cls(wal.sig.num_segments, aggs=wal.sig.aggs,
                            spec=wal.sig.spec, width=float(width),
                            retention=retention, method=method,
                            levels=levels, check_finite=check_finite,
                            device=device)
            store._replay(wal, from_seq=store.wal_seq)
            store._attach_wal(wal)
        obs_metrics.counter("stream_recoveries_total").inc()
        return store
