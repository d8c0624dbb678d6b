"""Write-ahead delta log for the streaming stores: append-only, framed,
sha256-verified, torn-tail-safe, bit-exact on replay.

The JAX package's format, byte for byte (magic, version, frame, header
JSON, array codec), so a log either package wrote replays in the other:

* **Framing** — every record is ``magic | seq | kind | lengths | sha256 |
  meta | payload``; the digest covers everything after the magic.
* **Monotone sequence numbers** — assigned under the log's lock and
  checked contiguous on recovery; a snapshot remembers the last sequence
  it contains, so replay of the strictly newer records is idempotent.
* **Torn-tail truncation** — opening a log for append truncates at the
  first incomplete/corrupt record.  With ``fsync="always"`` an
  acknowledged append is never torn.
* **Exactly-once against the log** — records carry the client delivery
  tag ``(client, cseq)`` in their meta; :class:`DedupIndex` rebuilt from
  the log suppresses redelivery across crashes.

Payloads use an explicit array codec (dtype + shape + little-endian
C-order bytes per leaf).  ``"parts"`` records hold the prepared per-shard
states of one batch; :func:`pack_parts` copies a record's card leaves to
the host in one transfer, and :func:`unpack_parts` returns states on the
store's device.  ``"rows"`` records hold the windowed store's raw
``(values, keys, times)``.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.accumulator import ReproAcc
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.ops.partial import AggSignature, PartialState
from repro_torch.runtime import faultinject

__all__ = [
    "DedupIndex", "WalError", "WalReader", "WalRecord", "WalUnavailable",
    "WriteAheadLog", "pack_parts", "unpack_parts",
]

_FILE_MAGIC = b"RWAL"
_REC_MAGIC = b"RREC"
_VERSION = 1
#: fixed record frame after the magic: seq (u64), kind (u8),
#: meta length (u32), payload length (u64) — little-endian throughout
_FRAME = struct.Struct("<QBIQ")
_DIGEST_LEN = 32

_KINDS = {1: "parts", 2: "rows"}
_KIND_IDS = {v: k for k, v in _KINDS.items()}

FSYNC_POLICIES = ("always", "never")


class WalError(RuntimeError):
    """Structural log failure (bad header, foreign signature, ...)."""


class WalUnavailable(WalError):
    """The log's backing storage failed; the owning store degrades to
    read-only serving (DESIGN.md §16.3)."""


# ---------------------------------------------------------------------------
# array codec: explicit, byte-deterministic
# ---------------------------------------------------------------------------

def _pack_arrays(arrays: dict) -> bytes:
    out = io.BytesIO()
    out.write(struct.pack("<I", len(arrays)))
    for name in sorted(arrays):
        a = np.asarray(arrays[name])
        if not a.flags.c_contiguous:
            # NB not ascontiguousarray unconditionally: it promotes 0-d
            # arrays to 1-d, silently changing the stored shape
            a = np.ascontiguousarray(a)
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        nb = name.encode()
        db = a.dtype.str.encode()          # e.g. '<i8', '<f4'
        out.write(struct.pack("<H", len(nb)))
        out.write(nb)
        out.write(struct.pack("<B", len(db)))
        out.write(db)
        out.write(struct.pack("<B", a.ndim))
        for d in a.shape:
            out.write(struct.pack("<Q", d))
        raw = a.tobytes()
        out.write(struct.pack("<Q", len(raw)))
        out.write(raw)
    return out.getvalue()


def _unpack_arrays(payload: bytes) -> dict:
    buf = memoryview(payload)
    off = 0

    def take(n):
        nonlocal off
        if off + n > len(buf):
            raise WalError("truncated array payload")
        b = buf[off:off + n]
        off += n
        return b

    (count,) = struct.unpack("<I", take(4))
    arrays = {}
    for _ in range(count):
        (nlen,) = struct.unpack("<H", take(2))
        name = bytes(take(nlen)).decode()
        (dlen,) = struct.unpack("<B", take(1))
        dtype = np.dtype(bytes(take(dlen)).decode())
        (ndim,) = struct.unpack("<B", take(1))
        shape = tuple(struct.unpack("<Q", take(8))[0] for _ in range(ndim))
        (rawlen,) = struct.unpack("<Q", take(8))
        arrays[name] = np.frombuffer(
            bytes(take(rawlen)), dtype=dtype).reshape(shape)
    return arrays


# ---------------------------------------------------------------------------
# PartialState <-> arrays (the "parts" record payload)
# ---------------------------------------------------------------------------

_LEAVES = ("k", "C", "e1", "minv", "maxv", "rows")


def _leaves(st: PartialState):
    return (st.table.k, st.table.C, st.table.e1, st.minv, st.maxv, st.rows)


def _to_host(tensors) -> list:
    """numpy copies of ``tensors`` with one device-to-host transfer: the
    leaves' bytes are packed into one buffer on their device first."""
    if all(t.device.type == "cpu" for t in tensors):
        return [t.detach().numpy() for t in tensors]
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t in tensors]
    buf = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(buf[off:off + f.numel()].view(dt).reshape(t.shape))
        off += f.numel()
    return out


def pack_parts(parts) -> dict:
    """Flatten a list of :class:`PartialState` into one array dict
    (``p{i}/leaf`` names) — one WAL record per ingested batch, however many
    shard parts it split into, so the batch is atomic in the log."""
    tensors = [t for st in parts for t in _leaves(st)]
    host = iter(_to_host(tensors)) if tensors else iter(())
    return {f"p{i}/{name}": next(host)
            for i in range(len(parts)) for name in _LEAVES}


def unpack_parts(arrays: dict, sig: AggSignature, device=None) -> list:
    """The states of one ``"parts"`` record, on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    count = len({n.split("/", 1)[0] for n in arrays})
    parts = []
    for i in range(count):
        k, C, e1, minv, maxv, rows = (
            torch.from_numpy(np.array(arrays[f"p{i}/{name}"])).to(dev)
            for name in _LEAVES)
        parts.append(PartialState(table=ReproAcc(k=k, C=C, e1=e1),
                                  minv=minv, maxv=maxv, rows=rows, sig=sig))
    return parts


# ---------------------------------------------------------------------------
# the log
# ---------------------------------------------------------------------------

class WalRecord:
    """One replayed record: ``seq`` (log-assigned, contiguous), ``kind``
    (``"parts"`` | ``"rows"``), ``meta`` (JSON dict: client delivery tag,
    shard indices, ...), ``arrays`` (the decoded payload)."""

    __slots__ = ("seq", "kind", "meta", "arrays")

    def __init__(self, seq, kind, meta, arrays):
        self.seq, self.kind, self.meta, self.arrays = seq, kind, meta, arrays


def _read_exact(f, n: int) -> Optional[bytes]:
    b = f.read(n)
    return b if len(b) == n else None


def _parse_record(f, expect_seq: Optional[int]):
    """Read one record at the current offset; returns (record, end_offset)
    or None when the bytes from here on are incomplete/corrupt."""
    magic = f.read(len(_REC_MAGIC))
    if len(magic) == 0:
        return None                        # clean EOF
    if magic != _REC_MAGIC:
        return None                        # corrupt frame start
    head = _read_exact(f, _FRAME.size)
    if head is None:
        return None
    seq, kind_id, meta_len, payload_len = _FRAME.unpack(head)
    digest = _read_exact(f, _DIGEST_LEN)
    if digest is None:
        return None
    body = _read_exact(f, meta_len + payload_len)
    if body is None:
        return None
    if hashlib.sha256(head + body).digest() != digest:
        return None
    if expect_seq is not None and seq != expect_seq:
        return None                        # non-contiguous: treat as corrupt
    if kind_id not in _KINDS:
        return None
    meta = json.loads(bytes(body[:meta_len]).decode()) if meta_len else {}
    arrays = _unpack_arrays(body[meta_len:])
    return WalRecord(seq, _KINDS[kind_id], meta, arrays), f.tell()


class WriteAheadLog:
    """Append-only delta log bound to one :class:`AggSignature`
    (``path`` may be a string or a ``pathlib.Path``).

    Args:
      path: the log file.  Created (with a signed header) if absent;
        opened for append — after torn-tail recovery — if present.
      sig: the owning store's signature.  Required when creating; when
        opening an existing log it is checked against the header (a WAL
        replays only into the store shape that wrote it).
      kind: ``"stream"`` (flat/sharded stores, ``"parts"`` records) or
        ``"window"`` (windowed stores, ``"rows"`` records); recorded in
        the header and enforced on open.
      fsync: ``"always"`` (default — every append is durable before it
        returns, so acknowledged batches survive power loss) or
        ``"never"`` (OS page cache only; a benchmark/throughput knob that
        weakens durability, never bits).
      params: extra store parameters recorded in the header (the windowed
        store keeps ``width``/``retention`` here, so recovery from a bare
        log is self-describing).
    """

    def __init__(self, path: str, sig: Optional[AggSignature] = None,
                 kind: str = "stream", fsync: str = "always",
                 params: Optional[dict] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync must be one of {FSYNC_POLICIES}, got {fsync!r}")
        if kind not in ("stream", "window"):
            raise ValueError(f"unknown WAL kind {kind!r}")
        self.path = os.fspath(path)
        self.fsync = fsync
        self.kind = kind
        self.params = dict(params or {})
        self._lock = threading.Lock()
        self.truncated_bytes = 0           # torn tail dropped on open
        self.replayable = 0                # valid records found on open
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            self.sig = self._open_existing(sig)
        else:
            if sig is None:
                raise ValueError("creating a WAL requires the store "
                                 "signature (sig=...)")
            self.sig = sig
            self._create()
        self._f = open(self.path, "ab")
        obs_metrics.gauge("stream_wal_last_seq").set(self.last_seq)

    # -- header ------------------------------------------------------------

    def _header_bytes(self) -> bytes:
        hjson = json.dumps({"version": _VERSION, "kind": self.kind,
                            "sig": self.sig.to_json(),
                            "params": self.params},
                           sort_keys=True).encode()
        return (_FILE_MAGIC + struct.pack("<HI", _VERSION, len(hjson)) +
                hashlib.sha256(hjson).digest() + hjson)

    def _create(self) -> None:
        self.next_seq = 1
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        with open(self.path, "wb") as f:
            f.write(self._header_bytes())
            f.flush()
            os.fsync(f.fileno())
        self._sync_dir(d)

    @staticmethod
    def _read_header(f):
        """Returns (sig, kind, params, end_offset); raises WalError when
        the header is unreadable."""
        magic = _read_exact(f, len(_FILE_MAGIC))
        if magic != _FILE_MAGIC:
            raise WalError("not a WAL file (bad magic)")
        head = _read_exact(f, struct.calcsize("<HI"))
        if head is None:
            raise WalError("truncated WAL header")
        version, hlen = struct.unpack("<HI", head)
        if version != _VERSION:
            raise WalError(f"unsupported WAL version {version}")
        digest = _read_exact(f, _DIGEST_LEN)
        hjson = _read_exact(f, hlen)
        if digest is None or hjson is None or \
                hashlib.sha256(hjson).digest() != digest:
            raise WalError("corrupt WAL header")
        h = json.loads(hjson.decode())
        return (AggSignature.from_json(h["sig"]), h.get("kind", "stream"),
                h.get("params", {}), f.tell())

    def _open_existing(self, sig: Optional[AggSignature]) -> AggSignature:
        with obs_trace.span("wal.recover", path=self.path) as sp:
            with open(self.path, "r+b") as f:
                hsig, hkind, self.params, off = self._read_header(f)
                if sig is not None and hsig != sig:
                    raise WalError(
                        f"WAL {self.path} belongs to a different store "
                        f"signature")
                if hkind != self.kind:
                    raise WalError(
                        f"WAL {self.path} has kind {hkind!r}, not "
                        f"{self.kind!r}")
                f.seek(off)
                seq = 0
                good_end = off
                while True:
                    parsed = _parse_record(f, expect_seq=seq + 1)
                    if parsed is None:
                        break
                    rec, good_end = parsed
                    seq = rec.seq
                    f.seek(good_end)
                size = os.path.getsize(self.path)
                if good_end < size:
                    f.truncate(good_end)
                    self.truncated_bytes = size - good_end
                    obs_metrics.counter(
                        "stream_wal_torn_truncations_total").inc()
                    obs_metrics.counter(
                        "stream_wal_torn_bytes_total").inc(
                            self.truncated_bytes)
            self.next_seq = seq + 1
            self.replayable = seq
            sp.set(records=seq, truncated_bytes=self.truncated_bytes)
        return hsig

    @staticmethod
    def _sync_dir(d: str) -> None:
        try:
            fd = os.open(d, os.O_RDONLY)
        except OSError:              # platform without dir fds
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # -- append ------------------------------------------------------------

    @property
    def last_seq(self) -> int:
        return self.next_seq - 1

    def append(self, arrays: dict, kind: str = "parts",
               meta: Optional[dict] = None) -> int:
        """Frame + write + (policy) fsync one record; returns its sequence
        number.  Thread-safe.  Raises :class:`WalUnavailable` when the
        backing storage fails — the caller's cue to degrade to read-only.
        """
        if kind not in _KIND_IDS:
            raise ValueError(f"unknown record kind {kind!r}")
        t0 = time.perf_counter()
        payload = _pack_arrays(arrays)
        meta_b = json.dumps(meta or {}, sort_keys=True).encode()
        with self._lock:
            seq = self.next_seq
            head = _FRAME.pack(seq, _KIND_IDS[kind], len(meta_b),
                               len(payload))
            digest = hashlib.sha256(head + meta_b + payload).digest()
            frame = _REC_MAGIC + head + digest + meta_b + payload
            try:
                faultinject.fire("wal.append")
                start = self._f.tell()
                self._f.write(frame)
                self._f.flush()
                if self.fsync == "always":
                    os.fsync(self._f.fileno())
            except OSError as e:
                raise WalUnavailable(
                    f"WAL append to {self.path} failed: {e}") from e
            self.next_seq = seq + 1
            # after the durable write, before the caller can ack:
            # crash here == "logged but never acknowledged"
            faultinject.fire("wal.append.logged", path=self.path,
                             record_span=(start, start + len(frame)))
        obs_metrics.counter("stream_wal_records_total").inc()
        obs_metrics.counter("stream_wal_bytes_total").inc(len(frame))
        obs_metrics.gauge("stream_wal_last_seq").set(seq)
        obs_metrics.histogram("stream_wal_append_seconds").observe(
            time.perf_counter() - t0)
        return seq

    def sync(self) -> None:
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    # -- replay ------------------------------------------------------------

    def records(self, start_seq: int = 1) -> Iterator[WalRecord]:
        """Yield valid records with ``seq >= start_seq`` from a private
        read handle, stopping at the first incomplete/corrupt frame (a
        concurrent writer's in-flight tail is simply not yet visible).
        Safe to call while the log is open for append."""
        with self._lock:
            self._f.flush()
        with open(self.path, "rb") as f:
            _, _, _, off = self._read_header(f)
            f.seek(off)
            seq = 0
            while True:
                parsed = _parse_record(f, expect_seq=seq + 1)
                if parsed is None:
                    return
                rec, end = parsed
                seq = rec.seq
                f.seek(end)
                if rec.seq >= start_seq:
                    yield rec


class WalReader:
    """Strictly read-only view of a — possibly live — log.

    Never truncates and never appends, so a follower can tail the
    primary's WAL while the primary is still writing it: an in-flight
    (torn-so-far) tail record simply isn't yielded yet, and :meth:`poll`
    picks it up once its full frame is durable.  Only
    :class:`WriteAheadLog` (the exclusive append owner) may repair a torn
    tail.
    """

    def __init__(self, path: str, sig: Optional[AggSignature] = None,
                 kind: Optional[str] = "stream"):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            self.sig, self.kind, self.params, self._off = \
                WriteAheadLog._read_header(f)
        if sig is not None and self.sig != sig:
            raise WalError(f"WAL {self.path} belongs to a different store "
                           "signature")
        if kind is not None and self.kind != kind:
            raise WalError(f"WAL {self.path} has kind {self.kind!r}, "
                           f"not {kind!r}")
        self._pos = self._off
        self._seq = 0

    @property
    def last_seq(self) -> int:
        """Highest sequence number yielded so far."""
        return self._seq

    def poll(self) -> list:
        """Every record appended since the last poll (possibly empty).
        Stops — without consuming — at the first incomplete frame."""
        recs = []
        with open(self.path, "rb") as f:
            f.seek(self._pos)
            while True:
                parsed = _parse_record(f, expect_seq=self._seq + 1)
                if parsed is None:
                    return recs
                rec, end = parsed
                self._seq, self._pos = rec.seq, end
                f.seek(end)
                recs.append(rec)


# ---------------------------------------------------------------------------
# exactly-once: the client-delivery dedup index
# ---------------------------------------------------------------------------

class DedupIndex:
    """Seen ``(client, cseq)`` delivery tags, compacted to a contiguous
    high-water mark plus a sparse out-of-order set per client.

    Client sequence numbers are non-negative ints assigned by each client;
    gaps (reordered delivery) are fine — the merge is commutative — and
    duplicates are suppressed exactly.  Rebuilt from WAL record metas on
    recovery, which is what makes "ack lost, client retried across a
    crash" safe (DESIGN.md §16.2).
    """

    def __init__(self):
        self._hi: dict = {}        # client -> all of 0..hi seen
        self._sparse: dict = {}    # client -> {seq > hi+1 seen}
        self._lock = threading.Lock()

    def seen(self, client: str, seq: int) -> bool:
        with self._lock:
            if seq <= self._hi.get(client, -1):
                return True
            return seq in self._sparse.get(client, ())

    def reserve(self, client: str, seq: int) -> bool:
        """Atomically mark the tag seen; False if it already was.  The
        check-and-mark is one critical section, so two concurrent
        deliveries of the same tag can't both win (the loser is answered
        as a duplicate without logging or committing anything)."""
        with self._lock:
            hi = self._hi.get(client, -1)
            if seq <= hi or seq in self._sparse.get(client, ()):
                return False
            sparse = self._sparse.setdefault(client, set())
            sparse.add(seq)
            while hi + 1 in sparse:
                hi += 1
                sparse.discard(hi)
            self._hi[client] = hi
            return True

    def record(self, client: str, seq: int) -> None:
        self.reserve(client, seq)

    def absorb_meta(self, meta: dict) -> None:
        """Record the delivery tag of one replayed WAL record (no-op for
        untagged records)."""
        client = meta.get("client")
        if client is not None and meta.get("cseq") is not None:
            self.record(client, int(meta["cseq"]))

    def clients(self) -> dict:
        """{client: contiguous high-water mark} — observability."""
        with self._lock:
            return dict(self._hi)
