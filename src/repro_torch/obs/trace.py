"""Span tracer with a no-op fast path (DESIGN.md §13.1).

Design constraints, in order:

1. **Disabled mode costs nothing.**  When ``REPRO_TRACE`` is unset (or
   ``"0"``) and no torch profiler is active, no sink, buffer or lock is
   ever allocated; :func:`span` returns a shared null context manager and
   :func:`event` is a single attribute load + ``is None`` test, so the
   instrumented planner and GROUPBY paths pay nothing measurable.
2. **Honest clocks.**  Durations come from ``time.perf_counter_ns`` (the
   monotonic clock); each record also carries a wall-clock ``ts`` so traces
   from different processes can be laid side by side.
3. **Thread-safe.**  The span stack is thread-local (nesting is per
   thread); the JSONL sink and in-memory buffer are lock-protected.

Enabling:

* ``REPRO_TRACE=1``           — in-memory buffer only (``events()``);
* ``REPRO_TRACE=/path.jsonl`` — buffer + append-mode JSONL sink;
* :func:`configure`           — explicit programmatic control (tests).

Record schema (one JSON object per line; the contract §13.2 relies on):

  {"kind": "span"|"event", "name": str, "ts": float unix seconds,
   "dur_ns": int (spans only), "span_id": int, "parent_id": int|null,
   "root_id": int (the span_id of the outermost enclosing span, its own
   when it has none), "depth": int, "thread": int, "attrs": {...}}

While a torch profiler is active (checked per span), every span also
enters ``torch.profiler.record_function(name)``, whether or not
``REPRO_TRACE`` is on: the profiler stamps it on the timeline of the
device's kernels as a ``user_annotation``, nested with the torch
operators and CUDA launches it contains.
"""
from __future__ import annotations

import json
import os
import threading
import time

from torch.autograd import profiler as _profiler

__all__ = [
    "TRACE_ENV", "enabled", "configure", "disable",
    "span", "event", "events", "flush", "sink_path",
]

TRACE_ENV = "REPRO_TRACE"

_BUFFER_CAP = 1 << 16       # in-memory ring; the JSONL sink is unbounded


class _NullSpan:
    """Shared do-nothing context manager — the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class _Annotation:
    """Tracing off under an active profiler: the span is only the
    profiler's ``record_function`` annotation."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False

    def set(self, **attrs):
        return self


class _TraceState:
    """All tracer state; exists only while tracing is enabled."""

    def __init__(self, path: str | None):
        self.path = path
        self.lock = threading.Lock()
        self.buffer: list[dict] = []
        self.local = threading.local()      # per-thread span stack
        self.next_id = 0
        self._fh = None

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def alloc_id(self) -> int:
        with self.lock:
            i = self.next_id
            self.next_id += 1
            return i

    def emit(self, record: dict) -> None:
        line = None
        if self.path is not None:
            line = json.dumps(record, default=str)
        with self.lock:
            if len(self.buffer) < _BUFFER_CAP:
                self.buffer.append(record)
            if line is not None:
                if self._fh is None:
                    d = os.path.dirname(os.path.abspath(self.path))
                    os.makedirs(d, exist_ok=True)
                    self._fh = open(self.path, "a")
                self._fh.write(line + "\n")

    def flush(self) -> None:
        with self.lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self.lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_state: _TraceState | None = None


def _init_from_env() -> None:
    val = os.environ.get(TRACE_ENV, "")
    if val in ("", "0"):
        return
    configure(path=None if val == "1" else val)


def enabled() -> bool:
    return _state is not None


def sink_path() -> str | None:
    """The active JSONL sink path, or None (disabled / buffer-only)."""
    return _state.path if _state is not None else None


def configure(path: str | None = None) -> None:
    """Enable tracing (programmatic override of ``REPRO_TRACE``)."""
    global _state
    if _state is not None:
        _state.close()
    _state = _TraceState(path)


def disable() -> None:
    """Disable tracing and drop every allocated resource."""
    global _state
    if _state is not None:
        _state.close()
    _state = None


class _Span:
    """A live span: times itself, tracks nesting, emits one record on exit."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "root_id",
                 "depth", "_t0", "_ts", "_rf")

    def __init__(self, state: _TraceState, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.span_id = state.alloc_id()
        stack = state.stack()
        self.parent_id = stack[-1].span_id if stack else None
        self.root_id = stack[0].root_id if stack else self.span_id
        self.depth = len(stack)

    def set(self, **attrs):
        """Attach attributes discovered mid-span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        st = _state
        if st is not None:
            st.stack().append(self)
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        self._ts = time.time()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        st = _state
        if st is not None:
            stack = st.stack()
            if stack and stack[-1] is self:
                stack.pop()
            if exc_type is not None:
                self.attrs["error"] = exc_type.__name__
            st.emit({"kind": "span", "name": self.name, "ts": self._ts,
                     "dur_ns": dur, "span_id": self.span_id,
                     "parent_id": self.parent_id, "root_id": self.root_id,
                     "depth": self.depth,
                     "thread": threading.get_ident(), "attrs": self.attrs})
        return False


def span(name: str, **attrs):
    """Context manager timing a named region; with tracing off, only the
    profiler's annotation while a profiler is active, else a no-op."""
    st = _state
    if st is None:
        return _Annotation(name) if _profiler._is_profiler_enabled \
            else _NULL_SPAN
    return _Span(st, name, attrs)


def event(name: str, **attrs) -> None:
    """Emit a point event; no-op when disabled."""
    st = _state
    if st is None:
        return
    stack = st.stack()
    eid = st.alloc_id()
    st.emit({"kind": "event", "name": name, "ts": time.time(),
             "span_id": eid,
             "parent_id": stack[-1].span_id if stack else None,
             "root_id": stack[0].root_id if stack else eid,
             "depth": len(stack), "thread": threading.get_ident(),
             "attrs": attrs})


def events() -> list[dict]:
    """Copy of the in-memory record buffer (empty when disabled)."""
    st = _state
    if st is None:
        return []
    with st.lock:
        return list(st.buffer)


def flush() -> None:
    if _state is not None:
        _state.flush()


_init_from_env()
