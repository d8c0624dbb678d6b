"""Process-local metrics registry: counters, gauges, histograms.

Zero dependencies; the registry is a lock-protected dict keyed by
``(name, sorted label items)``.  Two export formats:

* :func:`to_dict` / :func:`dump` — JSON, one object per metric name;
* :func:`to_prometheus` — the Prometheus text exposition format
  (``# TYPE`` headers, label escaping, ``_bucket``/``_sum``/``_count``
  histogram series with cumulative ``le`` buckets), so a scrape endpoint
  can serve the registry verbatim.

``REPRO_METRICS=0`` disables recording: :func:`counter` & friends return a
shared no-op instrument, so instrumented code pays one env lookup + branch.
Any other value (including unset) leaves recording on — the in-process cost
is a dict lookup and a float add.
``REPRO_METRICS=/path.json`` additionally names the default dump path
(:func:`dump` with no argument).
"""
from __future__ import annotations

import atexit
import json
import math
import os
import threading

__all__ = [
    "METRICS_ENV", "enabled", "counter", "gauge", "histogram",
    "to_dict", "dump", "to_prometheus", "reset", "default_dump_path",
    "DEFAULT_BUCKETS", "HOST_READS", "host_read", "COLLECTIVES",
    "COLLECTIVE_BYTES", "collective",
]

METRICS_ENV = "REPRO_METRICS"

# Default histogram buckets: half-decade log spacing from 100us to 100s —
# wide enough for both a planner call and a full training step.
DEFAULT_BUCKETS = tuple(10.0 ** (e / 2.0) for e in range(-8, 5))


def enabled() -> bool:
    return os.environ.get(METRICS_ENV, "") != "0"


def default_dump_path() -> str | None:
    val = os.environ.get(METRICS_ENV, "")
    return val if val not in ("", "0", "1") else None


class Counter:
    """Monotone counter."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0):
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v
        return self

    def snapshot(self):
        return {"value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)
        return self

    def add(self, v: float):
        self.value += v
        return self

    def snapshot(self):
        return {"value": self.value}


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        v = float(v)
        self.sum += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
        return self

    def snapshot(self):
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


class _Noop:
    """Shared sink for ``REPRO_METRICS=0``."""

    kind = "noop"
    __slots__ = ()
    value = 0.0

    def inc(self, v: float = 1.0):
        return self

    def set(self, v: float):
        return self

    def add(self, v: float):
        return self

    def observe(self, v: float):
        return self


_NOOP = _Noop()
_lock = threading.Lock()
_registry: dict = {}        # (name, labels tuple) -> instrument


def _get(cls, name: str, labels: dict, **kw):
    if not enabled():
        return _NOOP
    key = (name, tuple(sorted(labels.items())))
    with _lock:
        inst = _registry.get(key)
        if inst is None:
            inst = _registry[key] = cls(**kw)
        elif inst.kind != cls.kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{inst.kind}, requested {cls.kind}")
        return inst


def counter(name: str, **labels) -> Counter:
    return _get(Counter, name, labels)


def gauge(name: str, **labels) -> Gauge:
    return _get(Gauge, name, labels)


def histogram(name: str, buckets=DEFAULT_BUCKETS, **labels) -> Histogram:
    return _get(Histogram, name, labels, buckets=buckets)


HOST_READS = "repro_host_reads_total"


def host_read(site: str) -> None:
    """Count one read of a tensor's value by the host at ``site``: on a
    card, a device-to-host copy that waits for the device's queue."""
    counter(HOST_READS, site=site).inc()


COLLECTIVES = "repro_collectives_total"
COLLECTIVE_BYTES = "repro_collective_bytes_total"


def collective(op: str, nbytes: int) -> None:
    """Count one collective ``op`` of this process and its payload: the
    bytes of the tensor it is given, from its shape alone (no sync)."""
    counter(COLLECTIVES, op=op).inc()
    counter(COLLECTIVE_BYTES, op=op).inc(nbytes)


def reset() -> None:
    with _lock:
        _registry.clear()


def to_dict() -> dict:
    """{name: [{labels, kind, ...snapshot}]} — the JSON dump layout."""
    out: dict = {}
    with _lock:
        items = list(_registry.items())
    for (name, labels), inst in sorted(items):
        out.setdefault(name, []).append(
            {"labels": dict(labels), "kind": inst.kind, **inst.snapshot()})
    return out


def dump(path: str | None = None) -> str | None:
    """Write the JSON dump; path defaults to ``REPRO_METRICS`` when it names
    a file.  Returns the path written, or None when there is nowhere to
    write."""
    path = path or default_dump_path()
    if path is None:
        return None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(to_dict(), fh, indent=1, sort_keys=True)
    return path


def _prom_name(name: str) -> str:
    out = [c if (c.isalnum() and c.isascii()) or c in "_:" else "_"
           for c in name]
    if out and out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def _prom_label_value(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{_prom_label_value(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _prom_num(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if v != int(v) else str(int(v))


def to_prometheus() -> str:
    """The text exposition format, one ``# TYPE`` header per metric name."""
    with _lock:
        items = list(_registry.items())
    by_name: dict = {}
    for (name, labels), inst in sorted(items):
        by_name.setdefault(name, []).append((dict(labels), inst))
    lines = []
    for name, series in by_name.items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} {series[0][1].kind}")
        for labels, inst in series:
            if inst.kind in ("counter", "gauge"):
                lines.append(
                    f"{pname}{_prom_labels(labels)} {_prom_num(inst.value)}")
            else:
                for le, c in zip(inst.buckets, inst.counts):
                    lines.append(f"{pname}_bucket"
                                 f"{_prom_labels(labels, {'le': _prom_num(le)})}"
                                 f" {c}")
                lines.append(f"{pname}_bucket"
                             f"{_prom_labels(labels, {'le': '+Inf'})}"
                             f" {inst.count}")
                lines.append(f"{pname}_sum{_prom_labels(labels)} "
                             f"{_prom_num(inst.sum)}")
                lines.append(f"{pname}_count{_prom_labels(labels)} "
                             f"{inst.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def _atexit_dump() -> None:
    """When ``REPRO_METRICS`` names a path, persist the final snapshot even
    for entry points that never call :func:`dump` themselves."""
    try:
        dump()
    except Exception:
        pass                      # never let telemetry break shutdown


atexit.register(_atexit_dump)
