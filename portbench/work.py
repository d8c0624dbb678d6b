"""The yardstick of work: what a GROUP BY query needs at the least, worked
out from the query and never from the program's plan.

* Bytes: every input column the query reads (the value columns its
  aggregates read, and the group ids), read once; plus every result value
  written once.  The program's own intermediates (a derived-column matrix,
  an integer accumulator table) are not counted, so a change that drops one
  does not move the bound.
* Operations: one add per summed value: each distinct column an aggregate
  sums, and the count, once a row.

A share of a roofline is the least time these need on the device's
published peaks (``peaks.json``) over the time measured.
"""
from __future__ import annotations

import json
from pathlib import Path

DTYPE_BYTES = {"float32": 4, "float64": 8}
KEY_BYTES = 4                   # int32 group ids
_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def _aggs(config: dict) -> list:
    return [tuple(a) for a in config["aggregates"]]


def columns_read(config: dict) -> list:
    """The value columns the query's aggregates read."""
    return sorted({c for a in _aggs(config) for c in a[1:]})


def summed_columns(config: dict) -> list:
    """The value columns the query sums (SUM and AVG)."""
    return sorted({c for a in _aggs(config) if a[0] in ("sum", "mean", "avg")
                   for c in a[1:]})


def summed_values(config: dict) -> int:
    """Values summed a row: each column summed, plus one for the count
    that COUNT and AVG need."""
    counts = any(a[0] in ("count", "mean", "avg") for a in _aggs(config))
    return len(summed_columns(config)) + int(counts)


def least_bytes(config: dict, rows: int, groups: int) -> int:
    width = DTYPE_BYTES[config["dtype"]]
    read = rows * (width * len(columns_read(config)) + KEY_BYTES)
    written = width * groups * len(_aggs(config))
    return read + written


def least_ops(config: dict, rows: int) -> int:
    return rows * summed_values(config)


def peaks(device_kind: str) -> dict | None:
    """The published peaks of a device by its name, or None when the table
    has no entry for it."""
    return json.loads(_PEAKS.read_text())["devices"].get(device_kind)


def least_seconds(config: dict, rows: int, groups: int,
                  peak: dict) -> tuple[float, str]:
    """The least time the query needs on ``peak`` and which bound sets it
    (``"bytes"`` or ``"operations"``)."""
    by_bytes = least_bytes(config, rows, groups) / peak["bytes_per_s"]
    key = f"{config['dtype']}_ops_per_s"
    by_ops = least_ops(config, rows) / peak[key]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")
