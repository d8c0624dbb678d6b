"""``python -m repro_torch.obs.report`` — summarize trace/metrics files.

Usage:
  python -m repro_torch.obs.report --trace run.jsonl [--metrics metrics.json]
  python -m repro_torch.obs.report metrics.json          (format sniffed)

Spans aggregate by name (count, total/mean/p50/max wall time); events list
by name with their latest attrs; metrics render counters/gauges inline and
histograms as count/mean/max.  Everything is plain text so it reads in a CI
log as well as a terminal.  The port's trace records
(:mod:`repro_torch.obs.trace`) and metrics dumps
(:mod:`repro_torch.obs.metrics`) have the JAX package's schema, so either
package's files read here.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _fmt_ns(ns: float) -> str:
    for unit, scale in (("s", 1e9), ("ms", 1e6), ("us", 1e3)):
        if ns >= scale:
            return f"{ns / scale:.2f}{unit}"
    return f"{ns:.0f}ns"


def _percentile(xs, q):
    xs = sorted(xs)
    if not xs:
        return 0.0
    i = min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))
    return xs[i]


def load_trace(path: str) -> list[dict]:
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def summarize_trace(records: list[dict], out=None) -> None:
    out = out or sys.stdout
    spans: dict[str, list[float]] = {}
    events: dict[str, tuple[int, dict]] = {}
    for r in records:
        if r.get("kind") == "span":
            spans.setdefault(r["name"], []).append(float(r.get("dur_ns", 0)))
        elif r.get("kind") == "event":
            n, _ = events.get(r["name"], (0, {}))
            events[r["name"]] = (n + 1, r.get("attrs", {}))
    if spans:
        print(f"{'span':<32} {'count':>6} {'total':>10} {'mean':>10} "
              f"{'p50':>10} {'max':>10}", file=out)
        for name in sorted(spans, key=lambda n: -sum(spans[n])):
            ds = spans[name]
            print(f"{name:<32} {len(ds):>6} {_fmt_ns(sum(ds)):>10} "
                  f"{_fmt_ns(sum(ds) / len(ds)):>10} "
                  f"{_fmt_ns(_percentile(ds, 0.5)):>10} "
                  f"{_fmt_ns(max(ds)):>10}", file=out)
    if events:
        print(f"\n{'event':<32} {'count':>6}  last attrs", file=out)
        for name in sorted(events):
            n, attrs = events[name]
            txt = ", ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
            if len(txt) > 120:
                txt = txt[:117] + "..."
            print(f"{name:<32} {n:>6}  {txt}", file=out)
    if not spans and not events:
        print("(empty trace)", file=out)


def summarize_metrics(payload: dict, out=None) -> None:
    out = out or sys.stdout
    if not payload:
        print("(empty metrics)", file=out)
        return
    print(f"{'metric':<40} {'kind':<10} value", file=out)
    for name in sorted(payload):
        for series in payload[name]:
            labels = series.get("labels", {})
            ltxt = ("{" + ",".join(f"{k}={v}"
                                   for k, v in sorted(labels.items())) + "}"
                    if labels else "")
            kind = series.get("kind", "?")
            if kind == "histogram":
                cnt = series.get("count", 0)
                mean = series.get("sum", 0.0) / cnt if cnt else 0.0
                val = f"count={cnt} mean={mean:.6g}"
            else:
                val = f"{series.get('value', 0.0):.6g}"
            print(f"{(name + ltxt):<40} {kind:<10} {val}", file=out)


def _looks_like_metrics(path: str) -> bool:
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except ValueError:
        return False               # multiple JSONL lines -> trace
    # a one-line trace file also parses whole: tell them apart by shape
    return isinstance(payload, dict) and \
        payload.get("kind") not in ("span", "event")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize repro_torch.obs trace/metrics files")
    ap.add_argument("files", nargs="*", help="trace .jsonl / metrics .json")
    ap.add_argument("--trace", action="append", default=[])
    ap.add_argument("--metrics", action="append", default=[])
    args = ap.parse_args(argv)

    traces = list(args.trace)
    metrics = list(args.metrics)
    for f in args.files:
        if not os.path.exists(f):
            ap.error(f"no such file: {f}")
        (metrics if _looks_like_metrics(f) else traces).append(f)
    if not traces and not metrics:
        ap.error("nothing to report on")

    for path in traces:
        print(f"== trace: {path} ==")
        summarize_trace(load_trace(path))
        print()
    for path in metrics:
        print(f"== metrics: {path} ==")
        with open(path) as fh:
            summarize_metrics(json.load(fh))
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
