"""The program's own stage spans and host-read counter, read once per traced
run for the operator glue's per-stage metrics.

After the window, while the run's table is still resident, the program's
query runs in two more passes:

* pass A: at least ``MIN_QUERIES`` queries and ``MIN_SECONDS``, with the
  program's trace buffer on (``repro_torch.obs.trace``, buffer only) and no
  profiler: each span's host time (``dur_ns``) and the delta of the
  ``repro_host_reads_total`` counter;
* pass B: as many queries under ``torch.profiler`` (CPU and CUDA), where
  the program's spans enter ``record_function``.  Each device operation is
  tied, through the Chrome trace's ``correlation`` argument, to the launch
  that queued it, and goes to the innermost program span that holds that
  launch.  Its duration is the device's own, so the host's slow-down under
  the profiler does not bias it; the idle time that each span's gaps hold
  is read with the host traced, and only guides.

Per query means over pass B's root spans (``groupby``), or pass A's
queries.  A program without these spans or this counter (an older one)
gives no reading there, and the metrics that read it report nothing.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import shutil
import tempfile
import time
import warnings

import torch

from portbench import devtrace

ROOT_SPAN = "groupby"
SPANS = (ROOT_SPAN, "groupby.columns", "groupby.prescan", "groupby.plan",
         "groupby.aggregate", "groupby.minmax", "groupby.finalize")
HOST_READS = "repro_host_reads_total"   # by name: older programs lack it
MIN_QUERIES = 20
MIN_SECONDS = 0.5
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_CACHE = "_portbench_spans"


@dataclasses.dataclass
class Attribution:
    """Pass B read per program span, per query: device ms in the hand
    kernels and in every other operation (glue), and device idle ms whose
    gap's middle falls in the span (host traced).  ``seen`` holds the
    spans that appeared; ``dtoh`` counts device-to-host copies a query."""

    queries: int
    seen: frozenset
    glue_ms: dict
    hand_ms: dict
    idle_ms: dict
    dtoh: float
    device_ops: int
    outside_ms: float       # operations launched in no program span


@dataclasses.dataclass
class Reading:
    """Both passes of one run."""

    passes: int                 # queries in each pass
    host_ms: dict               # span -> host ms a query (pass A)
    host_reads: float | None    # counter delta a query (pass A)
    reads_by_site: dict
    device: Attribution


def _innermost(spans: list, starts: list, ts: float):
    """The innermost span of ``spans`` ((start, end, name), sorted by
    start, properly nested) that holds ``ts``, or None."""
    i = bisect.bisect_right(starts, ts)
    while i > 0:
        i -= 1
        if spans[i][1] >= ts:
            return spans[i]
    return None


def attribute(events: list, hand_kernels: frozenset) -> Attribution:
    """Chrome-trace events -> per-span device and idle time.

    A device operation (``kernel``, ``gpu_memcpy``, ``gpu_memset``) goes to
    the innermost program span holding the host launch with its
    ``correlation``; hand kernels (by function name) are kept apart from
    the glue.  Idle time counts inside root spans only: each gap between
    the device's busy intervals goes to the innermost span at its middle.
    """
    spans, launches, dev = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]), float(e.get("dur", 0))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e["name"] in SPANS:
            spans.append((s, s + d, e["name"]))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = s
        elif cat in devtrace.DEVICE_CATS:
            dev.append((e["name"], cat, s, d, corr))
    spans.sort()
    starts = [s for s, _, _ in spans]
    roots = [sp for sp in spans if sp[2] == ROOT_SPAN]
    glue: dict[str, float] = {}
    hand: dict[str, float] = {}
    outside, dtoh = 0.0, 0
    for name, cat, s, d, corr in dev:
        at = launches.get(corr)
        owner = None if at is None else _innermost(spans, starts, at)
        if owner is None:
            outside += d
            continue
        if cat == "kernel" and devtrace.function_name(name) in hand_kernels:
            hand[owner[2]] = hand.get(owner[2], 0.0) + d
        else:
            glue[owner[2]] = glue.get(owner[2], 0.0) + d
        if cat == "gpu_memcpy" and "DtoH" in name:
            dtoh += 1
    idle: dict[str, float] = {}
    busy = []
    for _, _, s, d, _ in sorted(dev, key=lambda op: op[2]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], s + d)
        else:
            busy.append([s, s + d])
    ends = [e for _, e in busy]
    for r0, r1, _ in roots if dev else ():     # no device, no idle
        edge = r0
        i = bisect.bisect_right(ends, r0)
        for s, e in busy[i:] + [[r1, r1]]:
            s = min(s, r1)
            if s > edge:
                owner = _innermost(spans, starts, (edge + s) / 2)
                if owner is not None:
                    idle[owner[2]] = idle.get(owner[2], 0.0) + s - edge
            edge = max(edge, e)
            if edge >= r1:
                break
    q = len(roots)
    per = (lambda us: us / q / 1e3) if q else (lambda us: 0.0)
    return Attribution(
        queries=q, seen=frozenset(n for _, _, n in spans),
        glue_ms={k: per(v) for k, v in glue.items()},
        hand_ms={k: per(v) for k, v in hand.items()},
        idle_ms={k: per(v) for k, v in idle.items()},
        dtoh=dtoh / q if q else 0.0, device_ops=len(dev),
        outside_ms=per(outside))


def _reads() -> dict:
    from repro_torch.obs import metrics
    return {tuple(sorted(r["labels"].items())): r["value"]
            for r in metrics.to_dict().get(HOST_READS, [])}


def _pass_a(query) -> tuple:
    """Queries with the program's trace buffer on: (queries, span
    records, counter delta by site)."""
    from repro_torch.obs import trace
    before = _reads()
    trace.configure(None)
    try:
        n, t0 = 0, time.perf_counter()
        while n < MIN_QUERIES or time.perf_counter() - t0 < MIN_SECONDS:
            query()
            n += 1
        records = [r for r in trace.events() if r["kind"] == "span"]
    finally:
        trace.disable()
    after = _reads()
    delta = {dict(k).get("site", ""): v - before.get(k, 0.0)
             for k, v in after.items() if v != before.get(k, 0.0)}
    return n, records, delta


def _pass_b(query, queries: int, dev: torch.device) -> list:
    """``queries`` queries under the profiler: its Chrome-trace events,
    whole (``devtrace.Profiler`` reads them into a ``Stretch``, which keeps
    no ``correlation``)."""
    act = torch.profiler.ProfilerActivity
    acts = [act.CPU] + ([act.CUDA] if dev.type == "cuda" else [])
    prof = torch.profiler.profile(activities=acts)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Warning: Profiler clears")
        prof.start()
        try:
            for _ in range(queries):
                query()
        finally:
            prof.stop()
    tmp = tempfile.mkdtemp(prefix="portbench-spans-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def reading(run) -> Reading | None:
    """Both passes over the run's resident table (``run.query``: the call
    and its sync, made by every rank where there are several), once per
    run (cached on the run); None without a traced stretch or a resident
    table."""
    if getattr(run, _CACHE, None) is not None:
        return getattr(run, _CACHE)
    if run.stretch is None or run.query is None:
        return None
    n, records, delta = _pass_a(run.query)
    host: dict[str, float] = {}
    for r in records:
        if r["name"] in SPANS:
            host[r["name"]] = host.get(r["name"], 0.0) + r["dur_ns"] / 1e6
    device = attribute(_pass_b(run.query, n, run.device), run.hand_kernels)
    res = Reading(
        passes=n, host_ms={k: v / n for k, v in host.items()},
        host_reads=(sum(delta.values()) / n if ROOT_SPAN in device.seen
                    else None),
        reads_by_site={k: v / n for k, v in sorted(delta.items())},
        device=device)
    setattr(run, _CACHE, res)
    _say(res)
    return res


def _say(res: Reading) -> None:
    dev = res.device
    for name in SPANS:
        if name not in dev.seen and name not in res.host_ms:
            continue
        print(f"portbench: span {name} host "
              f"{res.host_ms.get(name, 0.0):.4f} ms (pass A), device "
              f"{dev.glue_ms.get(name, 0.0):.4f} ms glue + "
              f"{dev.hand_ms.get(name, 0.0):.4f} ms hand kernels, idle "
              f"{dev.idle_ms.get(name, 0.0):.4f} ms (host-traced, pass B)"
              " a query", flush=True)
    print(f"portbench: spans over {res.passes} queries a pass; host reads "
          f"a query {res.reads_by_site} (pass A); device-to-host copies a "
          f"query {dev.dtoh:.4f}, device ms a query in no span "
          f"{dev.outside_ms:.4f} (pass B, {dev.queries} root spans)",
          flush=True)


def device_ms(run, span: str) -> float | None:
    """Device ms a query of the glue launched inside ``span``; None where
    the pass saw no device operation or the program has no such span."""
    res = reading(run)
    if res is None or not res.device.device_ops \
            or span not in res.device.seen or not res.device.queries:
        return None
    return res.device.glue_ms.get(span, 0.0)


def host_ms(run, span: str) -> float | None:
    """Host ms a query inside ``span`` (pass A); None without the span."""
    res = reading(run)
    if res is None or span not in res.host_ms:
        return None
    return res.host_ms[span]
