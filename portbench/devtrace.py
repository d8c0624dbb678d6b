"""Device timing: CUDA-event timing of a call, and the profiler's trace of a
stretch of queries read into busy time, kernel time by name, launches and
the idle gaps with what the host was doing in them.

``cuda_ms`` is a copy of ``chip_smoke.py::cuda_ms``.  The reading of the
trace extends ``chip_smoke.py::device_profile``: instead of summing the
profiler's per-kernel totals it reads the timeline (``torch.profiler``'s
Chrome trace), so that busy time is the union of the device's operations
and each idle gap can be named by the host operation it fell in.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import shutil
import statistics
import tempfile
import warnings
from pathlib import Path

import torch

QUERY_SPAN = "portbench.query"          # one query: the call and its sync
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
_GLOBAL = re.compile(
    r"__global__\s+(?:static\s+)?void\s+"
    r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit\b.*?\bdef\s+(\w+)", re.S)
SOURCE_SUFFIXES = (".cu", ".cuh", ".cpp", ".cc", ".h", ".hpp", ".py")


def cuda_ms(fn, reps: int = 5, warmup: int = 1, batch: int = 1) -> float:
    """Median CUDA-event time of one call of ``fn`` in milliseconds.  With
    ``batch`` > 1 the events bracket that many calls back to back and the
    time is divided by them: the host's work for one call then overlaps
    the device's for the previous, so what remains is device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def program_kernels(package_dir: Path) -> dict:
    """Every kernel that the program's sources define, wherever they sit:
    CUDA ``__global__`` functions in any C++ or Python file, and Triton
    ``@triton.jit`` functions: {name: the file that defines it}."""
    found = {}
    for src in sorted(Path(package_dir).rglob("*")):
        if src.suffix not in SOURCE_SUFFIXES or not src.is_file():
            continue
        text = src.read_text(errors="replace")
        names = _GLOBAL.findall(text)
        if src.suffix == ".py":
            names += _TRITON.findall(text)
        for name in names:
            found.setdefault(name, str(src.relative_to(package_dir)))
    return found


def function_name(kernel: str) -> str:
    """``void (anonymous namespace)::segment_private<2, 6>(int const*, ...)``
    -> ``segment_private``."""
    name = kernel.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else kernel


@dataclasses.dataclass
class Stretch:
    """A profiled stretch of queries: its device operations (and, when the
    host was traced, its host operations) between ``t0`` and ``t1`` on the
    trace's clock (microseconds), and its length in seconds."""

    t0: float
    t1: float
    seconds: float
    queries: int
    device_ops: list        # (name, cat, start, dur), sorted by start
    host_ops: list          # (name, start, dur), sorted by start

    def busy(self) -> list:
        """The union of the device's operations, clipped to the stretch:
        [(start, end)]."""
        spans = []
        for _, _, s, d in self.device_ops:
            s, e = max(s, self.t0), min(s + d, self.t1)
            if e <= s:
                continue
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], e)
            else:
                spans.append([s, e])
        return spans

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def device_s(self, keep=lambda name, cat: True) -> float:
        return sum(d for name, cat, _, d in self.device_ops
                   if keep(name, cat)) / 1e6

    def kernels(self) -> list:
        return [name for name, cat, _, _ in self.device_ops
                if cat == "kernel"]

    def idle_gaps(self) -> dict:
        """Seconds of device idle time by the innermost host operation
        running at the middle of each gap."""
        starts = [s for _, s, _ in self.host_ops]
        out: dict[str, float] = {}
        edge = self.t0
        for s, e in self.busy() + [[self.t1, self.t1]]:
            if s > edge:
                mid = (edge + s) / 2
                name = "host outside any traced operation"
                i = bisect.bisect_right(starts, mid)
                while i > 0:
                    i -= 1
                    n, hs, hd = self.host_ops[i]
                    if hs + hd >= mid:
                        name = n if n != QUERY_SPAN else \
                            "program Python between torch operations"
                        break
                out[name] = out.get(name, 0.0) + (s - edge) / 1e6
            edge = max(edge, e)
        return out

    def device_ops_s(self) -> dict:
        """Device seconds by operation name (names cut to 160 characters)."""
        ops: dict[str, float] = {}
        for name, _, _, d in self.device_ops:
            ops[name[:160]] = ops.get(name[:160], 0.0) + d / 1e6
        return ops


def breakdown(device: Stretch, host: Stretch | None, top: int = 10) -> dict:
    """The device operations that took most time (from the device-only
    stretch) and the longest idle gaps by what the host was doing (from the
    host-traced stretch, where there is one)."""

    def largest(d):
        return [[k, v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": largest(device.device_ops_s()),
            "idle_gaps": largest((host or device).idle_gaps())}


class Profiler:
    """``torch.profiler`` over a stretch of queries.

    ``host=False`` traces the card alone (CUPTI's activity records): the
    host runs at nearly its own speed, so busy and idle time read true.
    ``host=True`` also records every host operation, which slows the host
    several-fold per operation; such a stretch only names what the host
    was doing in each idle gap.  Its queries are marked with
    :data:`QUERY_SPAN`.
    """

    def __init__(self, device: torch.device, host: bool):
        act = torch.profiler.ProfilerActivity
        acts = [act.CUDA] if device.type == "cuda" and not host else \
            [act.CPU] + ([act.CUDA] if device.type == "cuda" else [])
        self.host = host
        self._prof = torch.profiler.profile(activities=acts)

    def start(self):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Warning: Profiler clears")
            self._prof.start()

    def stop(self, queries: int, seconds: float) -> Stretch:
        """Stop; ``queries`` ran in ``seconds`` (host clock) meanwhile."""
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Warning: Profiler clears")
            self._prof.stop()
        tmp = tempfile.mkdtemp(prefix="portbench-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return read_trace(events, queries, seconds)


def read_trace(events: list, queries: int, seconds: float) -> Stretch:
    """A :class:`Stretch` from Chrome-trace events (complete events only).
    Where the host was traced, the query spans bound the stretch; else the
    device's first and last operations do, and ``queries`` and
    ``seconds`` are the host's count and clock."""
    dev, host, spans = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, s, d = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append((e["name"], cat, s, d))
        elif cat in HOST_CATS:
            host.append((e["name"], s, d))
            if e["name"] == QUERY_SPAN and cat == "user_annotation":
                spans.append((s, s + d))
    if spans:
        t0, t1 = min(s for s, _ in spans), max(e for _, e in spans)
        queries, seconds = len(spans), (t1 - t0) / 1e6
        dev = [op for op in dev if op[2] < t1 and op[2] + op[3] > t0]
    elif dev:
        t0, t1 = min(op[2] for op in dev), max(op[2] + op[3] for op in dev)
    else:
        t0 = t1 = 0.0
    dev.sort(key=lambda op: op[2])
    host.sort(key=lambda op: op[1])
    return Stretch(t0=t0, t1=t1, seconds=seconds, queries=queries,
                   device_ops=dev, host_ops=host)
