"""One run of one cell: set-up, the measured window, the traced stretch, the
metric readers, and the check of what the window produced.

The window is a closed loop of one session: call the program's entry
(``groupby_agg``, or the one the configuration names) on the resident
table, wait for its results (``torch.cuda.synchronize``), stamp the
latency, send the next, for the run's seconds.  Its first answer, two
answers at times drawn from the seed and its last are kept on the host;
after the window they are held to the plain reference and to an answer
over a seeded permutation of the rows (``checks.py``).  With ``trace``,
the profiler covers two stretches of the window: from 40% of it, for a
second or a fifth of it, the card alone (the per-layer metrics read this
one); then, for half a second or a tenth, the card and the host (it names
the host's work in each idle gap).  The first sampled answer falls before
the stretches.

Where the cell runs as several ranks (``ranks.py``), :func:`run_cell` is
rank 0, the coordinator: before each of its calls of the entry it tells
the other ranks, which follow (``ranks.follow``), to make the same call on
their own rows, so every rank calls the entry the same number of times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import inspect
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import checks, devtrace, traffic, work
from portbench.catalog import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
STRETCH_AT = 0.4          # the device-only stretch starts here in the window
STRETCH_S = 1.0           # and lasts this long at most (a fifth of it)
HOST_STRETCH_S = 0.5      # then the host-traced stretch (a tenth at most)
SAMPLE_SPANS = ((0.05, 0.35), (0.65, 0.95))


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: Cell
    config: dict
    device: torch.device
    device_kind: str
    rows: int
    groups: int
    values: torch.Tensor | None       # resident until the readers are done
    keys: torch.Tensor | None
    setup_s: float
    latencies_s: list
    window_s: float
    resident_bytes: int
    peak_bytes: int
    stretch: devtrace.Stretch | None
    stretch_queries: frozenset
    hand_kernels: frozenset
    query: object = None       # one more query over the resident table
    rank_rows: int = 0         # rank 0's rows; ``rows`` counts every rank's

    def hand_kernel_s(self) -> float:
        """Device seconds in the program's hand-written kernels over the
        stretch."""
        return self.stretch.device_s(
            lambda name, cat: cat == "kernel"
            and devtrace.function_name(name) in self.hand_kernels)


def program_entry(device: torch.device):
    """The system under test: ``repro_torch.ops.groupby_agg``."""
    from repro_torch.ops import groupby_agg

    def entry(values, keys, groups, aggs):
        return groupby_agg(values, keys, groups, aggs, device=device)

    return entry


def entry_for(bench, config: dict, device: torch.device, group=None):
    """The configuration's program entry: ``entries/<entry>.py``'s
    ``build(device, group)`` where it names one (``group``: the ranks'
    process group, None in one process), else :func:`program_entry`."""
    mod = bench.entry(config)
    return program_entry(device) if mod is None else mod.build(device, group)


def draw_rows(cell: Cell, config: dict, seed: int, device: torch.device,
              rank: int = 0, world: int = 1) -> tuple:
    """One rank's rows in the mix's order: ``(values, keys, groups)``.  The
    table and the row order are drawn from seeds of their own, tagged with
    the rank where there are several (a world of one draws what one process
    draws); a generator whose ``draw`` takes ``shard`` gets
    ``(rank, world)``."""
    def tag(use):
        return use if world == 1 else f"{use}/{rank}"

    gen = cell.bench.generator(config)
    shard = {"shard": (rank, world)} \
        if "shard" in inspect.signature(gen.draw).parameters else {}
    values, keys, groups = gen.draw(device, config,
                                    subseed(seed, tag("table")), **shard)
    values, keys = traffic.arrange(values, keys, cell.traffic,
                                   subseed(seed, tag("traffic")))
    return values, keys, groups


def all_rows(cell: Cell, config: dict, seed: int, device: torch.device,
             rank: int, world: int, values, keys) -> tuple:
    """Every rank's rows in rank order: this rank's own as they are
    resident, the others' drawn again from the seed."""
    if world == 1:
        return values, keys
    parts = [(values, keys) if r == rank else
             draw_rows(cell, config, seed, device, r, world)[:2]
             for r in range(world)]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([k for _, k in parts]))


def permuted_share(values, keys, seed: int, rank: int = 0,
                   world: int = 1) -> tuple:
    """Rank ``rank``'s equal share of one seeded permutation of all ranks'
    rows (``values``, ``keys``: all of them, in rank order), so that rows
    move between ranks; in one process, the rows permuted."""
    n = keys.shape[0]
    gen = torch.Generator(device=keys.device)
    gen.manual_seed(subseed(seed, "check"))
    perm = torch.randperm(n, generator=gen, device=keys.device)
    share = perm[n * rank // world:n * (rank + 1) // world]
    return values[share], keys[share]


class UnlistedKernels(RuntimeError):
    """The program defines a kernel that ``hand_kernels/*.json`` does not
    name: its time would be counted as glue, so the run gives no result."""


def check_kernels(pinned: frozenset, package_dir: Path) -> None:
    unlisted = {name: src for name, src in
                devtrace.program_kernels(package_dir).items()
                if name not in pinned}
    if unlisted:
        raise UnlistedKernels(
            "the program defines kernels that no hand_kernels/*.json of "
            "the benchmark names: " + ", ".join(
                f"{n} ({src})" for n, src in sorted(unlisted.items())))


def program_dir() -> Path:
    import repro_torch
    return Path(repro_torch.__file__).resolve().parent


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def smi(fields: str) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi exit {out.returncode}"


def host_probe_ms() -> float:
    """The median time of a fixed pure-Python loop: how fast the host core
    that this process runs on is just now (the card's clock is read by
    ``nvidia-smi``; the host's is not)."""
    times = []
    for _ in range(5):
        t = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i % 7
        times.append(time.perf_counter() - t)
    return 1e3 * statistics.median(times)


def to_host(answer: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in answer.items()}


def _planned(entry, args, sync) -> str:
    """Run one call with the program's trace buffer on and return its
    ``plan.groupby`` decision."""
    from repro_torch.obs import trace as ptrace
    ptrace.configure(None)
    try:
        entry(*args)
        sync()
        plans = [e["attrs"] for e in ptrace.events()
                 if e["name"] == "plan.groupby"]
    finally:
        ptrace.disable()
    if not plans:
        return "no plan.groupby event"
    p = plans[-1]
    return (f"method={p['method']} source={p['source']} chunk={p['chunk']} "
            f"levels={p['levels']} ncols={p['ncols']}")


@dataclasses.dataclass
class Window:
    """What the measured window produced."""

    latencies_s: list       # every query's, call to synchronized results
    seconds: float          # first query's start to last query's end
    kept: list              # host copies of the sampled answers, first first
    traced: list            # indices of the queries in a profiled stretch
    stretches: dict         # "device" (card only) / "host" -> Stretch


def measure(query, seconds: float, trace: bool, seed: int,
            dev: torch.device, turn=None) -> Window:
    """The closed loop: ``query()`` (the call and its sync) again and
    again for ``seconds``, with the sampled answers kept and, with
    ``trace``, the two profiled stretches.  ``turn(i)``, where given, runs
    before query ``i`` and outside its stamp (the ranks' agreement)."""
    rng = random.Random(seed)
    sample_at = [rng.uniform(a, b) * seconds for a, b in SAMPLE_SPANS]
    lengths = {"device": min(STRETCH_S, 0.2 * seconds),
               "host": min(HOST_STRETCH_S, 0.1 * seconds)}
    phase = "before" if trace else "done"
    win = Window([], 0.0, [], [], {})
    prof, p_first, p_queries = None, 0.0, 0
    start = time.perf_counter()
    while True:
        if turn is not None:
            turn(len(win.latencies_s))
        if phase == "before" and \
                time.perf_counter() - start >= STRETCH_AT * seconds:
            phase = "device"
            prof = devtrace.Profiler(dev, host=False)
            prof.start()
        mark = torch.profiler.record_function(devtrace.QUERY_SPAN) \
            if phase == "host" else contextlib.nullcontext()
        q0 = time.perf_counter()
        with mark:
            out = query()
        q1 = time.perf_counter()
        win.latencies_s.append(q1 - q0)
        if phase in lengths:
            win.traced.append(len(win.latencies_s) - 1)
            p_first = q0 if p_queries == 0 else p_first
            p_queries += 1
            if q1 - p_first >= lengths[phase]:
                win.stretches[phase] = prof.stop(p_queries, q1 - p_first)
                phase = "host" if phase == "device" else "done"
                prof, p_queries = None, 0
                if phase == "host":
                    prof = devtrace.Profiler(dev, host=True)
                    prof.start()
        if len(win.latencies_s) == 1:
            win.kept.append(to_host(out))
        elif sample_at and q0 - start >= sample_at[0]:
            win.kept.append(to_host(out))
            sample_at.pop(0)
        if q1 - start >= seconds and phase != "before":
            break
        out = None
    win.seconds = q1 - start
    if prof is not None:
        win.stretches[phase] = prof.stop(p_queries, q1 - p_first)
    win.kept.append(to_host(out))
    return win


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", entry=None, scale: dict | None = None,
             t0: float | None = None, say=print, team=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).

    ``entry`` replaces the program (the control, or a fault in a test);
    ``scale`` overrides sizes of the configuration (tests on the CPU);
    ``team`` is rank 0's place among several ranks (``ranks.Team``), None
    in one process.
    """
    t0 = time.perf_counter() if t0 is None else t0
    hand = cell.bench.hand_kernels()
    check_kernels(hand, program_dir())
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config = dict(cell.config, **(scale or {}))
    bench = cell.bench
    world = 1 if team is None else team.world
    go = (lambda: None) if team is None else team.query
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    if cuda:
        say(f"portbench: card {smi('name,power.limit')}")
    marks = [("torch and the card", time.perf_counter())]
    values, keys, groups = draw_rows(cell, config, seed, dev, 0, world)
    sync()
    marks.append(("table", time.perf_counter()))
    rows = int(keys.shape[0])
    by_rank = [rows] if team is None else team.gather(rows)
    aggs = [tuple(a) for a in config["aggregates"]]
    resident = values.numel() * values.element_size() \
        + keys.numel() * keys.element_size()
    if entry is None:
        entry = entry_for(bench, config, dev,
                          None if team is None else team.group)
    go()
    say(f"portbench: plan {_planned(entry, (values, keys, groups, aggs), sync)}")
    marks.append(("first query", time.perf_counter()))
    go()
    entry(values, keys, groups, aggs)
    sync()
    marks.append(("second query", time.perf_counter()))
    say("portbench: set-up " + ", ".join(
        f"{name} {t - prev:.3f} s" for (name, t), (_, prev)
        in zip(marks, [("process", t0)] + marks[:-1])))
    say(f"portbench: cell {cell.name} rows={sum(by_rank)} groups={groups} "
        f"row_order={cell.traffic['row_order']} least_bytes="
        f"{work.least_bytes(config, sum(by_rank), groups)}")
    if team is not None:
        say(f"portbench: {world} ranks, one to a card, rows by rank "
            f"{by_rank}; the figures below are rank 0's")
    peak = work.peaks(kind)
    if peak:
        least, by = work.least_seconds(config, rows, groups, peak)
        say(f"portbench: least time {least * 1e3:.6f} ms, bound by {by}")
    setup_s = time.perf_counter() - t0

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def query():
        out = entry(values, keys, groups, aggs)
        sync()
        return out

    def lockstep_query():
        go()
        return query()

    win = measure(query, seconds, trace, subseed(seed, "samples"), dev,
                  turn=None if team is None else team.turn)
    peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    # (peak, resident) of every rank; the fullest card sets the work memory
    memory = [(peak_bytes, resident)] if team is None else \
        team.memory(peak_bytes, resident)
    fullest = max(memory, key=lambda m: m[0] - m[1])
    lat, stretch = win.latencies_s, win.stretches.get("device")
    half = len(lat) // 2
    say(f"portbench: window {len(lat)} queries in {win.seconds:.6f} s; mean "
        f"query ms, first and second half: "
        f"{1e3 * sum(lat[:half]) / max(half, 1):.4f} "
        f"{1e3 * sum(lat[half:]) / (len(lat) - half):.4f}")
    if stretch is not None:
        say(f"portbench: traced {stretch.queries} queries in "
            f"{stretch.seconds:.6f} s (device only), "
            f"{len(win.traced) - stretch.queries} with the host traced")
    if cuda:
        say(f"portbench: card after the window "
            f"{smi('clocks.sm,power.draw,temperature.gpu')}")
    say(f"portbench: host after the window: a fixed Python loop "
        f"{host_probe_ms():.4f} ms")

    run = Run(cell=cell, config=config, device=dev, device_kind=kind,
              rows=sum(by_rank), groups=groups, values=values, keys=keys,
              setup_s=setup_s, latencies_s=lat, window_s=win.seconds,
              resident_bytes=fullest[1], peak_bytes=fullest[0],
              stretch=stretch, stretch_queries=frozenset(win.traced),
              hand_kernels=hand, query=lockstep_query, rank_rows=rows)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = bench.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    run.values = run.keys = run.query = None

    if team is not None:
        team.permuted()
    values, keys = all_rows(cell, config, seed, dev, 0, world, values, keys)
    pv, pk = permuted_share(values, keys, seed, 0, world)
    permuted = to_host(entry(pv, pk, groups, aggs))
    del pv, pk
    # every other rank's first answer, held to rank 0's
    others = [] if team is None else team.done(win.kept[0])[1:]
    ref = to_host(bench.reference(config).results(values, keys, groups,
                                                  aggs))
    del values, keys
    numbers = checks.compare(win.kept, permuted, ref, config["limits"],
                             others=others)

    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": world if team is not None else cell.chips,
                  "memory_peak_bytes": max(p for p, _ in memory)}
    result = {"correct": checks.passed(numbers), "attempted": len(lat),
              "failed": 0, "metrics": metrics, "device": device_rec}
    if stretch is not None:
        device_rec["busy_s"] = stretch.busy_s()
        device_rec["window_s"] = stretch.seconds
        result["breakdown"] = devtrace.breakdown(stretch,
                                                 win.stretches.get("host"))
    result["checks"] = numbers
    return result
