#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails loudly (a mismatch exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build both hand-written CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, started together);
3. each kernel against its plain PyTorch version, bitwise, on the card:
   (n, G) from 1 to 2^20 groups, specs L=1/2/3 at W=18 and L=2 at W=12,
   pruned level windows, denormals, ±cancellation and mixed magnitudes,
   ragged row counts, 1 to 8 columns, G on each side of the segment
   kernel's path limits, padding ids and views not 16-byte aligned
   (``nvcc -Xptxas -v``'s registers and spills of every kernel are printed
   after the build);
4. the main path through ``repro_torch.ops.groupby_agg`` at the size users
   run: TPC-H Q1 at scale factor 10 (59,986,052 lineitem rows, 4 groups,
   the aggregate list of ``examples/groupby_analytics.py``) through the
   segment kernel, the same table without GROUP BY through the rsum kernel,
   and Q18's inner ``GROUP BY l_orderkey`` at SF10 (15,000,000 groups); row
   permutations, strategies and a CPU run of a 2^20-row subset must give
   byte-identical results and table digests;
5. CUDA-event times (medians) of each kernel (per launch over a run of
   launches, and for one call with its host work), its plain version, the
   one PyTorch call that computes the same function (timed in turns with
   the rsum kernel), the segment kernel's tiled path at Q18's 15,000,000
   groups and at Q9's ``GROUP BY nation, o_year`` (175 groups over SF10's
   lineitem rows of green parts, in lineitem order and sorted by group),
   the end-to-end ``groupby_agg`` and the conventional
   float32 ``index_add_`` GROUPBY of the same columns — the
   non-reproducible yardstick — and one profiled Q1 call: device time per
   operation and the device's idle share;
6. calibration: ``repro_torch.ops.calibrate.calibrate(backend="cuda")`` on
   its quick grid (2^26 rows) into a cache in a temporary directory; the ns
   per row of every strategy at every point, the planner's cold-start
   constants fitted to them (``calibrate.fit_cold_model``), the planner's
   choice at the Q1, flat, Q18 and Q9 shapes with and without the cache,
   and Q1's digests under every strategy the measured race priced;
7. sharded: ``repro_torch.ops.sharded`` in spawned rank processes joined by
   a ``file://`` store: one rank over NCCL at Q1 SF10, then 2 and 4 ranks
   on the same card over gloo (NCCL takes one rank per GPU) at a 2^22-row
   Q1; every rank's digests must equal one-device ``groupby_agg``'s, and
   ``repro_psum`` of the Q1 table is timed;
8. baselines: the paper's RSUM algorithms (``core/rsum.py``), summation
   buffers and DECIMAL sums on the card at small n, bit for bit against
   the same calls on the CPU, with their times;
9. stream: the durable streaming store (``repro_torch.stream``) on the
   card over all of Q1's SF10 rows in 2^20-row batches: a ``StreamStore``
   with a WAL (fsync always) and a snapshot halfway, recovered from both;
   the flat stream through the rsum kernel; 2 and 4 hash shards; a
   ``WindowedStore`` (30-day windows over l_shipdate drawn from dbgen's
   domain, 2^24 rows) in event-time order, in a shuffled batch order and
   recovered from its WAL; crashes injected after a WAL write and inside
   a commit, each retried with its delivery tag; the in-process
   ``StreamService`` with 4 writers (pipelined and serialized); and a
   ``ReplicatedStore`` failover.  Every digest must equal one-shot
   ``groupby_agg``'s, the segment kernel must launch at least twice per
   batch and the rsum kernel once; ingest rows/s, WAL bytes, recovery
   seconds and one merge of the Q1 table are timed.

10. train: the port's reproducible training (``repro_torch.launch``) of
   smollm-135m at full width and depth (30 layers, d=576, vocab 49152,
   bfloat16), seq 1024, global batch 8 in quanta of one sequence, 3 steps,
   in a spawned rank over NCCL: ``baseline``, ``repro_zero2``, ``repro``, a
   rerun and a restart from an injected failure at step 2 through a
   checkpoint — losses, parameter and optimizer digests equal across the
   repro runs — and one ``repro_embed`` step; the same width at 2 layers
   (seq 256, 2 steps) at 1 rank and at 2 ranks over gloo with card
   tensors, digests equal (4 ranks cut to keep the whole script near half
   its time limit; the CPU tests hold widths 1, 2 and 4); the global norm
   of one quantum's full-width gradient through the rsum kernel once per
   leaf, with the CPU's bits;
   the embedding gradient's GROUPBY (G = 49152, 576 columns) under
   ``scatter``, the planner's pick and the segment kernel, one table; both
   kernels against their plain versions at these shapes.  Prints ms per
   step of each mode (host clock, synchronized), the
   ``repro_zero2``/``baseline`` ratio, launches per step and peak memory.
11. serve: ``repro_torch.launch.serve`` at full width and depth on
   granite-moe-3b-a800m (32 layers, 40 experts top-8), hymba-1.5b and
   xlstm-350m, random weights drawn on the card from the seed, batch 8,
   prompts of 512 tokens (1,024 for hymba, whose decode then wraps its
   1,024-slot window), 32 greedy steps: a second generate gives the same
   tokens and logits of the same bytes; in float32 compute, the last
   decode step's logits equal a prefill of the prompt and the generated
   tokens within 2% of the largest logit (granite at capacity factor E/K,
   where no prefill group drops a token, as no decode step does; the
   bfloat16 gap is printed: granite's routing flips on bfloat16
   roundings); ``serve_tokens_total``
   grows by batch x steps.  Prints TTFT (cold and warm), decode tokens/s,
   peak memory, and one decode step's kernel launches and device idle
   share (``torch.profiler``).
12. train_families: the same three at full width cut to 2 units (granite
   and hymba 2 layers, xlstm 4 blocks), seq 256 (xlstm 128), global batch
   4 in quanta of one sequence, 2 steps, in a spawned NCCL rank:
   ``baseline``, ``repro_zero2``, ``repro`` and a rerun, with ``repro`` =
   ``repro_zero2`` = rerun in losses, parameter and optimizer digests,
   granite's ``repro`` at 2 gloo ranks = 1 rank (the MoE's group-local
   dispatch), and the rsum kernel once per gradient leaf per step (the
   global norm).  Prints ms per step and peak memory of each mode.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON summary.  Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores

SF10_LINEITEM = 59_986_052
SF10_ORDERS = 15_000_000
Q1_AGGS = [("sum", 0), ("sum", 1), ("sum_prod", 1, 2), ("mean", 0),
           ("mean", 1), ("mean", 3), ("var", 1), ("count",), ("min", 0),
           ("max", 1)]
FLAT_AGGS = [("sum", 0), ("sum", 1), ("sum_prod", 1, 2), ("mean", 0),
             ("count",)]
# Q1's groups (returnflag, linestatus): A-F, N-F, N-O, R-F, with the shares
# of TPC-H's Q1 answer at SF1
Q1_SHARES = (0.2499, 0.0066, 0.4936, 0.2499)
# Q9: o_orderdate's days in each year 1992..1998 (dbgen draws it uniformly
# from 1992-01-01 to 1998-08-02, i.e. ENDDATE - 151 days), and the share of
# parts with 'green' in p_name (5 distinct words of dbgen's 92 colors)
Q9_YEAR_DAYS = (366, 365, 365, 365, 366, 365, 214)
Q9_NATIONS = 25
Q9_GREEN = 5 / 92


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 5, warmup: int = 1, batch: int = 1):
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


def paired_ms(torch, kernel, library, batch: int) -> tuple[float, float]:
    """(kernel, library) times in one window order library, kernel, kernel,
    library; each the mean of its two medians."""
    lib1 = cuda_ms(torch, library, reps=10, batch=batch)
    k1 = cuda_ms(torch, kernel, reps=10, batch=batch)
    k2 = cuda_ms(torch, kernel, reps=10, batch=batch)
    lib2 = cuda_ms(torch, library, reps=10, batch=batch)
    return (k1 + k2) / 2, (lib1 + lib2) / 2


def host_ms(torch, fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize, in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def make_values(np, kind: str, n: int, ncols: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "wide":
        x = rng.standard_normal((n, ncols)) * np.exp(
            rng.standard_normal((n, ncols)) * 3)
    elif kind == "mixed":
        x = rng.standard_normal((n, ncols)) * 1e3
        x[: n // 2] *= 1e-8
        x[n // 3] = 4.2e8
    elif kind == "cancel":
        half = rng.standard_normal((n // 2, ncols)) * 1e3
        noise = rng.standard_normal((n - 2 * (n // 2), ncols)) * 1e-3
        x = np.concatenate([half, -half, noise])
        rng.shuffle(x)
    elif kind == "denormal":
        tiny = np.float32(1.4e-45) * rng.integers(1, 200, (n, ncols))
        x = np.where(rng.random((n, ncols)) < 0.4, tiny,
                     rng.standard_normal((n, ncols)) * 0.25)
        x[0] = 1.0
    else:
        assert kind == "ints"
        x = rng.integers(-1000, 1000, (n, ncols))
    return x.astype(np.float32)


def kernel_cases(torch, np, dev, R, S, acc, prescan, ReproSpec):
    """Every kernel against its plain version; returns the max |diff|."""
    specs = [ReproSpec(L=1), ReproSpec(L=2), ReproSpec(L=3),
             ReproSpec(L=2, W=12)]
    cases = [  # n, G, ncols, kind, group tile cap, padding share, unaligned
        (1, 1, 1, "wide", None, 0.0, False),
        (1000, 16, 3, "wide", None, 0.0, False),
        (100_003, 700, 6, "mixed", None, 0.0, False),
        (300_001, 4, 6, "cancel", None, 0.0, False),
        (200_000, 8, 2, "denormal", None, 0.0, False),
        (20_000, 300, 2, "wide", 8, 0.0, False),
        (1 << 20, 1 << 20, 1, "wide", None, 0.0, False),
        (400_000, 1 << 16, 2, "ints", None, 0.0, False),
        # ragged row counts around the 4-row and 16-byte vector edges, and
        # every column count of the rsum mapping and the private templates
        (3, 3, 3, "wide", None, 0.0, False),
        (5, 3, 4, "mixed", None, 0.0, False),
        (4097, 3, 5, "wide", None, 0.0, False),
        (4097, 5, 7, "cancel", None, 0.0, False),
        (5, 2, 8, "wide", None, 0.0, False),
        (4097, 4, 6, "wide", None, 0.1, False),
        # views whose data_ptr is not 16-byte aligned: private and tiled
        (100_003, 4, 6, "mixed", None, 0.0, True),
        (10_001, 700, 5, "wide", None, 0.05, True),
        (4097, 20_000, 1, "wide", None, 0.0, True),
    ]
    worst, count = 0, 0
    for si, spec in enumerate(specs):
        # G on each side of the private path's limit and of the tiled
        # path's one-tile limit at Q1's width
        private_max, one_tile = S.group_limits(6, spec.L)
        limits = [(50_000, g, 6, "wide", None, 0.05, False)
                  for g in (private_max, private_max + 1, one_tile,
                            one_tile + 1) if g >= 1]
        for ci, (n, g, ncols, kind, tile, pad, unaligned) in \
                enumerate(cases + limits):
            vals = make_values(np, kind, n, ncols, 100 * si + ci)
            rng = np.random.default_rng(7 + ci)
            keys = rng.integers(0, g, n).astype(np.int32)
            keys[rng.random(n) < pad] = -1
            if unaligned:           # shift both by one element
                flat = torch.from_numpy(np.concatenate(
                    [np.zeros(1, np.float32), vals.reshape(-1)])).to(dev)
                x = flat[1:].view(n, ncols)
                ids = torch.from_numpy(np.concatenate(
                    [np.zeros(1, np.int32), keys])).to(dev)[1:]
                check(x.data_ptr() % 16 != 0 and ids.data_ptr() % 16 != 0,
                      "unaligned case is aligned")
            else:
                x = torch.from_numpy(vals).to(dev)
                ids = torch.from_numpy(keys).to(dev)
            e1 = acc.required_e1(x, spec, axis=0)
            windows = {(0, spec.L), prescan.static_window(x, e1, spec)}
            for lv in sorted(windows):
                A, iu = R.ladder(e1, spec, lv)
                got = S.segment_levels_kernel(x, ids, g, A, iu, spec, tile)
                want = S.segment_levels_plain(x, ids, g, A, iu, spec)
                got_f = R.rsum_levels_kernel(x, A, iu, spec)
                want_f = R.rsum_levels_plain(x, A, iu, spec)
                torch.cuda.synchronize()
                path = S.launch_shape(n, g, ncols, A.shape[0], 132,
                                      tile).path
                for a, b, what in ((got, want, f"segment ({path})"),
                                   (got_f, want_f, "rsum")):
                    for ta, tb in zip(a, b):
                        check(ta.dtype == tb.dtype and ta.shape == tb.shape,
                              f"{what} kernel layout differs")
                        diff = (ta.to(torch.int64) - tb.to(torch.int64)) \
                            .abs().max().item() if ta.numel() else 0
                        worst = max(worst, diff)
                        check(diff == 0, f"{what} kernel != plain: "
                              f"spec L={spec.L} W={spec.W} n={n} G={g} "
                              f"ncols={ncols} {kind} levels={lv} "
                              f"pad={pad} unaligned={unaligned}")
                count += 1
    emit(phase="kernels_vs_plain", cases=count, max_abs_err=worst,
         bitwise=True)
    return worst


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def q1_table(torch, dev, n: int, seed: int):
    """Q1's lineitem columns (quantity, extendedprice, 1 - discount,
    discount) and its (returnflag, linestatus) group, drawn on the card from
    dbgen's domains: quantity 1..50, discount 0.00..0.10, extendedprice =
    quantity * p_retailprice of a random part of SF10's 2,000,000."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f64 = torch.float64
    qty = torch.randint(1, 51, (n,), generator=gen, device=dev).to(f64)
    part = torch.randint(1, 2_000_001, (n,), generator=gen, device=dev)
    retail = (90_000 + (part // 10) % 20_001 + 100 * (part % 1000)).to(f64) \
        / 100.0
    disc = torch.randint(0, 11, (n,), generator=gen, device=dev).to(f64) \
        / 100.0
    values = torch.stack([qty, qty * retail, 1.0 - disc, disc],
                         dim=1).to(torch.float32)
    cuts = torch.tensor(Q1_SHARES, dtype=torch.float64).cumsum(0)[:-1]
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    keys = torch.bucketize(u, cuts.to(dev)).to(torch.int32)
    return values.contiguous(), keys


def q18_table(torch, dev, orders: int, seed: int):
    """Q18's inner ``GROUP BY l_orderkey``: 1..7 lineitems per order (dbgen),
    quantity 1..50; the key is the order's dense index."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    per_order = torch.randint(1, 8, (orders,), generator=gen, device=dev)
    keys = torch.repeat_interleave(
        torch.arange(orders, dtype=torch.int32, device=dev), per_order)
    qty = torch.randint(1, 51, (keys.shape[0],), generator=gen, device=dev)
    return qty.to(torch.float32)[:, None], keys


def q9_table(torch, dev, orders: int, seed: int):
    """Q9's ``GROUP BY nation, o_year`` (25 x 7 groups) over the lineitem
    rows of green parts (``p_name LIKE '%green%'``), in lineitem order,
    drawn on the card from dbgen's domains: 1..7 lineitems per order, one
    o_orderdate per order, the supplier's s_nationkey uniform over 25
    nations, a row's part green with probability 5/92.  The value is Q9's
    ``amount = l_extendedprice * (1 - l_discount) - ps_supplycost *
    l_quantity`` (ps_supplycost 1.00..1000.00); the key is
    ``nation * 7 + (o_year - 1992)``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f64 = torch.float64
    per_order = torch.randint(1, 8, (orders,), generator=gen, device=dev)
    day = torch.randint(0, sum(Q9_YEAR_DAYS), (orders,), generator=gen,
                        device=dev)
    cuts = torch.tensor(Q9_YEAR_DAYS, device=dev).cumsum(0)[:-1]
    year = torch.repeat_interleave(
        torch.bucketize(day, cuts, right=True), per_order)
    year = year[torch.rand(year.shape[0], generator=gen, device=dev)
                < Q9_GREEN]
    n = year.shape[0]
    nation = torch.randint(0, Q9_NATIONS, (n,), generator=gen, device=dev)
    qty = torch.randint(1, 51, (n,), generator=gen, device=dev).to(f64)
    part = torch.randint(1, 2_000_001, (n,), generator=gen, device=dev)
    retail = (90_000 + (part // 10) % 20_001 + 100 * (part % 1000)).to(f64) \
        / 100.0
    disc = torch.randint(0, 11, (n,), generator=gen, device=dev).to(f64) \
        / 100.0
    cost = torch.randint(100, 100_001, (n,), generator=gen,
                         device=dev).to(f64) / 100.0
    amount = qty * retail * (1.0 - disc) - cost * qty
    keys = (nation * len(Q9_YEAR_DAYS) + year).to(torch.int32)
    return amount.to(torch.float32)[:, None].contiguous(), keys


def device_profile(torch, fn, wall_ms: float) -> dict:
    """Where one call of ``fn`` spends device time: device time per torch
    operation and per kernel, the kernel launches, and the device's idle
    share of the unprofiled wall time ``wall_ms`` (busy time summed over
    kernels only, so an operation and the kernels it launched are not
    counted twice)."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, kernels, launches = {}, {}, 0
    for e in prof.key_averages():
        if device_us(e) <= 0:
            continue
        on_card = str(e.device_type).endswith("CUDA")
        side = kernels if on_card else ops
        launches += e.count if on_card else 0
        key = e.key[:100]
        side[key] = side.get(key, 0.0) + device_us(e) / 1e3
    busy_ms = sum(kernels.values())

    def top(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:8])

    return {"device_busy_ms": busy_ms, "wall_ms": wall_ms,
            "kernel_launches": launches,
            # None: the profiler saw no kernel (not measured)
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms)
            if busy_ms else None,
            "top_op_device_ms": top(ops), "top_kernel_device_ms": top(kernels)}


def profile_q1(torch, fn, e2e_ms: float, card: str, limit: str) -> None:
    """:func:`device_profile` of one end-to-end Q1 call."""
    rec = device_profile(torch, fn, e2e_ms)
    rec["e2e_ms"] = rec.pop("wall_ms")
    rec.pop("kernel_launches")
    emit(phase="profile_q1", card=card, power_limit=limit, **rec)


def same_results(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].cpu().numpy().tobytes() == b[k].cpu().numpy().tobytes()
        for k in a)


def planned_method(trace) -> str:
    plans = [e for e in trace.events() if e["name"] == "plan.groupby"]
    return plans[-1]["attrs"]["method"]


# ---------------------------------------------------------------------------
# phases 6-8: calibration, sharded GROUPBY, the paper's baselines
# ---------------------------------------------------------------------------

def sharded_rank(rank: int, world: int, store: str, out: str, backend: str,
                 n: int, seed: int) -> None:
    """One rank of the sharded phase: draw the Q1 table of ``n`` rows from
    ``seed`` on the card (every rank the same), aggregate its contiguous
    share with ``sharded_partial_agg`` on the card over ``backend``
    (``nccl`` or ``gloo``), and write its digests, its segment kernel
    launches and the time of ``repro_psum`` of the Q1 table."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core.collectives import repro_psum
    from repro_torch.core.types import ReproSpec
    from repro_torch.kernels.segment_rsum import ops as S
    from repro_torch.obs.fingerprint import (fingerprint_results,
                                             fingerprint_table)
    from repro_torch.ops.partial import finalize
    from repro_torch.ops.sharded import sharded_partial_agg

    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120),
        device_id=card if backend == "nccl" else None)
    try:
        spec = ReproSpec()
        values, keys = q1_table(torch, card, n, seed)
        cut = [n * r // world for r in range(world + 1)]
        values = values[cut[rank]:cut[rank + 1]]
        keys = keys[cut[rank]:cut[rank + 1]]
        dist.barrier()
        torch.cuda.synchronize()
        S.LAUNCHES = 0
        t0 = time.perf_counter()
        state = sharded_partial_agg(values, keys, 4, Q1_AGGS, spec)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        launches = S.LAUNCHES
        table = state.table
        times = []
        for _ in range(21):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            repro_psum(table, spec)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rec = {"rank": rank, "rows": cut[rank + 1] - cut[rank],
               "results_digest": fingerprint_results(finalize(state)),
               "table_digest": fingerprint_table(table, spec),
               "segment_launches": launches, "call_ms": call_ms,
               "psum_ms": statistics.median(times[1:])}
    finally:
        dist.destroy_process_group()
    Path(out, f"rank{rank}.json").write_text(json.dumps(rec))


def run_sharded(world: int, backend: str, n: int, seed: int,
                timeout_s: float = 300.0) -> list:
    """Spawn ``world`` ranks of :func:`sharded_rank` and return their
    records."""
    return spawn_ranks(sharded_rank, world, (backend, n, seed), timeout_s)


def baselines(torch, np, dev, card: str, limit: str) -> None:
    """The paper's baselines on the card at small n, bit for bit against the
    same calls on the CPU; host-clock times (synchronized), no claim."""
    from repro_torch.core import buffers, rsum
    from repro_torch.core.types import ReproSpec
    from repro_torch.numerics import DecimalSpec, decimal_segment_sum

    spec = ReproSpec()
    n, n_scalar, groups = 1 << 16, 1 << 12, 16
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(n) * np.exp(rng.standard_normal(n) * 2)) \
        .astype(np.float32)
    ids = rng.integers(0, groups, n).astype(np.int32)
    bsz = buffers.optimal_bsz(groups, 1, 4, cache_bytes=1 << 12)
    calls = {
        "rsum_scalar": (lambda v, k: rsum.rsum_scalar(v[:n_scalar], spec),
                        n_scalar),
        "rsum_simd": (lambda v, k: rsum.rsum_simd(v, spec, V=64), n),
        "rsum_simd_chunked": (lambda v, k: rsum.rsum_simd_chunked(
            v, spec, c=4096, V=64), n),
        "buffers": (lambda v, k: tuple(buffers.flush_all(buffers.append(
            buffers.init(groups, bsz, spec, device=v.device), k, v, spec),
            spec)), n),
        "decimal_segment_sum": (lambda v, k: decimal_segment_sum(
            v, k, groups, DecimalSpec(precision=9, scale=4)), n),
        "conventional_sum": (lambda v, k: (rsum.conventional_sum(v),), n),
    }
    xs = {d: torch.from_numpy(x).to(d) for d in ("cpu", dev)}
    ks = {d: torch.from_numpy(ids).to(d) for d in ("cpu", dev)}
    rec = {}
    for name, (fn, rows) in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(xs[dev], ks[dev])
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = fn(xs["cpu"], ks["cpu"])
        cpu_ms = (time.perf_counter() - t0) * 1e3
        if name != "conventional_sum":      # a float sum's order is free
            for a, b in zip(got, want):
                check(a.dtype == b.dtype and a.shape == b.shape
                      and a.cpu().numpy().tobytes()
                      == b.numpy().tobytes(),
                      f"baseline {name}: card != CPU")
        rec[name] = {"rows": rows, "card_ms": card_ms, "cpu_ms": cpu_ms,
                     "bitwise": name != "conventional_sum"}
    emit(phase="baselines", card=card, power_limit=limit, bsz=bsz, **rec)


# ---------------------------------------------------------------------------
# phase 9: the durable streaming store
# ---------------------------------------------------------------------------

def stream_digests(fp, results: dict, table) -> dict:
    """A stream store's fingerprints of a one-shot result and table."""
    return {"stream/table": fp.fingerprint_table(table),
            "stream/results": fp.fingerprint_results(results)}


def ship_days(torch, dev, n: int, seed: int):
    """l_shipdate in days since 1992-01-01, drawn on the card from dbgen's
    domain: o_orderdate uniform over 1992-01-01..1998-08-02, plus 1..121
    days."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    order = torch.randint(0, sum(Q9_YEAR_DAYS), (n,), generator=gen,
                          device=dev)
    ship = torch.randint(1, 122, (n,), generator=gen, device=dev)
    return (order + ship).to(torch.float64)


def batches_of(n: int, rows: int) -> list:
    return [slice(i, min(i + rows, n)) for i in range(0, n, rows)]


def drive_with_faults(faultinject, make, recover, values, keys, cuts, inj):
    """At-least-once client: deliver batch ``i`` tagged ``("chaos", i)``;
    on an injected crash rebuild the store from durable state and retry the
    batch.  Returns the store and each retry's answer."""
    store, retries = make(), []
    with faultinject.active(inj):
        i = 0
        while i < len(cuts):
            try:
                out = store.ingest(values[cuts[i]], keys[cuts[i]],
                                   client="chaos", seq=i)
                if retries and retries[-1][0] == i:
                    retries[-1] = (i, bool(out.get("duplicate")))
                i += 1
            except faultinject.InjectedCrash:
                store.wal.close()
                store = recover()
                retries.append((i, None))
    return store, retries


def stream_phase(torch, np, dev, values, keys, q1_want: dict,
                 flat_want: dict, spec, card: str, limit: str, seed: int,
                 batch_rows: int = 1 << 20, window_rows: int = 1 << 24):
    """The durable streaming store on the card over Q1 at SF10 (every row
    of ``values``): WAL, snapshot, recovery, the flat stream through the
    rsum kernel, shards, windows, injected crashes, the service and
    failover, each held to one-shot ``groupby_agg`` digests."""
    import asyncio
    import os
    import tempfile

    from repro_torch.kernels.rsum import ops as R
    from repro_torch.kernels.segment_rsum import ops as S
    from repro_torch.obs import fingerprint as fp
    from repro_torch.obs import trace
    from repro_torch.ops import groupby_agg
    from repro_torch.ops.partial import merge_all
    from repro_torch.runtime import faultinject
    from repro_torch.stream import (ReplicatedStore, ShardedStreamStore,
                                    StreamService, StreamStore,
                                    WindowedStore)

    n = values.shape[0]
    cuts = batches_of(n, batch_rows)
    rec = {"card": card, "power_limit": limit, "rows": n,
           "batch_rows": batch_rows, "batches": len(cuts)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        # -- StreamStore on the card: WAL (fsync always), mid-run snapshot,
        # recovery from the snapshot and the log
        wal, snaps = os.path.join(tmp, "q1.wal"), os.path.join(tmp, "snaps")
        store = StreamStore(4, Q1_AGGS, spec, wal=wal, device=dev)
        rec["warmup_s"] = store.warmup(batch_rows)
        trace.configure()
        S.LAUNCHES = R.LAUNCHES = 0
        snapshot_s = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, cut in enumerate(cuts):
            store.ingest(values[cut], keys[cut])
            if i == len(cuts) // 2:
                t1 = time.perf_counter()
                store.snapshot(snaps)
                snapshot_s = time.perf_counter() - t1
        store.flush()
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0 - snapshot_s
        seg_launches = S.LAUNCHES
        methods = sorted({e["attrs"]["method"] for e in trace.events()
                          if e["name"] == "plan.groupby"})
        trace.disable()
        check(methods == ["pallas"],
              f"stream micro-batches planned {methods}, not the kernel")
        check(seg_launches >= 2 * len(cuts),
              f"stream ingest launched the segment kernel {seg_launches} "
              f"times for {len(cuts)} batches (want >= 2 per batch)")
        got = store.fingerprints()
        check(got == q1_want, "stream store digests != groupby_agg's")
        plan = store._ensure_plan(batch_rows)
        # one merge of the Q1 table: the store's state with one batch's
        # partial (different lattices, so the merge demotes)
        part = store.prepare(values[cuts[0]], keys[cuts[0]])
        whole = store.state()
        merge_ms = host_ms(torch, lambda: merge_all([whole, part]), reps=21)
        elements = 4 * whole.table.k.shape[1] * whole.table.k.shape[2]
        wal_bytes = os.path.getsize(wal)
        store.wal.close()
        del store, part, whole
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = StreamStore.recover(wal, snaps, device=dev)
        again_fp = again.fingerprints()
        torch.cuda.synchronize()
        recovery_s = time.perf_counter() - t0
        check(again_fp == q1_want, "recovered stream store digests != "
              "groupby_agg's")
        again.wal.close()
        del again
        rec["store"] = {
            "ingest_s": ingest_s, "ingest_rows_per_s": n / ingest_s,
            "snapshot_s": snapshot_s, "wal_bytes": wal_bytes,
            "fsync": "always", "recovery_s": recovery_s,
            "planned_methods": methods, "coalesce": plan.coalesce,
            "pipeline_width": plan.pipeline,
            "segment_launches": seg_launches,
            "merge_ms": merge_ms, "merge_table_elements": elements,
            "merge_ns_per_element": merge_ms * 1e6 / elements,
            "digests_equal": True, "recovered_equal": True}

        # -- the flat stream (no GROUP BY) through the rsum kernel
        zeros = torch.zeros_like(keys)
        flat = StreamStore(1, FLAT_AGGS, spec, device=dev)
        S.LAUNCHES = R.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for cut in cuts:
            flat.ingest(values[cut], zeros[cut])
        flat.flush()
        torch.cuda.synchronize()
        flat_s = time.perf_counter() - t0
        rsum_launches = R.LAUNCHES
        check(rsum_launches >= len(cuts),
              f"flat stream launched the rsum kernel {rsum_launches} times "
              f"for {len(cuts)} batches (want >= 1 per batch)")
        check(flat.fingerprints() == flat_want,
              "flat stream digests != groupby_agg's")
        rec["flat"] = {"ingest_s": flat_s, "ingest_rows_per_s": n / flat_s,
                       "rsum_launches": rsum_launches,
                       "digests_equal": True}
        del flat, zeros

        # -- ShardedStreamStore, hash policy
        rec["sharded"] = {}
        for shards in (2, 4):
            sh = ShardedStreamStore(4, Q1_AGGS, spec, num_shards=shards,
                                    policy="key_hash", device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for cut in cuts:
                sh.ingest(values[cut], keys[cut])
            sh.flush()
            torch.cuda.synchronize()
            sh_s = time.perf_counter() - t0
            check(sh.fingerprints() == q1_want,
                  f"{shards}-shard stream digests != groupby_agg's")
            rec["sharded"][str(shards)] = {"ingest_s": sh_s,
                                           "ingest_rows_per_s": n / sh_s,
                                           "digests_equal": True}
            del sh

        # the first window_rows rows: the windowed store's WAL logs whole
        # rows, and the service phase sends host copies
        m = min(window_rows, n)
        wv, wk = values[:m], keys[:m]
        res_m, tab_m = groupby_agg(wv, wk, 4, Q1_AGGS, spec,
                                   return_table=True, device=dev)
        m_want = stream_digests(fp, res_m, tab_m)
        wcuts = batches_of(m, batch_rows)

        # -- WindowedStore: 30-day windows over l_shipdate, in event-time
        # order, then in a shuffled batch order, then recovered from its WAL
        days = ship_days(torch, dev, m, seed + 9)
        order = torch.sort(days, stable=True).indices
        tv, tk, td = wv[order], wk[order], days[order]
        span = int(days.max().item()) // 30 + 1
        retention = span                     # no row is late in any order
        wwal = os.path.join(tmp, "window.wal")
        runs, win_fps = {}, {}
        perm = np.random.default_rng(seed + 10).permutation(len(wcuts))
        for label, seq in (("in_order", range(len(wcuts))),
                           ("shuffled", perm.tolist())):
            win = WindowedStore(4, Q1_AGGS, spec, width=30.0,
                                retention=retention, device=dev,
                                wal=wwal if label == "in_order" else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in seq:
                cut = wcuts[b]
                win.ingest(tv[cut], tk[cut], td[cut])
            win_fps[label] = win.fingerprints()
            torch.cuda.synchronize()
            runs[label] = {"ingest_s": time.perf_counter() - t0,
                           "late_dropped": win.late_dropped,
                           "windows": len(win.live_wids())}
            check(win.late_dropped == 0,
                  f"windowed ({label}) dropped {win.late_dropped} rows")
            if label == "in_order":
                total = win.query_sliding(retention)
                check(fp.fingerprint_results(total)
                      == m_want["stream/results"],
                      "windowed store's sliding total != groupby_agg's")
                win.wal.close()
            del win
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wrec = WindowedStore.recover(wwal, device=dev)
        win_fps["recovered"] = wrec.fingerprints()
        torch.cuda.synchronize()
        runs["recovery_s"] = time.perf_counter() - t0
        wrec.wal.close()
        del wrec
        check(win_fps["in_order"] == win_fps["shuffled"]
              == win_fps["recovered"],
              "windowed fingerprints differ between in-order, shuffled and "
              "recovered runs")
        rec["windowed"] = {"rows": m, "reduced": f"{m} of {n} rows: the "
                           "windowed WAL logs whole rows",
                           "width_days": 30, "retention": retention,
                           "wal_bytes": os.path.getsize(wwal),
                           "fingerprints_equal": True, **runs}
        del tv, tk, td, days, order

        # -- fault injection: a crash after the WAL write and one inside
        # commit; recover after each and retry the batch with its tag
        fwal = os.path.join(tmp, "faults.wal")
        inj = faultinject.FaultInjector(
            [("store.commit", len(cuts) // 4, "crash"),
             ("wal.append.logged", len(cuts) // 2, "crash")], seed=seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fstore, retries = drive_with_faults(
            faultinject,
            lambda: StreamStore(4, Q1_AGGS, spec, wal=fwal, device=dev),
            lambda: StreamStore.recover(fwal, device=dev),
            values, keys, cuts, inj)
        fault_fp = fstore.fingerprints()
        torch.cuda.synchronize()
        faults_s = time.perf_counter() - t0
        fstore.wal.close()
        del fstore
        check(len(inj.fired) == 2, f"faults fired: {inj.fired}")
        check([d for _, d in retries] == [True, True],
              f"retries after a logged batch's crash did not answer "
              f"duplicate: {retries}")
        check(fault_fp == q1_want, "digests after injected crashes != "
              "groupby_agg's")
        rec["faults"] = {"fired": [list(f[:3]) for f in inj.fired],
                         "retries_duplicate": [d for _, d in retries],
                         "seconds": faults_s, "digests_equal": True}

        # -- StreamService in process: 4 writers, host numpy batches
        hv, hk = wv.cpu().numpy(), wk.cpu().numpy()
        serial = StreamStore(4, Q1_AGGS, spec, device=dev)
        for cut in wcuts:
            serial.ingest(hv[cut], hk[cut])
        serial_fp = serial.fingerprints()
        check(serial_fp == m_want, "serially fed store != groupby_agg")
        del serial
        writers = 4

        async def feed(service):
            async def writer(w):
                for j in range(w, len(wcuts), writers):
                    cut = wcuts[j]
                    await service.ingest(hv[cut], hk[cut], client=f"w{w}",
                                         seq=j)
            await asyncio.gather(*(writer(w) for w in range(writers)))
            dup = await service.ingest(hv[wcuts[0]], hk[wcuts[0]],
                                       client="w0", seq=0)
            return dup, await service.fingerprints()

        # in turns: pipelined, serialized, serialized, pipelined
        svc = {"pipelined": [], "serialized": []}
        for pipelined in (True, False, False, True):
            store = StreamStore(4, Q1_AGGS, spec, device=dev)
            service = StreamService(store, pipelined=pipelined)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dup, got = asyncio.run(feed(service))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            service.close()
            label = "pipelined" if pipelined else "serialized"
            check(dup.get("duplicate") is True,
                  f"service redelivery answered {dup}")
            check(got == serial_fp,
                  f"{label} service digests != the serially fed store's")
            svc[label].append(m / secs)
            del service, store
        rec["service"] = {
            "rows": m, "writers": writers,
            "prepare_workers": StreamStore(4, Q1_AGGS, spec, device=dev)
            .pipeline_width(batch_rows),
            "pipelined_rows_per_s": svc["pipelined"],
            "serialized_rows_per_s": svc["serialized"],
            "pipelined_over_serialized": sum(svc["pipelined"])
            / sum(svc["serialized"]),
            "redelivery_duplicate": True, "digests_equal": True}

        # -- failover: crash the primary, promote the follower
        rep = ReplicatedStore(4, Q1_AGGS, spec,
                              wal_path=os.path.join(tmp, "rep.wal"),
                              snapshot_dir=os.path.join(tmp, "rep_snaps"),
                              device=dev)
        for j, cut in enumerate(wcuts):
            rep.ingest(wv[cut], wk[cut], client="r", seq=j)
            if j == len(wcuts) // 2:
                rep.replicate()
        before = rep.fingerprints()
        rep.crash_primary()
        report = rep.promote()
        check(rep.fingerprints() == before == m_want,
              "promoted follower's digests != the primary's")
        check(rep.ingest(wv[wcuts[0]], wk[wcuts[0]], client="r",
                         seq=0).get("duplicate") is True,
              "the promoted store took a redelivered batch")
        rep.primary.wal.close()
        rec["failover"] = {"caught_up_records": report["caught_up_records"],
                           "seconds": report["seconds"],
                           "digests_equal": True}
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="stream", **rec)
    return {"segment_launches": seg_launches, "rsum_launches": rsum_launches,
            "batches": len(cuts)}


# ---------------------------------------------------------------------------
# phase 10: reproducible training of smollm-135m

TRAIN_ARCH = "smollm-135m"
RUN_KEYS = ("losses", "loss_trajectory", "params", "opt")


def spawn_ranks(fn, world: int, args: tuple, timeout_s: float) -> list:
    """Spawn ``world`` ranks of ``fn(rank, world, store, out, *args)``,
    joined by a ``file://`` store in a temporary directory; wait at most
    ``timeout_s``, kill any that are left, and return each rank's
    ``rank<r>.json``."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(fn, args=(world, str(Path(tmp, "store")), tmp, *args),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"{world} ranks of {fn.__name__} did not finish in "
                      f"{timeout_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        return [json.loads(Path(tmp, f"rank{r}.json").read_text())
                for r in range(world)]


def _ms(torch, dev, fn, reps: int = 5) -> float:
    """CUDA-event median on the card, host clock on the CPU (rehearsal)."""
    if dev.type == "cuda":
        return cuda_ms(torch, fn, reps=reps)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, \
        "bytes" if by_bytes >= by_ops else "operations"


def train_checks(torch, cfg, dev, seed: int, seq: int) -> dict:
    """The training path's kernels at its own shapes, in a rank process.

    * the global norm of one full-width gradient tree (one quantum's
      gradients) on the card, through the rsum kernel once per leaf, and on
      the CPU from a host copy: the norm's bytes, the launches, and the
      rsum kernel against its plain version on the card at every leaf's
      shape, timed at the largest (with ``torch.sum`` as the library call);
    * the embedding gradient's GROUPBY (G = vocab, d_model columns, one
      quantum's rows) under ``scatter``, the planner's ``auto`` and the
      segment kernel (``pallas``): table digests, times, the planner's
      pick, and the kernel against its plain version (``index_add_`` of
      the float32 rows as the library call).
    """
    from repro_torch import tree as tree_mod
    from repro_torch.core import accumulator as acc_mod
    from repro_torch.core.segment import segment_rsum
    from repro_torch.core.types import ReproSpec
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.rsum import ops as R
    from repro_torch.kernels.segment_rsum import ops as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import build_batch
    from repro_torch.launch.train_step import TrainConfig, make_train_step
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.obs.fingerprint import fingerprint_table
    from repro_torch.ops.plan import plan_groupby
    from repro_torch.optim import grad as grad_mod

    spec = ReproSpec()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    step = make_train_step(cfg, TrainConfig(grad_mode="repro"), make_mesh(),
                           ShapeConfig("train", seq, 1, "train"), device=dev)
    params = lm.init_params(seed, cfg, dev)
    mb = build_batch(DataConfig(seed=seed, global_batch=1, seq_len=seq,
                                vocab=cfg.vocab), cfg, 0, 1, 1, device=dev)
    mb = {k: v[0] for k, v in mb.items()}
    grads, _ = step.grad_fn(params, mb)
    leaves = tree_mod.leaves(grads)
    out = {"leaves": len(leaves), "elements": sum(g.numel() for g in leaves)}
    if dev.type == "cuda":
        # one quantum's forward + backward (the bulk of a baseline step),
        # and what repro_zero2 adds per quantum: tree_to_acc, the exact
        # reduce-scatter over the rank's group and the merge
        zstep = make_train_step(cfg, TrainConfig(), make_mesh(),
                                ShapeConfig("train", seq, 1, "train"),
                                device=dev)
        zero = zstep.zero_dims(params)
        shard0 = tree_mod.tree_map(zstep._scatter_one, grad_mod.tree_to_acc(
            grads, spec), zero)

        def quantum():
            step.grad_fn(params, mb)

        def accumulate():
            accs = tree_mod.tree_map(zstep._scatter_one,
                                     grad_mod.tree_to_acc(grads, spec), zero)
            grad_mod.acc_merge_tree(shard0, accs, spec)

        for label, fn in (("quantum_grad", quantum),
                          ("zero2_accumulate", accumulate)):
            wall = host_ms(torch, fn, reps=3)
            out[f"profile_{label}"] = device_profile(torch, fn, wall)
        del shard0
    del params

    R.LAUNCHES = 0
    sync()
    t0 = time.perf_counter()
    norm = grad_mod.repro_global_norm(grads, spec)
    sync()
    out["norm_card_ms"] = (time.perf_counter() - t0) * 1e3
    out["norm_rsum_launches"] = R.LAUNCHES
    host = tree_mod.tree_map(lambda g: g.cpu(), grads)
    t0 = time.perf_counter()
    on_cpu = grad_mod.repro_global_norm(host, spec)
    out["norm_cpu_s"] = time.perf_counter() - t0
    out["norm_card"] = norm.cpu().numpy().tobytes().hex()
    out["norm_cpu"] = on_cpu.numpy().tobytes().hex()
    out["norm"] = float(norm)
    del host

    # the rsum kernel against its plain version at every leaf's shape
    worst, big = 0, None
    for g in leaves:
        x = torch.square(g.to(torch.float32)).reshape(-1, 1).contiguous()
        e1 = acc_mod.required_e1(x, spec, axis=0)
        A, inv = R.ladder(e1, spec, (0, spec.L))
        if dev.type == "cuda":
            kc = R.rsum_levels_kernel(x, A, inv, spec)
            kp = R.rsum_levels_plain(x, A, inv, spec)
            for a, b in zip(kc, kp):
                worst = max(worst, int((a.long() - b.long()).abs().max()))
        if big is None or x.shape[0] > big[0].shape[0]:
            big = (x, A, inv)
    x, A, inv = big
    n = x.shape[0]
    kernel = R.rsum_levels_kernel if dev.type == "cuda" \
        else R.rsum_levels_plain
    bound, by = _bound_ms(4 * n, 6 * n * spec.L)
    out["rsum"] = {
        "n": n, "max_abs_err": worst,
        "ms": _ms(torch, dev, lambda: kernel(x, A, inv, spec), reps=10),
        "plain_ms": _ms(torch, dev, lambda: R.rsum_levels_plain(
            x, A, inv, spec), reps=3),
        "library_ms": _ms(torch, dev, lambda: x.sum(dim=0), reps=10),
        "bound_ms": bound, "bound_by": by}
    del grads, leaves, big, x

    # the embedding gradient's GROUPBY, raced
    ids = mb["tokens"].reshape(-1)
    rows, d, G = ids.shape[0], cfg.d_model, cfg.vocab
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    cot = torch.randn((rows, d), generator=gen, device=dev) * 1e-3
    cot[::7] *= 1e-20                       # magnitudes the levels must keep
    plan = plan_groupby(rows, G, spec, ncols=d, backend=dev.type)
    race = {}
    for method in ("scatter", "auto", "pallas"):
        S.LAUNCHES = 0
        acc = segment_rsum(cot, ids, G, spec, method=method, device=dev)
        sync()
        race[method] = {
            "digest": fingerprint_table(acc, spec),
            "segment_launches": S.LAUNCHES,
            "ms": _ms(torch, dev, lambda m=method: segment_rsum(
                cot, ids, G, spec, method=m, device=dev), reps=5)}
        del acc
    e1 = acc_mod.required_e1(cot, spec).expand(d).contiguous()
    A, inv = R.ladder(e1, spec, (0, spec.L))
    skernel = S.segment_levels_kernel if dev.type == "cuda" \
        else S.segment_levels_plain
    kc = skernel(cot, ids, G, A, inv, spec)
    kp = S.segment_levels_plain(cot, ids, G, A, inv, spec)
    serr = max(int((a.long() - b.long()).abs().max()) for a, b in zip(kc, kp))
    del kc, kp
    table = torch.zeros((G, d), device=dev)
    lids = ids.to(torch.int64)
    bound, by = _bound_ms(4 * rows + 4 * rows * d + 2 * 4 * G * d * spec.L,
                          5 * rows * d * spec.L)
    out["embed"] = {
        "rows": rows, "G": G, "ncols": d, "planner": plan.method,
        "race": race, "max_abs_err": serr,
        "path": S.launch_shape(rows, G, d, spec.L, 132).path,
        "ms": _ms(torch, dev, lambda: skernel(cot, ids, G, A, inv, spec)),
        "plain_ms": _ms(torch, dev, lambda: S.segment_levels_plain(
            cot, ids, G, A, inv, spec), reps=3),
        "library_ms": _ms(torch, dev, lambda: table.index_add_(0, lids,
                                                               cot)),
        "bound_ms": bound, "bound_by": by}
    return out


def train_rank(rank: int, world: int, store: str, out: str, backend: str,
               plan: dict) -> None:
    """One rank of the training phase: join ``backend``, run ``plan``'s
    jobs in order through ``repro_torch.launch.train.train_loop`` (fresh
    weights from the seed each time), and write per job the losses (as
    float hex), the run's fingerprints, the step times, the kernels'
    launches and the peak card memory; with ``plan["checks"]``, rank 0 adds
    :func:`train_checks`."""
    import dataclasses
    import datetime
    import os
    import tempfile

    # one cuBLAS workspace setting for every mode of the process (the repro
    # modes need it fixed before cuBLAS first sets up)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels.rsum import ops as R
    from repro_torch.kernels.segment_rsum import ops as S
    from repro_torch.launch.train import train_loop
    from repro_torch.launch.train_step import TrainConfig
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import AdamWConfig

    dev = torch.device(plan["device"], 0) if plan["device"] == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=240),
        device_id=dev if backend == "nccl" else None)
    recs = {}
    try:
        for job in plan["jobs"]:
            cfg = configs.get_config(job.get("arch", plan["arch"]))
            if plan["reduced"]:
                cfg = cfg.reduced()
            jcfg = cfg if job.get("n_layers") is None else \
                dataclasses.replace(cfg, n_layers=job["n_layers"])
            shape = ShapeConfig("train", job["seq"], job["batch"], "train")
            tc = TrainConfig(grad_mode=job["mode"], mb_size=1,
                             repro_embed=job.get("repro_embed", False),
                             adamw=AdamWConfig(lr=1e-3, warmup_steps=1,
                                               total_steps=job["steps"]))
            fail_at = job.get("fail_at")
            with tempfile.TemporaryDirectory() as ckdir:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                R.LAUNCHES = S.LAUNCHES = 0
                t0 = time.perf_counter()
                res = train_loop(jcfg, shape, tc, steps=job["steps"],
                                 seed=plan["seed"], log_every=10 ** 9,
                                 device=dev,
                                 ckpt_dir=ckdir if fail_at is not None
                                 else None,
                                 ckpt_every=job.get("ckpt_every", 50),
                                 resume=fail_at is not None, fail_at=fail_at)
                secs = time.perf_counter() - t0
                launches = (R.LAUNCHES, S.LAUNCHES)
            recs[job["label"]] = {
                "losses": [float(l).hex() for _, l in res.losses],
                "loss_values": [l for _, l in res.losses],
                **res.fingerprints, "step_s": res.step_seconds,
                "restarts": res.restarts, "seconds": secs,
                "steps_run": len(res.step_seconds),
                "rsum_launches": launches[0],
                "segment_launches": launches[1],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else None}
        if plan["checks"] and rank == 0:
            cfg = configs.get_config(plan["arch"])
            if plan["reduced"]:
                cfg = cfg.reduced()
            recs["checks"] = train_checks(torch, cfg, dev, plan["seed"],
                                          plan["jobs"][0]["seq"])
    finally:
        dist.destroy_process_group()
    Path(out, f"rank{rank}.json").write_text(json.dumps(recs))


def _step_ms(rec: dict) -> float:
    """Median host-clock ms of a run's steps after its first (warm-up)."""
    s = rec["step_s"][1:] or rec["step_s"]
    return statistics.median(s) * 1e3


def train_phase(name: str, limit: str, seed: int, device: str = "cuda",
                arch: str = TRAIN_ARCH, reduced: bool = False,
                seq: int = 1024, small_seq: int = 256,
                steps: int = 3) -> dict:
    """Phase 10: the port's reproducible training of ``arch`` at full
    width.  One rank over NCCL (gloo when rehearsing on the CPU) at full
    depth: ``baseline``, ``repro_zero2``, ``repro``, a rerun, a restart
    from an injected failure at step 2, and one ``repro_embed`` step; then
    2 layers at 1 and 2 ranks (gloo with card tensors).  Returns the
    numbers the kernels line carries."""
    t_phase = time.perf_counter()
    full = dict(seq=seq, batch=8, steps=steps)
    small = dict(label="depth2", mode="repro_zero2", n_layers=2,
                 seq=small_seq, batch=8, steps=2)
    jobs = [dict(label="baseline", mode="baseline", **full),
            dict(label="repro_zero2", mode="repro_zero2", **full),
            dict(label="repro", mode="repro", **full),
            dict(label="repro_zero2_rerun", mode="repro_zero2", **full),
            dict(label="repro_zero2_restart", mode="repro_zero2", fail_at=2,
                 ckpt_every=2, **full),
            dict(label="repro_embed", mode="repro_zero2", repro_embed=True,
                 seq=seq, batch=8, steps=1),
            small]
    plan = {"arch": arch, "reduced": reduced, "device": device,
            "seed": seed, "jobs": jobs, "checks": True}
    backend = "nccl" if device == "cuda" else "gloo"
    one = spawn_ranks(train_rank, 1, (backend, plan), 900.0)[0]
    z2 = one["repro_zero2"]
    for label in ("repro", "repro_zero2_rerun", "repro_zero2_restart"):
        for key in RUN_KEYS:
            check(one[label][key] == z2[key],
                  f"train: {label}'s {key} != repro_zero2's")
    check(one["repro_zero2_restart"]["restarts"] == 1,
          "train: the injected failure did not restart the run")
    for label, rec in one.items():
        if label != "checks":
            check(all(math.isfinite(v) for v in rec["loss_values"]),
                  f"train: {label} has a loss that is not finite")
    check(device != "cuda" or z2["rsum_launches"] > 0,
          "train: repro_zero2 did not launch the rsum kernel")
    c = one["checks"]
    check(device != "cuda" or c["norm_rsum_launches"] == c["leaves"],
          f"train: the global norm launched rsum {c['norm_rsum_launches']} "
          f"times for {c['leaves']} leaves")
    check(c["norm_card"] == c["norm_cpu"],
          "train: the global norm's bits differ between the card and the CPU")
    check(c["rsum"]["max_abs_err"] == 0 and c["embed"]["max_abs_err"] == 0,
          "train: a kernel differs from its plain version at the training "
          "shapes")
    race = c["embed"]["race"]
    check(race["auto"]["digest"] == race["scatter"]["digest"]
          == race["pallas"]["digest"],
          "train: the embedding GROUPBY differs between scatter, auto and "
          "pallas")
    check(device != "cuda" or race["pallas"]["segment_launches"] > 0,
          "train: method='pallas' did not launch the segment kernel")

    t_multi = time.perf_counter()
    multi = {}
    for world in (2,):
        recs = spawn_ranks(train_rank, world, (
            "gloo", {**plan, "jobs": [small], "checks": False}),
            max(10.0, 300.0 - (time.perf_counter() - t_multi)))
        for r, rec in enumerate(recs):
            for key in RUN_KEYS:
                check(rec["depth2"][key] == one["depth2"][key],
                      f"train: 2 layers at {world} ranks (rank {r}): {key} "
                      "!= one rank's")
        multi[str(world)] = {"ms_per_step": _step_ms(recs[0]["depth2"]),
                             "seconds": recs[0]["depth2"]["seconds"]}
    multi_s = time.perf_counter() - t_multi
    check(multi_s < 300.0, f"train: 2 gloo ranks took {multi_s} s")

    modes = {label: {"ms_per_step": _step_ms(one[label]),
                     "step_s": one[label]["step_s"],
                     "peak_mem_gb": one[label]["peak_mem_gb"],
                     "rsum_launches_per_step":
                     one[label]["rsum_launches"] / one[label]["steps_run"],
                     "segment_launches_per_step":
                     one[label]["segment_launches"] / one[label]["steps_run"]}
             for label in ("baseline", "repro_zero2", "repro",
                           "repro_embed", "depth2")}
    rec = {"arch": arch, "reduced": reduced, "seq": seq, "global_batch": 8,
           "mb_size": 1, "steps": steps,
           "losses": z2["loss_values"], "params_digest": z2["params"],
           "repro_equals_repro_zero2": True, "rerun_equal": True,
           "restart_equal": True, "modes": modes,
           "repro_zero2_over_baseline": modes["repro_zero2"]["ms_per_step"]
           / modes["baseline"]["ms_per_step"],
           "repro_over_baseline": modes["repro"]["ms_per_step"]
           / modes["baseline"]["ms_per_step"],
           "baseline_losses": one["baseline"]["loss_values"],
           "depth2": {"seq": small_seq, "steps": 2, "ranks_equal": True,
                      "one_rank_ms_per_step": modes["depth2"]["ms_per_step"],
                      "gloo": multi, "gloo_seconds": multi_s},
           "global_norm": {k: c[k] for k in (
               "norm", "leaves", "elements", "norm_rsum_launches",
               "norm_card_ms", "norm_cpu_s")},
           "embed_grad": {k: v for k, v in c["embed"].items()
                          if k != "race"},
           "embed_race": {m: {"ms": v["ms"],
                              "segment_launches": v["segment_launches"]}
                          for m, v in race.items()},
           "rsum_at_largest_leaf": c["rsum"],
           "profiles": {k[len("profile_"):]: v for k, v in c.items()
                        if k.startswith("profile_")},
           "seconds": time.perf_counter() - t_phase}
    emit(phase="train", card=name, power_limit=limit, **rec)
    return rec


# ---------------------------------------------------------------------------
# phases 11-12: the MoE, hybrid and xLSTM families served and trained

FAMILY_ARCHS = ("granite-moe-3b-a800m", "hymba-1.5b", "xlstm-350m")
# prompt lengths: hymba's decode wraps its 1,024-slot sliding window
SERVE_PROMPT = {"granite-moe-3b-a800m": 512, "hymba-1.5b": 1024,
                "xlstm-350m": 512}
SERVE_BATCH, SERVE_GEN = 8, 32
# teacher forcing: the last decode step's logits against a prefill of the
# prompt and the generated tokens, max |difference| over max |logit|
TEACHER_RTOL = 2e-2
# phase 12's cuts: layers (granite and hymba 2, xlstm 2 units of 2 blocks)
# and sequence length
TRAIN_FAMILY_LAYERS = {"granite-moe-3b-a800m": 2, "hymba-1.5b": 2,
                       "xlstm-350m": 4}
TRAIN_FAMILY_SEQ = {"granite-moe-3b-a800m": 256, "hymba-1.5b": 256,
                    "xlstm-350m": 128}


def serve_model(torch, np, dev, arch: str, seed: int, reduced: bool = False,
                prompt_len: int = 0, gen_steps: int = SERVE_GEN) -> dict:
    """One model of phase 11 through ``repro_torch.launch.serve``: random
    weights drawn on the card from ``seed``, prompts from ``seed``; two
    generates (same tokens, logits with the same bytes), the token counter,
    teacher forcing, and one decode step's launches and device idle
    share."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.obs import metrics

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = configs.get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    PL, B = prompt_len or SERVE_PROMPT[arch], SERVE_BATCH
    max_seq = PL + gen_steps
    sync()
    # card memory is counted above what the process held before the model
    # (the tensors of earlier phases)
    base = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg, dev)
    sync()
    rec = {"arch": arch, "params": lm.param_count(params),
           "init_s": time.perf_counter() - t0, "batch": B,
           "prompt_len": PL, "gen_steps": gen_steps}
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, PL)).astype(np.int32)).to(dev)
    tokens_total = metrics.counter("serve_tokens_total")
    if on_card:
        rec["weights_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
        torch.cuda.reset_peak_memory_stats()
    before = tokens_total.value
    toks, st1, logits = serve.generate_with_stats(
        params, cfg, prompts, max_seq, gen_steps, return_logits=True)
    if on_card:
        rec["peak_mem_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(tokens_total.value - before == B * gen_steps,
          f"serve {arch}: serve_tokens_total grew by "
          f"{tokens_total.value - before}, not {B * gen_steps}")
    check(toks.shape == (B, gen_steps) and bool(torch.isfinite(logits).all())
          and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab,
          f"serve {arch}: tokens or logits out of range")
    toks2, st2, logits2 = serve.generate_with_stats(
        params, cfg, prompts, max_seq, gen_steps, return_logits=True)
    check(torch.equal(toks, toks2) and logits.cpu().numpy().tobytes()
          == logits2.cpu().numpy().tobytes(),
          f"serve {arch}: a second generate differs")
    rec.update(ttft_cold_ms=st1["ttft_s"] * 1e3,
               ttft_ms=st2["ttft_s"] * 1e3,
               decode_tok_per_s=st2["decode_tok_per_s"],
               decode_tok_per_s_cold=st1["decode_tok_per_s"],
               decode_ms_per_step=st2["decode_s"] * 1e3 / (gen_steps - 1),
               tokens=toks[0, :8].tolist(), rerun_equal=True)
    del logits2

    # teacher forcing: the last decode step's logits against a prefill of
    # the prompt and the generated tokens.  As served (bfloat16, the
    # config's capacity), reported: granite's top-8-of-40 routing flips
    # where a bfloat16 rounding moves a router logit across the 8th/9th
    # boundary (an expert flipped at one layer moves everything above it),
    # and a prefill's group of the whole sequence drops what overflows its
    # capacity while a decode step's group of one token never drops.
    # Checked in float32 compute (the same weights), the MoE at capacity
    # factor E / K
    def teacher(cfg_tf, toks_tf, logits_tf):
        full = torch.cat([prompts, toks_tf[:, :-1]], dim=1)
        with torch.inference_mode():
            lg, caches = lm.prefill_step(params, {"tokens": full}, cfg_tf,
                                         max_seq)
        err = float((lg[:, -1] - logits_tf[:, -1]).abs().max())
        scale = float(logits_tf[:, -1].abs().max())
        return {"max_abs_err": err, "max_abs_logit": scale,
                "rel_err": err / scale, "argmax_equal": bool(torch.equal(
                    lg[:, -1].argmax(-1), logits_tf[:, -1].argmax(-1)))}, \
            caches

    rec["teacher_forcing_served"], caches = teacher(cfg, toks, logits)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    if cfg.moe is not None:
        f32 = dataclasses.replace(f32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    toks32, _, logits32 = serve.generate_with_stats(
        params, f32, prompts, max_seq, gen_steps, return_logits=True)
    tf, _ = teacher(f32, toks32, logits32)
    rec["teacher_forcing"] = {**tf, "rtol": TEACHER_RTOL,
                              "compute_dtype": "float32",
                              "capacity_factor": f32.moe.capacity_factor
                              if f32.moe is not None else None}
    check(tf["max_abs_err"] <= TEACHER_RTOL * tf["max_abs_logit"],
          f"serve {arch}: the last decode step's logits differ from the "
          f"prefill's by {tf['max_abs_err']} (logits up to "
          f"{tf['max_abs_logit']})")
    del logits, logits32

    # one decode step (after the prompt and the generated tokens)
    step_batch = {"tokens": toks[:, -1:], "positions": torch.full(
        (B, 1), max_seq - 1, dtype=torch.int32, device=dev)}

    def decode_once():
        with torch.inference_mode():
            lm.decode_step(params, caches, step_batch, cfg)

    if on_card:
        wall = host_ms(torch, decode_once, reps=5)
        prof = device_profile(torch, decode_once, wall)
        rec["decode_step"] = {
            "wall_ms": wall, "device_busy_ms": prof["device_busy_ms"],
            "kernel_launches": prof["kernel_launches"],
            "device_idle_share": prof["device_idle_share"],
            "top_kernel_device_ms": prof["top_kernel_device_ms"]}
    else:
        decode_once()
    del params, caches
    if on_card:
        torch.cuda.empty_cache()
    return rec


def serve_phase(name: str, limit: str, seed: int, device: str = "cuda",
                reduced: bool = False, prompt_len: int = 0,
                gen_steps: int = SERVE_GEN) -> dict:
    """Phase 11: granite-moe-3b-a800m, hymba-1.5b and xlstm-350m at full
    width and depth, served by ``repro_torch.launch.serve`` (batch 8,
    32 greedy steps; prompts of 512 tokens, 1,024 for hymba)."""
    import numpy as np
    import torch

    from repro_torch.kernels.rsum import ops as R
    from repro_torch.kernels.segment_rsum import ops as S

    dev = torch.device(device)
    t0 = time.perf_counter()
    R.LAUNCHES = S.LAUNCHES = 0
    models = {arch: serve_model(torch, np, dev, arch, seed, reduced,
                                prompt_len, gen_steps)
              for arch in FAMILY_ARCHS}
    rec = {"models": models,
           "kernel_launches": {"rsum": R.LAUNCHES, "segment_rsum":
                               S.LAUNCHES},
           "seconds": time.perf_counter() - t0}
    emit(phase="serve", card=name, power_limit=limit, **rec)
    return rec


def train_families_phase(name: str, limit: str, seed: int,
                         device: str = "cuda", reduced: bool = False,
                         seq: int = 0) -> dict:
    """Phase 12: the same three configurations at full width, cut to 2
    units, trained through ``repro_torch.launch.train`` in one NCCL rank
    (gloo when rehearsing on the CPU): ``baseline``, ``repro_zero2``,
    ``repro`` and a rerun (global batch 4 in quanta of one sequence, 2
    steps); granite also in ``repro`` at 2 gloo ranks.  ``repro`` =
    ``repro_zero2`` = rerun = 2 ranks, and the rsum kernel launches once
    per gradient leaf per step."""
    from repro_torch import configs
    from repro_torch import tree as tree_mod
    from repro_torch.models import lm

    t0 = time.perf_counter()
    jobs = []
    for arch in FAMILY_ARCHS:
        shape = dict(arch=arch, n_layers=TRAIN_FAMILY_LAYERS[arch],
                     seq=seq or TRAIN_FAMILY_SEQ[arch], batch=4, steps=2)
        jobs += [dict(label=f"{arch}/{mode}", mode=mode, **shape)
                 for mode in ("baseline", "repro_zero2", "repro")]
        jobs.append(dict(label=f"{arch}/rerun", mode="repro_zero2", **shape))
    plan = {"arch": FAMILY_ARCHS[0], "reduced": reduced, "device": device,
            "seed": seed, "jobs": jobs, "checks": False}
    backend = "nccl" if device == "cuda" else "gloo"
    one = spawn_ranks(train_rank, 1, (backend, plan), 600.0)[0]
    granite = [j for j in jobs if j["label"] == f"{FAMILY_ARCHS[0]}/repro"]
    t_two = time.perf_counter()
    two = spawn_ranks(train_rank, 2, (
        "gloo", {**plan, "jobs": granite}), 300.0)
    two_s = time.perf_counter() - t_two
    models = {}
    for arch in FAMILY_ARCHS:
        cfg = configs.get_config(arch).reduced()     # same tree, small
        leaves = len(tree_mod.leaves(lm.init_params(0, cfg, "cpu")))
        z2 = one[f"{arch}/repro_zero2"]
        for label in ("repro", "rerun"):
            for key in RUN_KEYS:
                check(one[f"{arch}/{label}"][key] == z2[key],
                      f"train_families {arch}: {label}'s {key} != "
                      "repro_zero2's")
        for label in ("baseline", "repro_zero2", "repro", "rerun"):
            check(all(math.isfinite(v) for v in
                      one[f"{arch}/{label}"]["loss_values"]),
                  f"train_families {arch}: {label} has a loss that is not "
                  "finite")
            rs = one[f"{arch}/{label}"]["rsum_launches"] / 2
            check(device != "cuda" or label == "baseline" or rs == leaves,
                  f"train_families {arch}: {label} launched rsum {rs} "
                  f"times per step for {leaves} gradient leaves")
        modes = {label: {
            "ms_per_step": _step_ms(one[f"{arch}/{label}"]),
            "step_s": one[f"{arch}/{label}"]["step_s"],
            "peak_mem_gb": one[f"{arch}/{label}"]["peak_mem_gb"],
            "rsum_launches_per_step":
            one[f"{arch}/{label}"]["rsum_launches"] / 2}
            for label in ("baseline", "repro_zero2", "repro")}
        models[arch] = {
            "layers": TRAIN_FAMILY_LAYERS[arch],
            "seq": seq or TRAIN_FAMILY_SEQ[arch], "leaves": leaves,
            "losses": z2["loss_values"], "params_digest": z2["params"],
            "modes": modes, "repro_equals_repro_zero2": True,
            "rerun_equal": True,
            "repro_zero2_over_baseline": modes["repro_zero2"]["ms_per_step"]
            / modes["baseline"]["ms_per_step"]}
    for r, rec in enumerate(two):
        for key in RUN_KEYS:
            check(rec[f"{FAMILY_ARCHS[0]}/repro"][key]
                  == one[f"{FAMILY_ARCHS[0]}/repro"][key],
                  f"train_families: granite at 2 gloo ranks (rank {r}): "
                  f"{key} != one rank's")
    models[FAMILY_ARCHS[0]]["gloo2"] = {
        "ranks_equal": True, "seconds": two_s,
        "ms_per_step": _step_ms(two[0][f"{FAMILY_ARCHS[0]}/repro"])}
    rec = {"models": models, "global_batch": 4, "mb_size": 1, "steps": 2,
           "seconds": time.perf_counter() - t0}
    emit(phase="train_families", card=name, power_limit=limit, **rec)
    return rec


def run(args) -> dict:
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import accumulator as acc
    from repro_torch.core import prescan
    from repro_torch.core.types import ReproSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels.rsum import ops as R
    from repro_torch.kernels.segment_rsum import ops as S
    from repro_torch.obs import trace
    from repro_torch.obs.fingerprint import (fingerprint_results,
                                             fingerprint_table)
    from repro_torch.ops import calibrate as cal_mod
    from repro_torch.ops import groupby_agg
    from repro_torch.ops.partial import AggSignature, _build_columns
    from repro_torch.ops.plan import plan_groupby

    dev = torch.device("cuda")
    card = card_line()
    name, limit = (s.strip() for s in card.split(",", 1))
    print(card, flush=True)
    emit(phase="environment", python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), power_limit=limit)

    build_s = _build.build_all()
    emit(phase="build", seconds=round(build_s, 3),
         kernels=sorted(_build.KERNEL_SOURCES))
    emit(phase="ptxas", functions={
        name: [[r["function"], r.get("registers"), r.get("spill_stores"),
                r.get("spill_loads")] for r in _build.ptxas_report(name)]
        for name in sorted(_build.KERNEL_SOURCES)})

    max_err = kernel_cases(torch, np, dev, R, S, acc, prescan, ReproSpec)

    spec = ReproSpec()
    values, keys = q1_table(torch, dev, SF10_LINEITEM, args.seed)
    n = values.shape[0]
    trace.configure()                     # in-memory: read the plan back

    # -- Q1 through the segment kernel (method="auto") --------------------
    S.LAUNCHES, R.LAUNCHES = 0, 0
    t0 = time.perf_counter()
    q1, q1_tab = groupby_agg(values, keys, 4, Q1_AGGS, spec,
                             return_table=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    seg_launches = S.LAUNCHES
    check(planned_method(trace) == "pallas",
          f"planner chose {planned_method(trace)} for Q1, not the kernel")
    check(seg_launches > 0, "Q1 did not launch the segment kernel")
    check(all(bool(torch.isfinite(v).all()) and v.shape == (4,)
              for v in q1.values()), "Q1 results not finite (4,)")
    counts = torch.bincount(keys, minlength=4).to(torch.float32)
    check(torch.equal(q1["count(*)"], counts), "count(*) != bincount")
    digest = fingerprint_results(q1)
    tdigest = fingerprint_table(q1_tab, spec)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    perm = torch.randperm(n, generator=gen, device=dev)
    q1p, q1p_tab = groupby_agg(values[perm], keys[perm], 4, Q1_AGGS, spec,
                               return_table=True)
    check(fingerprint_results(q1p) == digest
          and fingerprint_table(q1p_tab, spec) == tdigest,
          "Q1 digests differ under a row permutation")
    q1s, q1s_tab = groupby_agg(values, keys, 4, Q1_AGGS, spec,
                               method="scatter", return_table=True)
    check(fingerprint_results(q1s) == digest
          and fingerprint_table(q1s_tab, spec) == tdigest,
          "Q1 digests differ between the kernel and the scatter strategy")
    emit(phase="q1_sf10", n=n, G=4, method="pallas",
         segment_launches=seg_launches, first_call_s=round(first_s, 3),
         results_digest=digest, table_digest=tdigest,
         permuted_equal=True, scatter_equal=True,
         results={k: v.cpu().tolist() for k, v in q1.items()})

    # -- the same table without GROUP BY, through the rsum kernel ---------
    zeros = torch.zeros_like(keys)
    S.LAUNCHES, R.LAUNCHES = 0, 0
    flat, flat_tab = groupby_agg(values, zeros, 1, FLAT_AGGS, spec,
                                 return_table=True)
    torch.cuda.synchronize()
    rsum_launches = R.LAUNCHES
    check(planned_method(trace) == "rsum",
          f"planner chose {planned_method(trace)} for G=1, not rsum")
    check(rsum_launches > 0, "the G=1 query did not launch the rsum kernel")
    fdigest = fingerprint_results(flat)
    for method in ("pallas", "scatter"):
        other = groupby_agg(values[perm], zeros, 1, FLAT_AGGS, spec,
                            method=method)
        check(fingerprint_results(other) == fdigest,
              f"G=1 digests differ between rsum and {method} (permuted)")
    emit(phase="flat_sf10", n=n, G=1, method="rsum",
         rsum_launches=rsum_launches, results_digest=fdigest,
         pallas_equal=True, scatter_equal=True)

    # -- Q18's inner GROUP BY l_orderkey at SF10 --------------------------
    qv, qk = q18_table(torch, dev, SF10_ORDERS, args.seed + 2)
    torch.cuda.reset_peak_memory_stats()
    q18, q18_tab = groupby_agg(qv, qk, SF10_ORDERS, [("sum", 0)], spec,
                               return_table=True)
    torch.cuda.synchronize()
    q18_method = planned_method(trace)
    q18_digest = fingerprint_results(q18)
    q18_tdigest = fingerprint_table(q18_tab, spec)
    table_mb = sum(t.numel() * t.element_size() for t in q18_tab) / 1e6
    gen.manual_seed(args.seed + 3)
    perm18 = torch.randperm(qk.shape[0], generator=gen, device=dev)
    q18p, q18p_tab = groupby_agg(qv[perm18], qk[perm18], SF10_ORDERS,
                                 [("sum", 0)], spec, return_table=True)
    check(fingerprint_results(q18p) == q18_digest
          and fingerprint_table(q18p_tab, spec) == q18_tdigest,
          "Q18 digests differ under a row permutation")
    q18k, q18k_tab = groupby_agg(qv, qk, SF10_ORDERS, [("sum", 0)], spec,
                                 method="pallas", return_table=True)
    check(fingerprint_results(q18k) == q18_digest
          and fingerprint_table(q18k_tab, spec) == q18_tdigest,
          f"Q18 digests differ between {q18_method} and the kernel")
    exact = torch.zeros(SF10_ORDERS, dtype=torch.int64, device=dev) \
        .index_add_(0, qk.to(torch.int64), qv[:, 0].to(torch.int64))
    check(torch.equal(q18["sum(0)"], exact.to(torch.float32)),
          "Q18 sums differ from the exact integer sums")
    emit(phase="q18_sf10", n=int(qk.shape[0]), G=SF10_ORDERS,
         method=q18_method, table_mb=round(table_mb, 1),
         peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2),
         results_digest=q18_digest, table_digest=q18_tdigest,
         permuted_equal=True, kernel_equal=True)
    del q18p, q18p_tab, q18k, q18k_tab, perm18, exact

    # -- a 2^20-row subset: the CPU and the card give the same bytes ------
    sub = slice(0, 1 << 20)
    on_card = groupby_agg(values[sub], keys[sub], 4, Q1_AGGS, spec)
    on_cpu = groupby_agg(values[sub].cpu(), keys[sub].cpu(), 4, Q1_AGGS,
                         spec, device="cpu")
    check(same_results(on_card, on_cpu), "CPU and card results differ")
    emit(phase="cpu_vs_card", n=1 << 20, equal=True,
         results_digest=fingerprint_results(on_cpu))
    trace.disable()

    # -- phase 5: times ---------------------------------------------------
    sig = AggSignature.build(Q1_AGGS, 4, spec)
    X = _build_columns(values, sig.compiled[1], spec)
    e1 = acc.required_e1(X, spec, axis=0)
    lv = (0, spec.L)
    A, iu = R.ladder(e1, spec, lv)
    got = S.segment_levels_kernel(X, keys, 4, A, iu, spec)
    want = S.segment_levels_plain(X, keys, 4, A, iu, spec)
    seg_err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(got, want))
    check(seg_err == 0, "segment kernel != plain at the Q1 shape")
    XF = _build_columns(values, AggSignature.build(FLAT_AGGS, 1, spec)
                        .compiled[1], spec)
    e1f = acc.required_e1(XF, spec, axis=0)
    Af, iuf = R.ladder(e1f, spec, lv)
    gotf = R.rsum_levels_kernel(XF, Af, iuf, spec)
    wantf = R.rsum_levels_plain(XF, Af, iuf, spec)
    rsum_err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   for a, b in zip(gotf, wantf))
    check(rsum_err == 0, "rsum kernel != plain at the G=1 shape")

    keys64 = keys.to(torch.int64)

    def yardstick():
        return torch.zeros((4, X.shape[1]), dtype=torch.float32,
                           device=dev).index_add_(0, keys64, X)

    def seg_kernel():
        return S.segment_levels_kernel(X, keys, 4, A, iu, spec)

    def rsum_kernel():
        return R.rsum_levels_kernel(XF, Af, iuf, spec)

    def flat_library():
        return XF.sum(dim=0)

    # ms: device time per launch (10 launches per window); call_ms: one
    # call per window, the wrapper's host work included
    seg_ms = cuda_ms(torch, seg_kernel, reps=10, batch=10)
    seg_call_ms = cuda_ms(torch, seg_kernel, reps=20)
    seg_plain_ms = cuda_ms(torch, lambda: S.segment_levels_plain(
        X, keys, 4, A, iu, spec), reps=3)
    yard_ms = cuda_ms(torch, yardstick)
    rsum_ms, flat_lib_ms = paired_ms(torch, rsum_kernel, flat_library, 10)
    rsum_call_ms, flat_lib_call_ms = paired_ms(torch, rsum_kernel,
                                               flat_library, 1)
    rsum_plain_ms = cuda_ms(torch, lambda: R.rsum_levels_plain(
        XF, Af, iuf, spec), reps=3)
    # the tiled path at Q18's 15,000,000 groups (not the planner's choice)
    e1q = acc.required_e1(qv, spec, axis=0)
    Aq, iuq = R.ladder(e1q, spec, lv)
    q18_path = S.launch_shape(qv.shape[0], SF10_ORDERS, 1, Aq.shape[0],
                              132).path
    seg_q18_ms = cuda_ms(torch, lambda: S.segment_levels_kernel(
        qv, qk, SF10_ORDERS, Aq, iuq, spec), reps=3)
    seg_q18_bytes = 8 * qv.shape[0] + 8 * SF10_ORDERS * Aq.shape[0]
    # the tiled path in one group tile at Q9's GROUP BY nation, o_year
    # (175 groups) over SF10's green rows: in lineitem order, and sorted by
    # group (a clustered input: whole warps on one group)
    q9_groups = Q9_NATIONS * len(Q9_YEAR_DAYS)
    q9_x, q9_keys = q9_table(torch, dev, SF10_ORDERS, args.seed + 4)
    n9 = q9_x.shape[0]
    q9_order = torch.sort(q9_keys, stable=True).indices
    q9_sx, q9_skeys = q9_x[q9_order].contiguous(), q9_keys[q9_order]
    e19 = acc.required_e1(q9_x, spec, axis=0)
    A9, iu9 = R.ladder(e19, spec, lv)
    q9_path = S.launch_shape(n9, q9_groups, 1, A9.shape[0], 132).path
    for xs, ks in ((q9_x, q9_keys), (q9_sx, q9_skeys)):
        got9 = S.segment_levels_kernel(xs, ks, q9_groups, A9, iu9, spec)
        want9 = S.segment_levels_plain(xs, ks, q9_groups, A9, iu9, spec)
        check(all(torch.equal(a, b) for a, b in zip(got9, want9)),
              "segment kernel != plain at the Q9 shape")
    seg_q9_ms = cuda_ms(torch, lambda: S.segment_levels_kernel(
        q9_x, q9_keys, q9_groups, A9, iu9, spec), reps=10, batch=10)
    seg_q9_sorted_ms = cuda_ms(torch, lambda: S.segment_levels_kernel(
        q9_sx, q9_skeys, q9_groups, A9, iu9, spec), reps=10, batch=10)
    seg_q9_bytes = 8 * n9 + 8 * q9_groups * A9.shape[0]
    del q9_x, q9_keys, q9_sx, q9_skeys, q9_order, got9, want9
    e2e_ms = host_ms(torch, lambda: groupby_agg(values, keys, 4, Q1_AGGS,
                                                spec))
    e2e_flat_ms = host_ms(torch, lambda: groupby_agg(values, zeros, 1,
                                                     FLAT_AGGS, spec))
    e2e_q18_ms = host_ms(torch, lambda: groupby_agg(
        qv, qk, SF10_ORDERS, [("sum", 0)], spec), reps=2)
    profile_q1(torch, lambda: groupby_agg(values, keys, 4, Q1_AGGS, spec),
               e2e_ms, name, limit)
    nlev = A.shape[0]
    seg_bytes = 4 * n + X.numel() * 4
    rsum_bytes = XF.numel() * 4
    seg_ops = 5 * X.numel() * nlev
    rsum_ops = 6 * XF.numel() * nlev
    seg_bound = max(seg_bytes / HBM_BYTES_PER_S, seg_ops / F32_OPS_PER_S)
    rsum_bound = max(rsum_bytes / HBM_BYTES_PER_S,
                     rsum_ops / F32_OPS_PER_S)
    emit(phase="times", card=name, power_limit=limit, n=n,
         segment_kernel_ms=seg_ms, segment_kernel_call_ms=seg_call_ms,
         segment_plain_ms=seg_plain_ms,
         yardstick_index_add_f32_ms=yard_ms,
         kernel_slowdown_vs_yardstick=seg_ms / yard_ms,
         rsum_kernel_ms=rsum_ms, rsum_kernel_call_ms=rsum_call_ms,
         rsum_plain_ms=rsum_plain_ms, flat_sum_f32_ms=flat_lib_ms,
         flat_sum_f32_call_ms=flat_lib_call_ms,
         segment_q18_path=q18_path, segment_q18_kernel_ms=seg_q18_ms,
         segment_q18_bound_ms=seg_q18_bytes / HBM_BYTES_PER_S * 1e3,
         segment_q9_path=q9_path, segment_q9_rows=n9,
         segment_q9_kernel_ms=seg_q9_ms,
         segment_q9_sorted_kernel_ms=seg_q9_sorted_ms,
         segment_q9_bound_ms=seg_q9_bytes / HBM_BYTES_PER_S * 1e3,
         groupby_agg_q1_ms=e2e_ms,
         e2e_slowdown_vs_yardstick=e2e_ms / yard_ms,
         groupby_agg_flat_ms=e2e_flat_ms, groupby_agg_q18_ms=e2e_q18_ms,
         q1_rows_per_s=n / (e2e_ms / 1e3))
    # -- phase 6: calibration on the card ---------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cal = cal_mod.calibrate(spec, backend="cuda",
                                path=str(Path(tmp, "calibration.json")))
        cal_s = time.perf_counter() - t0
    emit(phase="calibration", card=name, power_limit=limit, seconds=cal_s,
         points=[[p["method"], p["n"], p["G"], p["ncols"], p["ns_per_row"]]
                 for p in cal.points])
    emit(phase="cold_start_constants", card=name, power_limit=limit,
         **cal_mod.fit_cold_model(cal, spec))
    plans = {}
    for label, (rows, g, ncols) in {
            "q1": (n, 4, X.shape[1]), "flat": (n, 1, XF.shape[1]),
            "q18": (int(qk.shape[0]), SF10_ORDERS, 1),
            "q9": (n9, q9_groups, 1)}.items():
        cold = plan_groupby(rows, g, spec, ncols=ncols, backend="cuda",
                            calibration=None)
        meas = plan_groupby(rows, g, spec, ncols=ncols, backend="cuda",
                            calibration=cal)
        plans[label] = {"n": rows, "G": g, "ncols": ncols,
                        "without_cache": [cold.method, cold.source,
                                          cold.cost],
                        "with_cache": [meas.method, meas.source, meas.cost]}
    q1_plan = plan_groupby(n, 4, spec, ncols=X.shape[1], backend="cuda",
                           calibration=cal)
    check(q1_plan.source == "measured",
          f"the cache did not decide Q1's plan ({q1_plan.source})")
    # every strategy the measured race priced at Q1 keeps the bits, so a
    # plan change moves only the time
    priced = [m for m in ("onehot", "scatter", "sort", "pallas")
              if cal_mod.fitted_cost(cal, m, n, 4, X.shape[1], spec,
                                     backend="cuda") is not None]
    for m in priced:
        q1m, q1m_tab = groupby_agg(values, keys, 4, Q1_AGGS, spec, method=m,
                                   return_table=True)
        check(fingerprint_results(q1m) == digest
              and fingerprint_table(q1m_tab, spec) == tdigest,
              f"Q1 digests differ under {m}, priced by the measured race")
        del q1m, q1m_tab
    emit(phase="calibrated_plans", q1_measured_method=q1_plan.method,
         q1_priced_methods=priced, q1_digests_equal=True, **plans)

    # -- phase 7: the sharded GROUPBY -------------------------------------
    one = run_sharded(1, "nccl", n, args.seed)[0]
    check(one["results_digest"] == digest and one["table_digest"] == tdigest,
          "sharded Q1 SF10 (1 rank, NCCL) digests != groupby_agg's")
    check(one["segment_launches"] > 0,
          "sharded Q1 SF10 did not launch the segment kernel")
    small = 1 << 22
    sv, sk = q1_table(torch, dev, small, args.seed + 5)
    sres, stab = groupby_agg(sv, sk, 4, Q1_AGGS, spec, return_table=True)
    sdig, stdig = fingerprint_results(sres), fingerprint_table(stab, spec)
    del sv, sk, sres, stab
    multi = {}
    for world in (2, 4):
        recs = run_sharded(world, "gloo", small, args.seed + 5)
        for rec in recs:
            check(rec["results_digest"] == sdig
                  and rec["table_digest"] == stdig,
                  f"sharded Q1 (2^22 rows, {world} ranks over gloo) rank "
                  f"{rec['rank']} digests != groupby_agg's")
            check(rec["segment_launches"] > 0,
                  f"rank {rec['rank']} of {world} did not launch the "
                  "segment kernel")
        multi[str(world)] = recs
    emit(phase="sharded", card=name, power_limit=limit,
         q1_sf10_nccl_1_rank=one, q1_2p22_rows=small,
         q1_2p22_digest=sdig, gloo_card_tensors=multi)

    # -- phase 8: the paper's baselines -----------------------------------
    baselines(torch, np, dev, name, limit)

    # -- phase 9: the durable streaming store -----------------------------
    from repro_torch.obs import fingerprint as fp
    streamed = stream_phase(torch, np, dev, values, keys,
                            stream_digests(fp, q1, q1_tab),
                            stream_digests(fp, flat, flat_tab), spec, name,
                            limit, args.seed)
    del values, keys
    torch.cuda.empty_cache()

    # -- phase 10: reproducible training of smollm-135m -------------------
    trained = train_phase(name, limit, args.seed)
    tr_rsum, tr_embed = trained["rsum_at_largest_leaf"], trained["embed_grad"]

    # -- phase 11: granite-moe, hymba and xlstm served at full width -------
    served = serve_phase(name, limit, args.seed)

    # -- phase 12: the same three trained at full width, 2 units ----------
    families = train_families_phase(name, limit, args.seed)

    kernels = [
        {"name": "segment_rsum", "route": "cuda",
         "path": S.launch_shape(n, 4, X.shape[1], nlev, 132).path,
         "source": "src/repro_torch/kernels/segment_rsum/csrc/segment_rsum.cu",
         "replaces": "src/repro/kernels/segment_rsum/kernel.py:52",
         "launches": seg_launches, "max_abs_err": max(max_err, seg_err),
         "stream_launches": streamed["segment_launches"],
         "stream_batches": streamed["batches"],
         "train": {"shape": [tr_embed["rows"], tr_embed["G"],
                             tr_embed["ncols"]], "path": tr_embed["path"],
                   "launches_per_step": trained["modes"]["repro_zero2"][
                       "segment_launches_per_step"],
                   "forced_pallas_launches": trained["embed_race"][
                       "pallas"]["segment_launches"],
                   **{k: tr_embed[k] for k in (
                       "planner", "max_abs_err", "ms", "plain_ms",
                       "library_ms", "bound_ms", "bound_by")}},
         "serve_launches": served["kernel_launches"]["segment_rsum"],
         "ms": seg_ms, "call_ms": seg_call_ms, "plain_ms": seg_plain_ms,
         "bound_ms": seg_bound * 1e3,
         "bound_by": "bytes" if seg_bytes / HBM_BYTES_PER_S
         >= seg_ops / F32_OPS_PER_S else "operations",
         "library_ms": yard_ms},
        {"name": "rsum", "route": "cuda", "path": "vector",
         "source": "src/repro_torch/kernels/rsum/csrc/rsum.cu",
         "replaces": "src/repro/kernels/rsum/kernel.py:33",
         "launches": rsum_launches, "max_abs_err": max(max_err, rsum_err),
         "stream_launches": streamed["rsum_launches"],
         "stream_batches": streamed["batches"],
         "train": {"launches_per_step": trained["modes"]["repro_zero2"][
                       "rsum_launches_per_step"],
                   "norm_launches": trained["global_norm"][
                       "norm_rsum_launches"],
                   **{k: tr_rsum[k] for k in (
                       "n", "max_abs_err", "ms", "plain_ms", "library_ms",
                       "bound_ms", "bound_by")}},
         "train_families": {
             arch: {"leaves": m["leaves"],
                    "launches_per_step": m["modes"]["repro_zero2"][
                        "rsum_launches_per_step"]}
             for arch, m in families["models"].items()},
         "serve_launches": served["kernel_launches"]["rsum"],
         "ms": rsum_ms, "call_ms": rsum_call_ms, "plain_ms": rsum_plain_ms,
         "bound_ms": rsum_bound * 1e3,
         "bound_by": "bytes" if rsum_bytes / HBM_BYTES_PER_S
         >= rsum_ops / F32_OPS_PER_S else "operations",
         "library_ms": flat_lib_ms},
    ]
    print(card, flush=True)
    return {"kernels": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        summary = run(args)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
