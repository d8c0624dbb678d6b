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
   operation and the device's idle share.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON summary.  Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
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


def profile_q1(torch, fn, e2e_ms: float, card: str, limit: str) -> None:
    """Where one end-to-end call spends device time: device time per torch
    operation and per kernel, and the device's idle share of the unprofiled
    end-to-end time (busy time summed over kernels only, so an operation
    and the kernels it launched are not counted twice)."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, kernels = {}, {}
    for e in prof.key_averages():
        if device_us(e) <= 0:
            continue
        side = kernels if str(e.device_type).endswith("CUDA") else ops
        key = e.key[:100]
        side[key] = side.get(key, 0.0) + device_us(e) / 1e3
    busy_ms = sum(kernels.values())

    def top(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:8])

    emit(phase="profile_q1", card=card, power_limit=limit,
         device_busy_ms=busy_ms, e2e_ms=e2e_ms,
         # None: the profiler saw no kernel (not measured)
         device_idle_share=max(0.0, 1.0 - busy_ms / e2e_ms) if busy_ms
         else None,
         top_op_device_ms=top(ops), top_kernel_device_ms=top(kernels))


def same_results(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].cpu().numpy().tobytes() == b[k].cpu().numpy().tobytes()
        for k in a)


def planned_method(trace) -> str:
    plans = [e for e in trace.events() if e["name"] == "plan.groupby"]
    return plans[-1]["attrs"]["method"]


def run(args) -> dict:
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
    from repro_torch.ops import groupby_agg
    from repro_torch.ops.partial import AggSignature, _build_columns

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
    flat = groupby_agg(values, zeros, 1, FLAT_AGGS, spec)
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
    kernels = [
        {"name": "segment_rsum", "route": "cuda",
         "path": S.launch_shape(n, 4, X.shape[1], nlev, 132).path,
         "source": "src/repro_torch/kernels/segment_rsum/csrc/segment_rsum.cu",
         "replaces": "src/repro/kernels/segment_rsum/kernel.py:52",
         "launches": seg_launches, "max_abs_err": max(max_err, seg_err),
         "ms": seg_ms, "call_ms": seg_call_ms, "plain_ms": seg_plain_ms,
         "bound_ms": seg_bound * 1e3,
         "bound_by": "bytes" if seg_bytes / HBM_BYTES_PER_S
         >= seg_ops / F32_OPS_PER_S else "operations",
         "library_ms": yard_ms},
        {"name": "rsum", "route": "cuda", "path": "vector",
         "source": "src/repro_torch/kernels/rsum/csrc/rsum.cu",
         "replaces": "src/repro/kernels/rsum/kernel.py:33",
         "launches": rsum_launches, "max_abs_err": max(max_err, rsum_err),
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
