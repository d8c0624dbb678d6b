#!/usr/bin/env python3
"""Device time of each kernel of one call, per shape, from
``torch.profiler``, on one CUDA card: the segment kernel on each of its
paths and the rsum kernel.

    python3 tools/segment_stages.py [TREE ...] [--cases q18,embed]
                                    [--rounds 1] [--calls 20]

Cases (tables drawn on the card with *this* checkout's ``chip_smoke``
builders and seeds, so every tree gets the same rows): ``q1`` (TPC-H Q1
at SF10, the private path), ``flat`` (the same rows without GROUP BY, the
rsum kernel), ``q9`` and ``q9_sorted`` (Q9's 175 groups, one group tile,
in lineitem order and sorted), ``q18`` and ``q18_permuted`` (Q18's inner
GROUP BY at SF10, 15,000,000 groups, in l_orderkey order and permuted),
``embed`` (1,024 x 576 into 49,152 groups) and ``shard`` (256 x 3,072
into 64,128): the last four take the tiled path over several group tiles
(partition, then aggregate).

Each case prints one JSON line: the tree, the case, and the device ms of
one call per kernel (self device time over ``--calls`` calls after two
warm-up calls) and in all.  With no TREE it runs this checkout in this
process; with trees, each run is a fresh process that puts ``TREE/src``
first on the path, and runs go A, B, B, A per round.  A tree is any
directory holding ``src/repro_torch`` (a checkout, or ``git archive
<commit>`` unpacked).  The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CASES = ("q1", "flat", "q9", "q9_sorted", "q18", "q18_permuted", "embed",
         "shard")


def _inputs(torch, cs, case: str, dev):
    """(x, ids, G) of a segment case, or (x, None, 1) of the flat one."""
    from repro_torch.core.types import ReproSpec
    from repro_torch.ops.partial import AggSignature, _build_columns

    spec = ReproSpec()
    if case in ("q1", "flat"):
        values, keys = cs.q1_table(torch, dev, cs.SF10_LINEITEM, 0)
        aggs, g = (cs.Q1_AGGS, 4) if case == "q1" else (cs.FLAT_AGGS, 1)
        x = _build_columns(values, AggSignature.build(aggs, g, spec)
                           .compiled[1], spec)
        return x, (keys if case == "q1" else None), g
    if case.startswith("q9"):
        x, keys = cs.q9_table(torch, dev, cs.SF10_ORDERS, 4)
        if case == "q9_sorted":
            order = torch.sort(keys, stable=True).indices
            x, keys = x[order].contiguous(), keys[order]
        return x, keys, cs.Q9_NATIONS * len(cs.Q9_YEAR_DAYS)
    gen = torch.Generator(device=dev)
    if case.startswith("q18"):
        x, keys = cs.q18_table(torch, dev, cs.SF10_ORDERS, 2)
        if case == "q18_permuted":
            gen.manual_seed(3)
            perm = torch.randperm(keys.shape[0], generator=gen, device=dev)
            x, keys = x[perm].contiguous(), keys[perm]
        return x, keys, cs.SF10_ORDERS
    rows, g, d = cs.EMBED_SHAPE if case == "embed" else cs.SHARD_SHAPE
    gen.manual_seed(6)
    x = torch.randn((rows, d), generator=gen, device=dev) * 1e-3
    return x, torch.randint(0, g, (rows,), generator=gen, device=dev,
                            dtype=torch.int32), g


def worker(tree: str, label: str, cases: list, calls: int) -> None:
    sys.path.insert(0, str(Path(tree, "src")))
    sys.path.insert(1, str(HERE))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core import accumulator as acc
    from repro_torch.core.types import ReproSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels.rsum import ops as R
    from repro_torch.kernels.segment_rsum import ops as S

    assert Path(sys.modules["repro_torch"].__file__).is_relative_to(
        Path(tree).resolve()), "the tree's library was not the one imported"
    _build.build_all()
    dev = torch.device("cuda")
    spec = ReproSpec()
    for case in cases:
        x, ids, g = _inputs(torch, cs, case, dev)
        A, iu = R.ladder(acc.required_e1(x, spec, axis=0), spec,
                         (0, spec.L))
        if ids is None:
            def call():
                return R.rsum_levels_kernel(x, A, iu, spec)
        else:
            def call():
                return S.segment_levels_kernel(x, ids, g, A, iu, spec)
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0 and str(e.device_type).endswith("CUDA"):
                kernels[e.key[:80]] = us / 1e3 / calls
        print(json.dumps({"tree": label, "case": case, "kernels": kernels,
                          "device_ms": sum(kernels.values())}), flush=True)
        del x, ids, A, iu
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "LABEL"))
    args = ap.parse_args()
    cases = args.cases.split(",")
    if not set(cases) <= set(CASES):
        ap.error(f"cases are {', '.join(CASES)}")
    import torch
    if not torch.cuda.is_available():
        print("segment_stages: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        worker(*args.worker, cases, args.calls)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if not args.trees:
        worker(str(HERE), "this", cases, args.calls)
        return 0
    trees = [os.path.abspath(t) for t in args.trees]
    order = [(t, chr(65 + i)) for i, t in enumerate(trees)]
    for _ in range(args.rounds):
        for tree, label in order + order[::-1]:
            cmd = [sys.executable, __file__, "--worker", tree, label,
                   "--cases", args.cases, "--calls", str(args.calls)]
            subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
