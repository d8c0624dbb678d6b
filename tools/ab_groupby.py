#!/usr/bin/env python3
"""Time one-shot ``groupby_agg`` with the library of two source trees, in
turns, on one CUDA card.

    python3 tools/ab_groupby.py TREE_A TREE_B [--rounds 2] [--reps 15]

Each run is a fresh process that puts ``TREE/src`` first on the path,
builds the kernels, draws TPC-H Q1's lineitem table at SF10 on the card
with ``chip_smoke.q1_table`` of *this* checkout (so both trees get the
same rows), and times Q1's ``GROUP BY l_returnflag, l_linestatus`` and the
same table without GROUP BY (host clock around a synchronized call, the
median and minimum of ``--reps`` calls after three warm-up calls).  Runs
go A, B, B, A per round, so a drift over the call falls on both trees.
Each run prints one JSON line; the card's name and power limit come
first.  A tree is any directory holding ``src/repro_torch`` (a checkout,
or ``git archive <commit>`` unpacked).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def worker(tree: str, label: str, reps: int) -> None:
    sys.path.insert(0, str(Path(tree, "src")))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as cs
    from repro_torch.core.types import ReproSpec
    from repro_torch.kernels import _build
    from repro_torch.ops import groupby_agg

    assert Path(sys.modules["repro_torch"].__file__).is_relative_to(
        Path(tree).resolve()), "the tree's library was not the one imported"
    _build.build_all()
    dev = torch.device("cuda")
    spec = ReproSpec()
    values, keys = cs.q1_table(torch, dev, cs.SF10_LINEITEM, 0)
    zeros = torch.zeros_like(keys)

    def q1():
        return groupby_agg(values, keys, 4, cs.Q1_AGGS, spec)

    def flat():
        return groupby_agg(values, zeros, 1, cs.FLAT_AGGS, spec)

    for _ in range(3):
        q1()
        flat()
    out = {"tree": label}
    for name, fn in (("q1", q1), ("flat", flat)):
        times = [cs.host_ms(torch, fn, reps=1) for _ in range(reps)]
        out[f"{name}_ms"] = statistics.median(times)
        out[f"{name}_min_ms"] = min(times)
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "LABEL"))
    args = ap.parse_args()
    if args.worker:
        worker(args.worker[0], args.worker[1], args.reps)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    a, b = (os.path.abspath(t) for t in args.trees)
    for _ in range(args.rounds):
        for tree, label in ((a, "A"), (b, "B"), (b, "B"), (a, "A")):
            subprocess.run([sys.executable, __file__, "--worker", tree,
                            label, "--reps", str(args.reps)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
