#!/usr/bin/env python3
"""The readings that a cell's limits are set from (not part of a run).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \
        [--seconds 1] [--control bfloat16]

For each seed, in one process: a short window of the program at the cell's
own size and load, then (with ``--control``) the same with the control in
the program's place -- the plain reference computed in the precision below
the configuration's (``reference/<name>.py`` with ``dtype``).  Prints one
JSON line per run with the numbers ``checks.py`` compares, then a summary:
the largest reading of the program and the smallest of the control.  The
limits in ``configs/<config>.json`` are set between the two.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.run import ROOT, pin_environment  # noqa: E402


def control_entry(bench, config, dtype):
    import torch
    ref = bench.reference(config)

    def entry(values, keys, groups, aggs):
        out = ref.results(values, keys, groups, aggs, dtype=dtype)
        return {k: v.to(torch.float32) for k, v in out.items()}

    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pin_environment()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from portbench import catalog, harness

    torch.set_num_threads(1)
    cell = catalog.Benchmark(ROOT).cell(args.workload)
    sides = [("program", None)]
    if args.control:
        sides.append((f"control_{args.control}", control_entry(
            cell.bench, cell.config, getattr(torch, args.control))))
    worst: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        for side, entry in sides:
            t = time.perf_counter()
            res = harness.run_cell(cell, seed, args.seconds, False,
                                   device=args.device, entry=entry,
                                   say=lambda s: None)
            nums = {k: v["value"] for k, v in res["checks"].items()}
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": side, **nums,
                              "attempted": res["attempted"],
                              "seconds": time.perf_counter() - t}),
                  flush=True)
            pick = max if side == "program" else min
            for k, v in nums.items():
                key = (side, k)
                worst[key] = v if key not in worst else pick(worst[key], v)
    print(json.dumps({"summary": cell.name, **{f"{s}.{k}": v for (s, k), v
                                               in worst.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
