#!/usr/bin/env python3
"""The benchmark's one command: one run of one cell on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout.  It prints information lines, then as
its last line one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks``
last: each number compared with its limit); the same numbers are the last
lines of standard error.  A cell whose ``chips`` is above 1 runs as that
many rank processes, one to a card, that call the program in lockstep
(``ranks.py``); rank 0 prints the information lines, and this process the
result.  Exit codes: 0 a result was printed (``correct`` may be false); 2
no CUDA card, or fewer than the cell asks for, or no such cell; 3 the JAX
package or JAX was loaded (in any rank); 4 the program defines a kernel
that ``hand_kernels/*.json`` does not name; 5 a rank failed, exited early
or hung past its collective timeout or its deadline, and every rank was
killed.  It writes only inside the checkout (``.portbench_cache/``:
bytecode and kernel caches at fixed paths; the program's kernel build
directory) and under ``TMPDIR`` (the ranks' store).
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
CACHE = ROOT / ".portbench_cache"
if __name__ == "__main__":
    # bytecode of every module the run imports (torch's too, whose install
    # may hold none), compiled by the checkout's first run only, kept in
    # the checkout even where the environment turns bytecode writing off
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
# never present and never written: the planner plans with its cold model
CALIBRATION_CACHE = HERE / "no_calibration.json"


def pin_environment(env=os.environ) -> None:
    """The program's knobs, fixed for every run: no calibration cache, no
    autotuning, its trace and metrics dump off; every kernel cache at a
    fixed path inside the checkout; one CPU thread."""
    env["REPRO_TORCH_CALIBRATION_CACHE"] = str(CALIBRATION_CACHE)
    for name in ("REPRO_TORCH_AUTOTUNE", "REPRO_TRACE", "REPRO_METRICS"):
        env.pop(name, None)
    env["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    env["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    env["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    env["OMP_NUM_THREADS"] = "1"
    env["USE_FLAX"] = "0"


def _finite(x):
    return x if math.isfinite(x) else 1e300


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_environment()
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch
    from portbench import catalog, harness

    torch.set_num_threads(1)
    try:
        cell = catalog.Benchmark(ROOT).cell(args.workload)
    except KeyError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " -- no result", file=sys.stderr)
        return 2
    from portbench import ranks
    say = lambda s: print(s, flush=True)  # noqa: E731
    try:
        if cell.chips > 1:
            result = ranks.launch(cell, args.seed, args.seconds,
                                  bool(args.trace), t0=T0, say=say)
        else:
            result = harness.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace), t0=T0, say=say)
    except harness.UnlistedKernels as exc:
        print(f"portbench: {exc} -- no result", file=sys.stderr)
        return 4
    except ranks.RanksFailed as exc:
        print(f"portbench: {exc} -- no result", file=sys.stderr)
        return exc.code
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}: the benchmark runs the port alone "
              "-- no result", file=sys.stderr)
        return 3
    for name, n in result["checks"].items():
        ok = "ok" if n["limit"] is not None and n["value"] <= n["limit"] \
            else "FAIL"
        print(f"check {name} {n['value']!r} limit {n['limit']!r} {ok}",
              file=sys.stderr)
        n["value"] = _finite(n["value"])
    print(f"check correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
