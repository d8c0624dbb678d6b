"""Shared helpers of the benchmark's CPU tests: a run of a cell at a tiny
size on the CPU, with the limits of a configuration given."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import catalog, harness  # noqa: E402

TINY = {"orders": 2000}
CELLS = ("q1_sf10", "q18_sf10_shuffled", "q18_sf10_ordered")


def cpu_run(cell_name: str, seed: int = 2 ** 33 + 11, seconds: float = 0.3,
            trace: bool = False, entry=None, bench=None,
            scale: dict = TINY) -> dict:
    bench = bench or catalog.Benchmark(ROOT)
    return harness.run_cell(bench.cell(cell_name), seed, seconds, trace,
                            device="cpu", entry=entry, scale=scale,
                            say=lambda s: None)
