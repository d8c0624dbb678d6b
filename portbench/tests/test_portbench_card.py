"""One short run of every cell on the card, untraced and traced, through
the benchmark's command.  Marked ``cuda``: it skips without a card.

    python -m pytest -q -m cuda portbench/tests/test_portbench_card.py
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from portbench.tests._cpu import CELLS, ROOT  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_and_reports_its_metrics(card, cell, trace):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 32 + 99), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for m in ("kernel_roofline", "query_roofline"):
            assert 0 < res["metrics"][m]["value"] <= 100
