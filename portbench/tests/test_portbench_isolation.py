"""The benchmark loads neither JAX nor the JAX package ``repro`` (top-level
names compared whole: ``repro_torch`` is not ``repro``), its references
load nothing of ``repro_torch``, and a run without a card, or without the
program, prints no result."""
import json
import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from portbench.tests._cpu import ROOT  # noqa: E402


def _python(code, cwd=ROOT, env=None, timeout=300):
    env = dict(os.environ if env is None else env)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_a_run_loads_no_jax_and_no_reference_package():
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from portbench.tests._cpu import cpu_run
from portbench import harness
for cell in ("q1_sf10", "q18_sf10_shuffled"):
    for trace in (False, True):
        assert cpu_run(cell, trace=trace)["correct"]
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
print(json.dumps(harness.forbidden_modules()))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded_line, forbidden_line = out.stdout.strip().splitlines()[-2:]
    loaded = set(json.loads(loaded_line))
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}
    assert json.loads(forbidden_line) == []


def test_the_forbidden_names_are_compared_whole():
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from portbench import harness
import repro_torch
assert harness.forbidden_modules() == [], harness.forbidden_modules()
sys.modules["repro.core"] = sys.modules["repro_torch"]
assert harness.forbidden_modules() == ["repro"]
print("ok")
"""
    out = _python(code)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]


def test_the_references_load_nothing_of_the_program():
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}]
import torch
from portbench import catalog
b = catalog.Benchmark()
for c in b.spec["configs"]:
    cfg = dict(b.config(c["name"]), orders=500)
    v, k, g = b.generator(cfg).draw("cpu", cfg, 3)
    b.reference(cfg).results(v, k, g, cfg["aggregates"])
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ("repro_torch", "repro", "jax"))
print(bad)
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_a_run_without_a_card_fails_and_does_not_fall_back():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "q1_sf10",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert _no_result(out) and "needs 1 CUDA card" in out.stderr


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = f"""
import sys
sys.path[:0] = [{str(tmp_path / 'src')!r}, {str(tmp_path)!r}]
from portbench import catalog, harness
cell = catalog.Benchmark().cell("q18_sf10_ordered")
print(harness.run_cell(cell, 1, 0.2, False, device="cpu",
                       scale={{"orders": 100}}))
"""
    out = _python(code, cwd=tmp_path)
    assert out.returncode != 0 and _no_result(out)
    assert "No module named 'repro_torch'" in out.stderr
