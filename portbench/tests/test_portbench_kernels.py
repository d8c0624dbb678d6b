"""The kernels layer is pinned by name in ``hand_kernels/*.json``: every
kernel the program's sources define is listed there, and a run gives no
result where the program defines one that is not."""
import json
import shutil

import pytest

pytest.importorskip("torch")

from portbench import catalog, devtrace, harness  # noqa: E402
from portbench.tests._cpu import ROOT, cpu_run  # noqa: E402

_NEW_CUDA = """
template <int N>
__global__ void __launch_bounds__(128) fused_build(const float* x) {}
"""
_NEW_TRITON = """
import triton

@triton.autotune(configs=[], key=["n"])
@triton.jit
def fused_prescan(x_ptr, n):
    pass
"""


def _program_copy(tmp_path):
    dst = tmp_path / "repro_torch"
    shutil.copytree(ROOT / "src/repro_torch", dst,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    return dst


def test_every_kernel_of_the_program_is_pinned():
    found = devtrace.program_kernels(harness.program_dir())
    pinned = catalog.Benchmark(ROOT).hand_kernels()
    assert set(found) == pinned
    assert {"segment_private", "segment_partitioned", "partition_scatter",
            "rsum_kernel"} <= pinned
    for p in sorted((ROOT / "portbench/hand_kernels").glob("*.json")):
        entry = json.loads(p.read_text())
        assert entry["layer"] == "kernels"
        text = (ROOT / entry["source"]).read_text()
        assert all(f" {name}(" in text for name in entry["kernels"])


@pytest.mark.parametrize("where,text,name", [
    ("kernels/segment_rsum/csrc/fused.cuh", _NEW_CUDA, "fused_build"),
    ("ops/fused.py", _NEW_TRITON, "fused_prescan"),
])
def test_an_unlisted_kernel_gives_no_result(tmp_path, monkeypatch, where,
                                            text, name):
    program = _program_copy(tmp_path)
    (program / where).write_text(text)
    assert devtrace.program_kernels(program)[name] == where
    monkeypatch.setattr(harness, "program_dir", lambda: program)
    with pytest.raises(harness.UnlistedKernels, match=name):
        cpu_run("q18_sf10_ordered")


def test_a_kernel_pinned_in_a_new_file_is_found(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    (tmp_path / "portbench/hand_kernels/fused.json").write_text(json.dumps(
        {"why": "a test", "source": "src/repro_torch/ops/fused.py",
         "layer": "kernels", "kernels": ["fused_prescan"]}))
    pinned = catalog.Benchmark(tmp_path).hand_kernels()
    assert "fused_prescan" in pinned and "rsum_kernel" in pinned
    program = _program_copy(tmp_path)
    (program / "ops/fused.py").write_text(_NEW_TRITON)
    harness.check_kernels(pinned, program)
