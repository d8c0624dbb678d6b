"""The least bytes and operations of the two configurations' queries."""
import pytest

pytest.importorskip("torch")

from portbench.tests._cpu import ROOT  # noqa: E402
from portbench import catalog, work  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def _config(name):
    return catalog.Benchmark(ROOT).config(name)


def test_q1_least_bytes_are_24_a_row():
    cfg = _config("tpch_sf10_q1")
    assert work.columns_read(cfg) == [0, 1, 2, 3, 4]
    rows = 59_142_003
    # 5 float32 columns and the int32 group id; 8 results x 4 groups
    assert work.least_bytes(cfg, rows, 4) == 24 * rows + 4 * 4 * 8
    assert work.summed_values(cfg) == 6          # 5 columns and the count
    assert work.least_ops(cfg, rows) == 6 * rows


def test_q18_least_bytes_are_8_a_row_and_60_mb():
    cfg = _config("tpch_sf10_q18")
    rows = 59_997_478
    assert work.least_bytes(cfg, rows, 15_000_000) == 8 * rows + 60_000_000
    assert work.least_ops(cfg, rows) == rows


@pytest.mark.parametrize("name,groups", [("tpch_sf10_q1", 4),
                                         ("tpch_sf10_q18", 15_000_000)])
def test_both_queries_are_bound_by_bytes_on_the_h100(name, groups):
    cfg = _config(name)
    peak = work.peaks(H100)
    assert peak == {"bytes_per_s": 3.35e12, "float32_ops_per_s": 67e12}
    seconds, by = work.least_seconds(cfg, 60_000_000, groups, peak)
    assert by == "bytes"
    assert seconds == pytest.approx(
        work.least_bytes(cfg, 60_000_000, groups) / 3.35e12)


def test_an_unknown_device_has_no_peaks():
    assert work.peaks("cpu") is None
