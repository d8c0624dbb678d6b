"""The per-stage reading of the program's spans (``portbench/spans.py``): a
hand-made Chrome trace with two queries, whose device operations are tied
to their launches by ``correlation``, and runs of a cell on the CPU with
the program's spans and counter and without them."""
import types

import pytest

torch = pytest.importorskip("torch")

from portbench.tests._cpu import cpu_run  # noqa: E402
from portbench import spans  # noqa: E402

HAND = frozenset({"segment_private"})
HAND_NAME = "void (anonymous namespace)::segment_private<2, 6>(int const*)"
GLUE_NAME = "void at::native::elementwise_kernel<128, 2>(int)"


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _launch(ts, corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 1, "args": {"correlation": corr}}


def _op(name, cat, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _query(t, c):
    """One query from ``t`` (us) with correlation ids from ``c``: a glue
    kernel launched in ``groupby.columns``, a host read in the root
    outside any stage, the hand kernel and a glue kernel launched in
    ``groupby.aggregate``, and an idle gap in the middle of
    ``groupby.aggregate``."""
    return [
        _span("groupby", t, 100), _span("groupby.columns", t + 5, 25),
        _span("groupby.aggregate", t + 40, 50),
        _launch(t + 10, c), _op(GLUE_NAME, "kernel", t + 12, 18, c),
        _launch(t + 35, c + 1, "cudaMemcpyAsync"),
        _op("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t + 35, 4,
            c + 1),
        _launch(t + 45, c + 2), _op(HAND_NAME, "kernel", t + 46, 10, c + 2),
        _launch(t + 70, c + 3), _op(GLUE_NAME, "kernel", t + 71, 6, c + 3),
    ]


def _trace():
    stray = [_launch(150, 99), _op(GLUE_NAME, "kernel", 151, 3, 99),
             {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 11,
              "dur": 2}]
    return _query(0, 1) + _query(200, 11) + stray


def test_device_operations_go_to_the_innermost_span_of_their_launch():
    a = spans.attribute(_trace(), HAND)
    assert a.queries == 2
    assert a.seen == {"groupby", "groupby.columns", "groupby.aggregate"}
    assert a.glue_ms == pytest.approx({"groupby.columns": 0.018,
                                       "groupby": 0.004,
                                       "groupby.aggregate": 0.006})
    assert a.hand_ms == pytest.approx({"groupby.aggregate": 0.010})
    assert a.dtoh == 1.0
    assert a.outside_ms == pytest.approx(0.0015)
    assert a.device_ops == 9


def test_idle_gaps_go_to_the_span_at_their_middle():
    """Per query: 0-12 goes to columns (its middle, 6, lies in columns,
    which starts at 5), 30-35 to the root, 39-46, 56-71 and 77-100 to
    aggregate (the last one's middle, 88.5, lies before its end at 90)."""
    a = spans.attribute(_trace(), HAND)
    assert a.idle_ms == pytest.approx({"groupby.columns": 0.012,
                                       "groupby": 0.005,
                                       "groupby.aggregate": 0.045})


def test_the_metrics_read_the_cached_reading_per_query():
    a = spans.attribute(_trace(), HAND)
    run = types.SimpleNamespace()
    setattr(run, spans._CACHE, spans.Reading(
        passes=20, host_ms={"groupby.plan": 0.25}, host_reads=3.0,
        reads_by_site={}, device=a))
    assert spans.device_ms(run, "groupby.columns") == pytest.approx(0.018)
    assert spans.device_ms(run, "groupby.aggregate") == pytest.approx(0.006)
    assert spans.device_ms(run, "groupby.finalize") is None
    assert spans.host_ms(run, "groupby.plan") == 0.25
    assert spans.host_ms(run, "groupby.prescan") is None
    no_device = spans.attribute([e for e in _trace()
                                 if e["cat"] == "user_annotation"], HAND)
    assert (no_device.queries, no_device.device_ops) == (2, 0)
    setattr(run, spans._CACHE, spans.Reading(20, {}, 3.0, {}, no_device))
    assert spans.device_ms(run, "groupby.columns") is None


NEW = ("columns_ms", "prescan_ms", "aggregate_glue_ms", "finalize_ms",
       "planner_ms", "host_reads_per_query")


def test_a_traced_cpu_run_reads_the_programs_spans_and_counter():
    """On the CPU no device operation runs: the host-clock and counter
    metrics read, the device ones report nothing."""
    res = cpu_run("q1_sf10", seconds=0.3, trace=True)
    got = res["metrics"]
    assert got["host_reads_per_query"]["value"] == 3.0
    assert got["planner_ms"]["value"] > 0
    assert not set(got) & {"columns_ms", "prescan_ms", "aggregate_glue_ms",
                           "finalize_ms"}
    assert res["correct"] is True


def test_a_program_without_spans_or_counter_gives_no_reading(monkeypatch):
    from repro_torch.obs import metrics, trace
    monkeypatch.setattr(trace, "span",
                        lambda name, **attrs: trace._NULL_SPAN)
    monkeypatch.setattr(metrics, "host_read", lambda site: None)
    res = cpu_run("q18_sf10_ordered", seconds=0.3, trace=True)
    assert not set(res["metrics"]) & set(NEW)
    assert res["correct"] is True
