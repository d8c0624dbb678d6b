"""The four-card Q1 cell's own pieces on the CPU: its configuration at a
tiny scale over 4 gloo ranks through the rank path, the readers of the
collectives layer and of the rank rooflines, and the blocked plain
reference against the plain one."""
import json
import shutil
import types

import pytest

torch = pytest.importorskip("torch")

from portbench.tests import _ranks  # noqa: E402
from portbench.tests._cpu import ROOT  # noqa: E402
from portbench import catalog, rank_spans, spans  # noqa: E402

CELL, CONFIG = "q1_sf100_4chips", "tpch_sf100_q1_4chips"
H100 = "NVIDIA H100 80GB HBM3"
NCCL = "ncclDevKernel_AllReduce_Sum_u32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
GLUE = "void at::native::elementwise_kernel<128, 2>(int)"


def _bench():
    return catalog.Benchmark(ROOT)


def _reader(name):
    return _bench().reader(name)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """One traced run of the cell over 4 gloo ranks, its configuration cut
    to 2,000 orders a rank."""
    root = tmp_path_factory.mktemp("sf100") / "bench"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    path = root / "portbench/configs" / f"{CONFIG}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    orders=2000)))
    return _ranks.result(_ranks.run(root, CELL, trace=True))


def test_the_cell_runs_four_ranks_of_sharded_groupby_agg():
    cell = _bench().cell(CELL)
    assert cell.chips == 4
    assert cell.config["entry"] == "sharded_groupby_agg"
    assert cell.config["reference"] == "groupby_plain_blocked"
    assert [m["name"] for m in cell.per_layer] == [
        "merge_ms", "lattice_ms", "collectives_per_query",
        "rank_query_roofline", "rank_kernel_roofline"]


def test_tiny_scale_over_four_gloo_ranks_is_correct(tiny_run):
    assert tiny_run["correct"] is True, tiny_run["checks"]
    assert tiny_run["device"]["count"] == 4
    assert tiny_run["checks"]["perm_diff"]["value"] == 0


def test_a_traced_run_counts_five_collectives_a_query(tiny_run):
    """The lattice MAX, repro_psum's e1 MAX, k SUM and C SUM, and the row
    count SUM.  On the CPU no device operation runs: the span readers and
    the rooflines (no peaks) report nothing."""
    got = tiny_run["metrics"]
    assert got["collectives_per_query"]["value"] == 5.0
    assert not set(got) & {"merge_ms", "lattice_ms", "rank_query_roofline",
                           "rank_kernel_roofline"}


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx",
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _op(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _query(t, c):
    """One query from ``t`` (us): a glue kernel in the prescan, the
    lattice's all-reduce inside it, and the merge's all-reduce and a glue
    kernel in ``groupby.merge``."""
    return [
        _span("groupby", t, 100), _span("groupby.prescan", t + 5, 30),
        _span("groupby.lattice", t + 20, 10), _span("groupby.merge", t + 60,
                                                    30),
        _launch(t + 6, c), _op(GLUE, t + 7, 8, c),
        _launch(t + 21, c + 1), _op(NCCL, t + 22, 12, c + 1),
        _launch(t + 61, c + 2), _op(NCCL, t + 62, 20, c + 2),
        _launch(t + 70, c + 3), _op(GLUE, t + 83, 3, c + 3),
    ]


def _cached(events, collectives=5.0):
    roots, seen, ms, ops = rank_spans.attribute(events)
    run = types.SimpleNamespace()
    setattr(run, rank_spans._CACHE, rank_spans.Reading(
        passes=20, collectives=collectives, queries=roots, seen=seen,
        device_ms={k: v / roots for k, v in ms.items()} if roots else {},
        device_ops=ops))
    return run


def test_device_operations_go_to_the_innermost_span_of_their_launch():
    roots, seen, ms, ops = rank_spans.attribute(_query(0, 1)
                                                + _query(200, 11))
    assert (roots, ops) == (2, 8)
    assert seen == {"groupby", "groupby.prescan", "groupby.lattice",
                    "groupby.merge"}
    assert ms == pytest.approx({"groupby.prescan": 0.016,
                                "groupby.lattice": 0.024,
                                "groupby.merge": 0.046})


def test_the_collectives_readers_read_the_cached_reading_per_query():
    run = _cached(_query(0, 1) + _query(200, 11))
    assert _reader("lattice_ms").read(run) == pytest.approx(0.012)
    assert _reader("merge_ms").read(run) == pytest.approx(0.023)
    assert _reader("collectives_per_query").read(run) == 5.0


def test_a_program_without_the_spans_or_counter_gives_no_reading():
    older = [e for e in _query(0, 1) if e["name"] not in
             ("groupby.lattice", "groupby.merge")]
    run = _cached(older, collectives=None)
    for name in ("lattice_ms", "merge_ms", "collectives_per_query"):
        assert _reader(name).read(run) is None
    assert set(rank_spans.SPANS) > set(spans.SPANS)


def _roofline_run(rank_rows, world):
    return types.SimpleNamespace(
        config=_bench().config(CONFIG), device_kind=H100, groups=4,
        rows=rank_rows * world, rank_rows=rank_rows,
        stretch=types.SimpleNamespace(queries=20, seconds=1.0),
        hand_kernel_s=lambda: 0.03)


@pytest.mark.parametrize("rank_name,whole_name",
                         [("rank_query_roofline", "query_roofline"),
                          ("rank_kernel_roofline", "kernel_roofline")])
def test_the_rank_rooflines_count_one_ranks_rows(rank_name, whole_name):
    rank_rows = 147_900_000
    run = _roofline_run(rank_rows, 4)
    got = _reader(rank_name).read(run)
    assert 0 < got <= 100
    # the single-card reading over this rank's rows alone
    assert got == pytest.approx(
        _reader(whole_name).read(_roofline_run(rank_rows, 1)), rel=1e-12)
    # over every rank's rows it would read 4 times as much
    assert _reader(whole_name).read(run) / got == pytest.approx(4, rel=1e-6)


def test_the_blocked_reference_equals_the_plain_one_over_several_blocks():
    bench = _bench()
    cfg = dict(bench.config(CONFIG), orders=3000)
    values, keys, groups = bench.generator(cfg).draw("cpu", cfg, 2 ** 33 + 7)
    assert values.shape[0] > 2 * 4096      # three blocks or more
    aggs = cfg["aggregates"]
    want = bench.module("reference", "groupby_plain").results(
        values, keys, groups, aggs)
    got = bench.reference(cfg).results(values, keys, groups, aggs,
                                       block_rows=4096)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float64
        assert torch.allclose(got[name], w, rtol=1e-12, atol=0), name
