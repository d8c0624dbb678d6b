"""The rank path (``portbench/ranks.py``) on the CPU, over gloo: a tiny Q1
whose configuration names the program entry ``sharded_groupby_agg`` runs
as 1, 2 and 4 ranks, each in a process of its own, started in a session
of its own with a time limit.

Each world is correct, counts every rank's rows, and every answer of
every rank equals one-process ``groupby_agg`` over all ranks' rows, bit
for bit; a world of one gives the one-process path's check numbers.
Planted faults (a rank that drops its last row, one rank's answer with one
bit changed, a merge that adds the ranks' float32 results in rank order)
read ``correct`` false, and a rank that sleeps past the collective timeout
ends the run with exit 5, no result line, and no process left behind.
"""
import json
import os
import re

import pytest

torch = pytest.importorskip("torch")

from portbench.tests import _ranks  # noqa: E402
from portbench.tests._cpu import cpu_run  # noqa: E402
from portbench import catalog, harness  # noqa: E402

WORLDS = (1, 2, 4)
FAULTS = {"drop_last_row": "max_err_ulp", "one_bit": "window_diff",
          "float_merge": "perm_diff"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The recording entry at each world: {world: (done, root, out)}."""
    tmp = tmp_path_factory.mktemp("ranks")
    root = _ranks.bench_copy(tmp, {f"tiny_w{w}": ("recording", w)
                                   for w in WORLDS})
    runs = {}
    for w in WORLDS:
        for p in (tmp / "out").glob("*"):
            p.unlink()
        done = _ranks.run(root, f"tiny_w{w}")
        answers = {r: json.loads((tmp / "out" / f"answers-{r}.json")
                                 .read_text()) for r in range(w)}
        runs[w] = (done, root, answers)
    return runs


def _concatenated(root, cell_name, world):
    """Every rank's rows drawn again, in rank order, and their counts."""
    cell = catalog.Benchmark(root).cell(cell_name)
    dev = torch.device("cpu")
    parts = [harness.draw_rows(cell, cell.config, _ranks.SEED, dev, r, world)
             for r in range(world)]
    return (torch.cat([v for v, _, _ in parts]),
            torch.cat([k for _, k, _ in parts]), parts[0][2], cell,
            [int(k.shape[0]) for _, k, _ in parts])


@pytest.mark.parametrize("world", WORLDS)
def test_each_world_is_correct_and_only_rank_0_prints(worlds, world):
    done, _, _ = worlds[world]
    res = _ranks.result(done)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == world
    assert list(res)[-1] == "checks" and res["attempted"] >= 1
    assert set(res["metrics"]) == {"rows_per_s", "query_p95_ms", "setup_s"}
    assert done.stdout.count("portbench: plan ") == 1


@pytest.mark.parametrize("world", WORLDS)
def test_rows_are_the_sum_over_the_ranks(worlds, world):
    done, root, _ = worlds[world]
    counts = _concatenated(root, f"tiny_w{world}", world)[-1]
    if world > 1:                       # each rank draws its own partition
        cell = catalog.Benchmark(root).cell(f"tiny_w{world}")
        a, b = (harness.draw_rows(cell, cell.config, _ranks.SEED,
                                  torch.device("cpu"), r, world)[0]
                for r in (0, 1))
        assert a.shape != b.shape or not torch.equal(a, b)
    rows = int(re.search(r" rows=(\d+) ", done.stdout).group(1))
    assert rows == sum(counts)
    assert f"rows by rank {counts}" in done.stdout


@pytest.mark.parametrize("world", WORLDS)
def test_every_answer_is_one_process_groupby_agg_over_all_rows(worlds,
                                                               world):
    _, root, answers = worlds[world]
    values, keys, groups, cell, _ = _concatenated(root, f"tiny_w{world}",
                                                  world)
    aggs = [tuple(a) for a in cell.config["aggregates"]]
    one = harness.program_entry(torch.device("cpu"))(values, keys, groups,
                                                    aggs)
    want = json.dumps({k: v.numpy().tobytes().hex()
                       for k, v in sorted(one.items())})
    assert set(answers) == set(range(world))
    for rank, seen in answers.items():
        assert seen == [want], rank


def test_a_world_of_one_gives_the_one_process_check_numbers(worlds):
    done, root, _ = worlds[1]
    bench = catalog.Benchmark(root)
    one = cpu_run("q1_sf10", seed=_ranks.SEED, seconds=0.5, bench=bench,
                  scale={"orders": 2000})
    assert _ranks.result(done)["checks"] == one["checks"]


@pytest.fixture(scope="module")
def faults(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults")
    root = _ranks.bench_copy(tmp, {f"fault_{f}": (f, 2) for f in FAULTS})
    return {f: _ranks.run(root, f"fault_{f}") for f in FAULTS}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_is_not_correct(faults, fault):
    res = _ranks.result(faults[fault])
    assert res["correct"] is False
    n = res["checks"][FAULTS[fault]]
    assert n["value"] > n["limit"], res["checks"]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_a_hung_rank_ends_the_run_with_no_result_and_no_process(tmp_path):
    root = _ranks.bench_copy(tmp_path, {"hung": ("sleepy", 2)})
    done = _ranks.run(root, "hung", timeout_s=5.0)
    assert done.returncode == 5, done.stderr[-3000:]
    lines = done.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
    assert "every rank killed" in done.stderr
    pids = [int(p.read_text()) for p in (tmp_path / "out").glob("pid-*")]
    assert len(pids) == 2
    assert not any(_alive(p) for p in pids)
