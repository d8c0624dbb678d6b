"""Everything ``BENCHMARK.json`` names loads by its name, the file keeps to
the benchmark's contract, and a new configuration, mix and metric are found
without editing any file that is there."""
import hashlib
import json
import re
import shutil

import pytest

pytest.importorskip("torch")

from portbench.tests._cpu import ROOT, TINY, cpu_run  # noqa: E402
from portbench import catalog, checks, traffic  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_named_configuration_mix_and_metric_loads():
    b = catalog.Benchmark(ROOT)
    for c in b.spec["configs"]:
        cfg = b.config(c["name"])
        assert cfg["name"] == c["name"]
        assert callable(b.generator(cfg).draw)
        assert callable(b.reference(cfg).results)
        assert set(cfg["limits"]) == set(checks.NAMES)
        for key in c["reduced"]:
            assert key in cfg, f"{key} is reduced but not stated"
    for w in b.spec["workloads"]:
        cell = b.cell(w["name"])
        traffic.validate(cell.traffic)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(b.reader(m["name"]).read)
    for m in b.spec["end_to_end"] + b.spec["per_layer"]:
        assert callable(b.reader(m["name"]).read)


def test_benchmark_json_keeps_to_the_contract():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert spec["command"] == ["python3", "portbench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    cfgs = {c["name"]: c for c in spec["configs"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    used = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
    assert {w["config"] for w in spec["workloads"]} == set(cfgs)
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in spec[k]]
    assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_no_calibration_cache_is_ever_present():
    from portbench.run import CALIBRATION_CACHE
    assert CALIBRATION_CACHE.parent == ROOT / "portbench"
    assert not CALIBRATION_CACHE.exists()


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_configuration_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = _spec()
    before = _digests(tmp_path)
    cfg = json.loads((ROOT / "portbench/configs/tpch_sf10_q18.json")
                     .read_text())
    cfg.update(name="tpch_sf1_q18", orders=1_500_000,
               limits={"max_err_ulp": 0, "window_diff": 0, "perm_diff": 0})
    (tmp_path / "portbench/configs/tpch_sf1_q18.json").write_text(
        json.dumps(cfg))
    (tmp_path / "portbench/traffic/scanned.json").write_text(json.dumps(
        {"loop": "closed", "sessions": 1, "row_order": "permuted"}))
    (tmp_path / "portbench/metrics/queries_done.py").write_text(
        "def read(run):\n    return len(run.latencies_s)\n")
    spec["configs"].append({"name": "tpch_sf1_q18", "source": "TPC-H",
                            "file": "portbench/configs/tpch_sf1_q18.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "q18_sf1_scanned",
                              "config": "tpch_sf1_q18",
                              "traffic": "scanned", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "queries_done", "unit": "queries",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["q18_sf1_scanned"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())

    bench = catalog.Benchmark(tmp_path)
    cell = bench.cell("q18_sf1_scanned")
    assert cell.config["orders"] == 1_500_000
    assert cell.traffic["row_order"] == "permuted"
    assert [m["name"] for m in cell.end_to_end][-1] == "queries_done"
    res = cpu_run("q18_sf1_scanned", bench=bench)
    assert res["metrics"]["queries_done"]["value"] == res["attempted"]
    assert res["correct"] is True


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        catalog.Benchmark(ROOT).cell("no_such_cell")
    assert TINY["orders"] < 10_000
