"""``repro_torch.ops.calibrate`` and the measured planner against the JAX
package's ``repro.ops.calibrate``: the same fit and the same choices from
the same points, the cache's round trip and environment stamp, and the
port's own names — it never reads the JAX package's variables or file.

Every file goes under ``tmp_path`` and every variable through
``monkeypatch``; each test starts and ends with empty memos in both
packages, so no test sees another's cache.
"""
import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ops import calibrate as ref_cal  # noqa: E402
from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro.ops.plan import plan_groupby as ref_plan  # noqa: E402
from repro_torch.core.aggregates import (DEFAULT_CACHE_BYTES,  # noqa: E402
                                         table_bytes)
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.ops import calibrate as cal_mod  # noqa: E402
from repro_torch.ops import plan as plan_mod  # noqa: E402
from repro_torch.ops.partial import AggSignature  # noqa: E402
from repro_torch.ops.plan import plan_groupby  # noqa: E402

F32 = (RefSpec(dtype=jnp.float32, L=2), ReproSpec(dtype=torch.float32, L=2))
F64 = (RefSpec(dtype=jnp.float64, L=2), ReproSpec(dtype=torch.float64, L=2))
ENV_VARS = ("REPRO_CALIBRATION_CACHE", "REPRO_AUTOTUNE", cal_mod.CACHE_ENV,
            cal_mod.AUTOTUNE_ENV)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    cal_mod.clear_memo()
    ref_cal.clear_memo()
    yield
    cal_mod.clear_memo()
    ref_cal.clear_memo()


def _fake_measure(costs):
    def m(method, n, g, ncols, spec, backend="cpu"):
        return costs[method] * (1.0 + 0.1 * (g.bit_length() + ncols))
    return m


def _points(spec_key):
    """A cpu cache of every method the planner races on the CPU."""
    costs = {"scatter": 20.0, "sort": 24.0, "onehot": 3.0, "rsum": 9.0}
    pts = []
    for n, g, ncols in [(1 << 12, 1, 1), (1 << 12, 16, 1), (1 << 15, 16, 4),
                        (1 << 12, 1 << 10, 1), (1 << 15, 1 << 16, 2)]:
        for method, c in costs.items():
            if method == "onehot" and g > 1 << 12:
                continue
            if method == "rsum" and g != 1:
                continue
            pts.append({"backend": "cpu", "spec": spec_key,
                        "method": method, "n": n, "G": g, "ncols": ncols,
                        "ns_per_row": c * (1 + (g.bit_length() % 5) / 3)})
    return pts


def _both(spec_pair):
    """One JSON of points, read by both packages."""
    rspec, spec = spec_pair
    assert ref_cal.spec_key(rspec) == cal_mod.spec_key(spec)
    points = json.loads(json.dumps(_points(cal_mod.spec_key(spec))))
    return (ref_cal.Calibration(backend="cpu", points=tuple(points)),
            cal_mod.Calibration(backend="cpu", points=tuple(points)))


QUERIES = [(n, g, c) for n in (1000, 1 << 15, 10**6)
           for g in (1, 4, 64, 700, 1 << 14, 1 << 20) for c in (1, 3, 6)]


@pytest.mark.parametrize("pair", [F32, F64], ids=["f32", "f64"])
def test_fitted_cost_equals_reference(pair):
    rcal, cal = _both(pair)
    for method in ("scatter", "sort", "onehot", "rsum", "pallas"):
        for n, g, c in QUERIES:
            assert cal_mod.fitted_cost(cal, method, n, g, c, pair[1],
                                       backend="cpu") == \
                ref_cal.fitted_cost(rcal, method, n, g, c, pair[0],
                                    backend="cpu")


@pytest.mark.parametrize("pair", [F32, F64], ids=["f32", "f64"])
def test_measured_plans_equal_reference(pair):
    """Given the same points, both planners pick the same method with the
    same source, chunk, fan-out, cost and reason (measured where the fit
    covers the query, the cold model where it abstains)."""
    rcal, cal = _both(pair)
    sources = set()
    for n, g, c in QUERIES:
        for levels in (None, (0, 1)):
            a = ref_plan(n, g, pair[0], ncols=c, backend="cpu",
                         levels=levels, calibration=rcal)
            b = plan_groupby(n, g, pair[1], ncols=c, backend="cpu",
                             levels=levels, calibration=cal)
            assert (a.method, a.source, a.chunk, a.buckets, a.cost,
                    a.reason) == (b.method, b.source, b.chunk, b.buckets,
                                  b.cost, b.reason)
            sources.add(b.source)
    assert sources == {"measured", "model"}


def test_save_load_roundtrip_and_merge(tmp_path):
    path = str(tmp_path / "cal.json")
    spec = F32[1]
    cal = cal_mod.calibrate(spec, grid=[(1 << 12, 1, 1), (1 << 12, 16, 1)],
                            path=path, backend="cpu",
                            measure=_fake_measure({"scatter": 10.0,
                                                   "sort": 30.0,
                                                   "onehot": 500.0,
                                                   "rsum": 7.0}))
    assert {p["method"] for p in cal.points} == {"scatter", "sort", "onehot",
                                                 "rsum"}
    loaded = cal_mod.load(path)
    assert loaded is not None and loaded.points == cal.points
    with open(path) as fh:
        payload = json.load(fh)
    assert payload["version"] == cal_mod.VERSION
    assert payload["env"] == cal_mod.env_stamp("cpu")
    assert payload["env"]["torch_version"] == torch.__version__
    # exact at a grid point; the planner follows the measurements
    assert cal_mod.fitted_cost(cal, "scatter", 1 << 12, 16, 1, spec) == \
        cal.select(spec, "scatter")[1]["ns_per_row"]
    p = plan_groupby(10**5, 64, spec, backend="cpu", calibration=cal)
    assert p.method == "scatter" and p.source == "measured"
    assert "calibrated" in p.reason
    # a second backend's points survive a recalibration of the first
    cal_mod.calibrate(spec, grid=[(1 << 12, 16, 1)], path=path,
                      backend="cuda", methods=["pallas"],
                      measure=_fake_measure({"pallas": 0.5}))
    cal2 = cal_mod.calibrate(spec, grid=[(1 << 12, 64, 1)], path=path,
                             backend="cpu", methods=["scatter"],
                             measure=_fake_measure({"scatter": 5.0}))
    assert sorted(p["G"] for p in cal2.select(spec, "scatter", "cpu")) == \
        [1, 16, 64]
    assert len(cal2.select(spec, "pallas", "cuda")) == 1
    assert len(cal2.select(spec, "sort", "cpu")) == 2


def test_mismatched_stamp_is_refused(tmp_path, caplog):
    path = str(tmp_path / "cal.json")
    cal = cal_mod.Calibration(backend="cpu", points=(
        {"backend": "cpu", "spec": cal_mod.spec_key(F32[1]),
         "method": "scatter", "n": 4096, "G": 16, "ncols": 1,
         "ns_per_row": 10.0},))
    cal_mod.save(cal, path)
    assert cal_mod.load(path) is not None                  # stamp matches
    with open(path) as fh:
        payload = json.load(fh)
    for key, other in (("torch_version", "0.0.0-other"),
                       ("device", "another card")):
        changed = json.loads(json.dumps(payload))
        changed["env"][key] = other
        with open(path, "w") as fh:
            json.dump(changed, fh)
        trace.configure()
        try:
            caplog.clear()
            with caplog.at_level(logging.WARNING,
                                 logger="repro_torch.calibrate"):
                assert cal_mod.load(path) is None          # refused
            events = [r for r in trace.events()
                      if r["name"] == "calibrate.cache_mismatch"]
        finally:
            trace.disable()
        assert any("calibration cache" in m for m in caplog.messages)
        assert events and events[-1]["attrs"]["mismatch"] == [key]
        assert cal_mod.load(path, check_env=False) is not None  # opt-out
    del payload["env"]                                     # no stamp at all
    with open(path, "w") as fh:
        json.dump(payload, fh)
    assert cal_mod.load(path) is None


def test_port_ignores_the_reference_variables_and_file(tmp_path,
                                                       monkeypatch):
    """A JAX-package cache under the JAX package's variable and default
    file name, with its autotune switch on: the port reads nothing,
    calibrates nothing, and plans from its cold-start model."""
    rspec, spec = F32
    rcal = ref_cal.Calibration(backend="cpu", points=tuple(
        _points(ref_cal.spec_key(rspec))))
    ref_path = str(tmp_path / "ref_cache.json")
    ref_cal.save(rcal, ref_path)
    ref_cal.save(rcal, str(tmp_path / ref_cal.DEFAULT_CACHE_PATH))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_CALIBRATION_CACHE", ref_path)
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")

    def refuse(*args, **kwargs):
        raise AssertionError("the port calibrated")

    monkeypatch.setattr(cal_mod, "calibrate", refuse)
    monkeypatch.setattr(cal_mod, "measure_point", refuse)
    assert cal_mod.cache_path() == cal_mod.DEFAULT_CACHE_PATH
    assert cal_mod.load() is None
    assert cal_mod.for_planner(spec, "cpu") is None
    for n, g, c in QUERIES:
        p = plan_groupby(n, g, spec, ncols=c, backend="cpu")
        assert p.source == "model"
        assert p == plan_groupby(n, g, spec, ncols=c, backend="cpu",
                                 calibration=None)
    # the JAX package itself does read its cache here
    assert ref_cal.for_planner(rspec, "cpu") is not None
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["ref_cache.json", ref_cal.DEFAULT_CACHE_PATH])


def test_for_planner_autotunes_under_the_port_variables(tmp_path,
                                                        monkeypatch):
    """``REPRO_TORCH_AUTOTUNE=1`` calibrates each uncovered spec once, into
    ``REPRO_TORCH_CALIBRATION_CACHE``; ``calibration=None`` still pins the
    cold-start model."""
    path = str(tmp_path / "cal.json")
    monkeypatch.setenv(cal_mod.CACHE_ENV, path)
    monkeypatch.setenv(cal_mod.AUTOTUNE_ENV, "1")
    f32, f64 = F32[1], F64[1]
    cal_mod.calibrate(f32, grid=[(1 << 12, 16, 1)], backend="cpu",
                      methods=["scatter", "sort"],
                      measure=_fake_measure({"scatter": 1.0, "sort": 2.0}))
    calls = []
    real = cal_mod.calibrate

    def fake_calibrate(spec, backend="cpu", quick=True):
        calls.append(cal_mod.spec_key(spec))
        return real(spec, grid=[(1 << 12, 16, 1)], backend=backend,
                    methods=["scatter", "sort"],
                    measure=_fake_measure({"scatter": 9.0, "sort": 2.0}))

    monkeypatch.setattr(cal_mod, "calibrate", fake_calibrate)
    assert cal_mod.for_planner(f32, "cpu") is not None
    assert calls == []                          # f32 covered: no re-run
    p = plan_groupby(10**4, 16, f64, backend="cpu")
    assert calls == [cal_mod.spec_key(f64)]     # f64 autotuned on first use
    assert p.source == "measured" and p.method == "sort"
    assert plan_groupby(10**4, 16, f64, backend="cpu",
                        calibration=None).source == "model"
    cal = cal_mod.load()
    assert cal.select(f32, "scatter") and cal.select(f64, "sort")
    assert sorted(q.name for q in tmp_path.iterdir()) == ["cal.json"]


def test_measure_point_and_calibrate_on_the_cpu(tmp_path):
    """Real measurements at tiny shapes: every CPU method (the segment
    kernel only on the card; rsum only at G == 1), positive ns per row."""
    spec = F32[1]
    with pytest.raises(ValueError):
        cal_mod.measure_point("scatter", 64, 4, 1, spec, backend="tpu")
    cal = cal_mod.calibrate(spec, grid=[(256, 1, 1), (256, 4, 2)],
                            backend="cpu", path=str(tmp_path / "c.json"),
                            save_cache=False)
    got = sorted((p["method"], p["G"]) for p in cal.points)
    assert got == [("onehot", 1), ("onehot", 4), ("rsum", 1),
                   ("scatter", 1), ("scatter", 4), ("sort", 1), ("sort", 4)]
    assert all(p["ns_per_row"] > 0 and p["backend"] == "cpu"
               for p in cal.points)
    assert not (tmp_path / "c.json").exists()
    assert cal_mod.default_grid(True, "cpu") == [
        tuple(p) for p in ref_cal.default_grid(True)]


def test_calibration_defaults_to_the_card(tmp_path, monkeypatch):
    """``calibrate`` and its helpers price the card unless asked for the
    CPU; without a card, measuring raises instead of timing the CPU."""
    monkeypatch.chdir(tmp_path)
    assert cal_mod.default_grid() == cal_mod.default_grid(True, "cuda")
    assert cal_mod.default_grid()[0][0] == 1 << 26          # TPC-H SF10 rows
    assert cal_mod.env_stamp()["backend"] == "cuda"
    seen = []

    def measure(method, n, g, ncols, spec, backend):
        seen.append(backend)
        return 1.0

    cal = cal_mod.calibrate(F32[1], grid=[(1 << 12, 1, 1)],
                            methods=["scatter"], measure=measure)
    assert seen == ["cuda"] and cal.backend == "cuda"
    assert cal_mod.load().points == cal.points
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        cal_mod.DEFAULT_CACHE_PATH]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cal_mod.measure_point("scatter", 64, 4, 1, F32[1])


def _cold_points(model, spec, grid, spill=1.0):
    """Points made by the cold-start formula from ``model``'s constants;
    scatter's out-of-cache points multiplied by ``spill``."""
    pts = []
    for method, c in model.items():
        for n, g, ncols in grid:
            if method == "rsum" and g != 1:
                continue
            ns = sum(a * f for a, f in zip(
                c, cal_mod.cold_features(method, g, ncols, spec.L)))
            if method == "scatter" and table_bytes(
                    g, ncols, spec) > DEFAULT_CACHE_BYTES:
                ns *= spill
            pts.append({"backend": "cuda", "spec": cal_mod.spec_key(spec),
                        "method": method, "n": n, "G": g, "ncols": ncols,
                        "ns_per_row": ns})
    return pts


def test_cold_model_fit_reproduces_its_points():
    """``fit_cold_model`` recovers the constants that made points through
    ``cold_features``, and the planner's ``_cuda_costs`` with the fitted
    constants gives each point back: the fit and the planner read one
    formula.  Scatter's spilled points stay out of the fit."""
    spec = F32[1]
    truth = {"scatter": (0.01, 0.03, 0.5, 0.1),
             "sort": (0.02, 0.01, 0.7, 0.09),
             "onehot": (0.002, 0.03, 0.02), "pallas": (0.004, 0.0006),
             "rsum": (0.003, 0.0004)}
    grid = cal_mod.default_grid(True, "cuda") + [(1 << 26, 1 << 21, 4)]
    points = _cold_points(truth, spec, grid, spill=7.0)
    fit = cal_mod.fit_cold_model(
        cal_mod.Calibration(backend="cuda", points=tuple(points)), spec)
    assert fit.keys() == truth.keys()
    for method, c in truth.items():
        np.testing.assert_allclose(fit[method], c, rtol=1e-9)
    tiled = 0
    for p in points:
        in_cache = table_bytes(p["G"], p["ncols"], spec) <= DEFAULT_CACHE_BYTES
        want = p["ns_per_row"]
        if p["method"] == "scatter" and not in_cache:
            want *= plan_mod._SPILL_FACTOR / 7.0
        got = plan_mod._cuda_costs(p["G"], p["ncols"], spec.L, in_cache,
                                   [p["method"]], model=fit)
        assert got[p["method"]] == pytest.approx(want, rel=1e-9)
        tiled += p["method"] == "pallas" and cal_mod.cold_features(
            "pallas", p["G"], p["ncols"], spec.L)[0] > 1
    assert tiled                        # the grid reaches the tiled path
    # a cost that falls with the columns is fitted as flat, never negative
    flat = cal_mod.fit_cold_model(cal_mod.Calibration(
        backend="cuda", points=tuple(
            {"backend": "cuda", "spec": cal_mod.spec_key(spec),
             "method": "rsum", "n": 1 << 26, "G": 1, "ncols": c,
             "ns_per_row": y} for c, y in ((1, 1.0), (4, 0.8)))), spec)
    assert flat["rsum"][1] == 0.0 and 0.8 < flat["rsum"][0] < 1.0


def test_cold_model_keeps_the_kernels_on_the_main_path():
    """The committed H100 constants plan the segment kernel for Q1 at TPC-H
    SF10 and the flat kernel at G = 1, as measured on the card."""
    spec = F32[1]
    n = 59_986_052
    q1 = AggSignature.build(
        [("sum", 0), ("sum", 1), ("sum_prod", 1, 2), ("mean", 0),
         ("mean", 1), ("mean", 3), ("var", 1), ("count",), ("min", 0),
         ("max", 1)], 4, spec).ncols
    assert plan_groupby(n, 4, spec, ncols=q1, backend="cuda",
                        calibration=None).method == "pallas"
    assert plan_groupby(n, 1, spec, ncols=4, backend="cuda",
                        calibration=None).method == "rsum"
    assert set(plan_mod._CUDA_COLD) == set(cal_mod.COLD_METHODS)
