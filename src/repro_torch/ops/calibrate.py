"""Measured autotuner: microbenchmarked per-row costs for the planner.

The paper's batch-size/cache balancing (§V-C) is machine-dependent, and
hand-set cost constants drift from the hardware actually running the query.
This module replaces guessing with measurement:

* :func:`calibrate` runs each strategy over a small grid of (n, G, ncols)
  shapes, records the median per-row time, and persists the points to a
  JSON cache (``.repro_torch_calibration.json`` in the working directory by
  default, overridable via ``REPRO_TORCH_CALIBRATION_CACHE``; the file is
  machine-local and git-ignored);
* :func:`fitted_cost` interpolates a strategy's per-row cost at an arbitrary
  (n, G, ncols) by inverse-distance weighting in log2-space — exact at the
  measured points, smooth between them;
* :func:`for_planner` is the lazy hook :func:`repro_torch.ops.plan.
  plan_groupby` consults: it loads the cache if one exists, and — only when
  ``REPRO_TORCH_AUTOTUNE=1`` — runs a quick calibration on first use.  The
  planner's cold-start constants stay the model when no cache exists, so
  importing this module never costs anything;
* :func:`cold_features` is the form of the planner's cold-start model on
  the card, and :func:`fit_cold_model` fits its constants to measured
  points.

The backend is ``"cuda"`` (CUDA events around synchronized launches on the
card; the default) or ``"cpu"`` (host clock).  The names, the variables and the cache
file are this package's own: a cache of the JAX package prices other code
and is never read.  Calibration never affects results: every strategy
returns bit-identical tables, so a stale or wrong cache can only cost
throughput.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import statistics
import time

import numpy as np
import torch

from repro_torch.core.aggregates import (DEFAULT_CACHE_BYTES, segment_table,
                                         table_bytes)
from repro_torch.core.types import ReproSpec, dtype_name
from repro_torch.device import resolve_device
from repro_torch.kernels.segment_rsum.ops import group_limits, group_tile
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = [
    "Calibration", "CACHE_ENV", "AUTOTUNE_ENV", "DEFAULT_CACHE_PATH",
    "cache_path", "spec_key", "load", "save", "measure_point",
    "default_grid", "calibrate", "fitted_cost", "for_planner",
    "clear_memo", "env_stamp", "cold_features", "fit_cold_model",
]

log = logging.getLogger("repro_torch.calibrate")

CACHE_ENV = "REPRO_TORCH_CALIBRATION_CACHE"
AUTOTUNE_ENV = "REPRO_TORCH_AUTOTUNE"
DEFAULT_CACHE_PATH = ".repro_torch_calibration.json"
VERSION = 1
BACKENDS = ("cuda", "cpu")

# onehot materializes (block, G+1) one-hots; measuring it beyond this group
# count would dominate calibration time for a method the planner would never
# pick there anyway.  (The segment kernel is no one-hot on the card, so it
# is measured at every G.)
_ONEHOT_G_CAP = 1 << 12


def cache_path(path: str | None = None) -> str:
    return path or os.environ.get(CACHE_ENV) or DEFAULT_CACHE_PATH


def _device_name(backend: str) -> str:
    if backend != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "no CUDA device"


def env_stamp(backend: str = "cuda") -> dict:
    """Provenance stamped into the cache at save time.  A cache calibrated
    under another torch or CUDA version, or on another device, prices code
    or hardware that is not running here — :func:`load` refuses it (with a
    logged warning event) and the planner falls back to the cold-start
    model.  ``backend`` is the most recent calibration's: points carry
    their own, and the planner filters on it."""
    return {"backend": backend, "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": _device_name(backend)}


def spec_key(spec: ReproSpec) -> str:
    return f"{dtype_name(spec.dtype)}/L{spec.L}/W{spec.W}"


@dataclasses.dataclass(frozen=True)
class Calibration:
    """A set of measured (backend, spec, method, n, G, ncols) -> ns/row
    points.  ``backend`` is the backend of the *most recent* calibration;
    points carry their own so one cache file serves cpu and cuda use."""

    backend: str
    points: tuple  # of dicts: {backend, spec, method, n, G, ncols, ns_per_row}
    version: int = VERSION

    def select(self, spec: ReproSpec, method: str,
               backend: str | None = None):
        key = spec_key(spec)
        return [p for p in self.points
                if p["spec"] == key and p["method"] == method
                and (backend is None or p.get("backend", self.backend)
                     == backend)]


def save(cal: Calibration, path: str | None = None) -> str:
    path = cache_path(path)
    payload = {"version": cal.version, "backend": cal.backend,
               "env": env_stamp(cal.backend), "points": list(cal.points)}
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1)
    os.replace(tmp, path)
    clear_memo()
    return path


_STAMP_KEYS = ("torch_version", "cuda_version", "device")


def load(path: str | None = None,
         check_env: bool = True) -> Calibration | None:
    path = cache_path(path)
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return None
    if payload.get("version") != VERSION:
        return None
    backend = payload.get("backend", "unknown")
    if check_env:
        stamp = payload.get("env")
        want = env_stamp(backend)
        mismatch = ([k for k in _STAMP_KEYS if stamp.get(k) != want[k]]
                    if stamp is not None else ["missing env stamp"])
        if mismatch:
            log.warning(
                "ignoring calibration cache %s: environment mismatch on %s "
                "(cached %s, running %s) — planner falls back to cold-start "
                "costs; rerun calibration (%s=1) to refresh",
                path, mismatch, stamp, want, AUTOTUNE_ENV)
            obs_trace.event("calibrate.cache_mismatch", path=path,
                            mismatch=mismatch, cached=stamp, running=want)
            obs_metrics.counter("repro_calibration_cache_rejected_total").inc()
            return None
    points = tuple({"backend": backend, **p}
                   for p in payload.get("points", ()))
    return Calibration(backend=backend, points=points)


_memo: dict = {}


def clear_memo() -> None:
    """Drop the per-process load/autotune memo (tests, cache rewrites)."""
    _memo.clear()


def _median_ms(fn, backend: str, iters: int) -> float:
    """Median time of one call of ``fn`` in ms, after a warm-up call: CUDA
    events around a synchronized launch on the card, the host clock on the
    CPU."""
    fn()
    times = []
    for _ in range(iters):
        if backend == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure_point(method: str, n: int, num_segments: int, ncols: int,
                  spec: ReproSpec, backend: str = "cuda",
                  iters: int = 3) -> float:
    """Median ns/row of one strategy on one synthetic shape, data made on
    the backend's device from a fixed seed."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = resolve_device(backend)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    vals = torch.rand((n, ncols), generator=gen, device=dev,
                      dtype=spec.dtype)
    ids = torch.randint(0, num_segments, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    ms = _median_ms(lambda: segment_table(vals, ids, num_segments, spec,
                                          method=method, device=dev),
                    backend, iters)
    return ms / n * 1e6


def default_grid(quick: bool = True, backend: str = "cuda"):
    """(n, G, ncols) shapes to measure.  Small on purpose: calibration cost
    is paid once per machine, but 'once' should still be seconds.  On the
    card, rows are those of TPC-H's lineitem at scale factor 10 (2^26, about
    60 million), the size the main path runs: at 2^24 a call's fixed host
    and launch cost was most of what the kernels' points measured."""
    n = 1 << (26 if backend == "cuda" else 15)
    if quick:
        return [(n, 1, 1), (n, 1, 4), (n, 1 << 4, 1), (n, 1 << 10, 1),
                (n, 1 << 16, 1), (n, 1 << 10, 4)]
    return [(rows, g, c)
            for rows in (n, n << 3)
            for g in (1, 1 << 4, 1 << 10, 1 << 16, 1 << 20)
            for c in (1, 4)]


def calibrate(spec: ReproSpec | None = None, methods=None, grid=None,
              backend: str = "cuda", path: str | None = None,
              save_cache: bool = True, quick: bool = True,
              measure=measure_point) -> Calibration:
    """Microbenchmark the strategies and (optionally) persist the points.

    Merges with any existing cache (same-key points are replaced), so
    successive calibrations of different specs or backends accumulate.
    ``measure(method, n, G, ncols, spec, backend=...)`` is injectable for
    tests.
    """
    spec = spec or ReproSpec()
    if methods is None:
        methods = ["scatter", "sort", "onehot"]
        if backend == "cuda" and spec.m <= 30:
            methods.append("pallas")
        if spec.m <= 30:
            methods.append("rsum")      # measured only at its G == 1 shapes
    grid = list(grid if grid is not None else default_grid(quick, backend))
    key = spec_key(spec)
    points = []
    with obs_trace.span("calibrate", backend=backend, spec=key,
                        methods=list(methods), grid_points=len(grid)):
        for method in methods:
            for n, g, ncols in grid:
                if method == "onehot" and g > _ONEHOT_G_CAP:
                    continue
                if method == "rsum" and g != 1:
                    continue            # the flat kernel only exists at G==1
                with obs_trace.span("calibrate.measure", method=method,
                                    n=n, G=g, ncols=ncols):
                    ns = measure(method, n, g, ncols, spec, backend=backend)
                points.append({"backend": backend, "spec": key,
                               "method": method, "n": n, "G": g,
                               "ncols": ncols, "ns_per_row": float(ns)})
    obs_metrics.counter("repro_calibration_points_total").inc(len(points))
    prior = load(path)
    if prior is not None:
        # merge: replace same-key points, keep everything else — including
        # other backends' measurements, which must survive a recalibration
        # on this one
        full_key = ("backend", "spec", "method", "n", "G", "ncols")
        fresh = {tuple(p[k] for k in full_key) for p in points}
        points = [p for p in prior.points
                  if tuple(p[k] for k in full_key) not in fresh] + points
    cal = Calibration(backend=backend, points=tuple(points))
    if save_cache:
        save(cal, path)
    return cal


# max extrapolation in G beyond the measured envelope, per method: flat
# IDW extrapolation is harmless for methods whose per-row cost is ~G-free
# (scatter/sort) but badly wrong for the G-dependent paths (onehot's dense
# one-hot, the segment kernel's group tiles) — those get no margin at all
_COVERAGE_MARGIN = {"onehot": 1, "pallas": 1, "rsum": 1}
_DEFAULT_MARGIN = 4


def fitted_cost(cal: Calibration, method: str, n: int, num_segments: int,
                ncols: int, spec: ReproSpec,
                backend: str | None = None) -> float | None:
    """Interpolated per-row cost (ns) at (n, G, ncols), or None if the cache
    has no points for this (backend, spec, method) or the query lies
    outside the measured group-count envelope for the method.

    Inverse-square-distance weighting in (log2 n, log2 G, log2 ncols): exact
    at measured points, smooth between them.  Beyond the per-method envelope
    the fit abstains and the planner falls back to the cold model, whose G
    terms are explicit.
    """
    pts = cal.select(spec, method, backend)
    if not pts:
        return None
    margin = _COVERAGE_MARGIN.get(method, _DEFAULT_MARGIN)
    if num_segments > margin * max(p["G"] for p in pts):
        return None
    q = np.array([np.log2(max(n, 1)), np.log2(max(num_segments, 1)),
                  np.log2(max(ncols, 1))])
    w_sum = c_sum = 0.0
    for p in pts:
        f = np.array([np.log2(p["n"]), np.log2(p["G"]),
                      np.log2(max(p["ncols"], 1))])
        d2 = float(np.sum((q - f) ** 2))
        if d2 < 1e-12:
            return float(p["ns_per_row"])
        w = 1.0 / d2
        w_sum += w
        c_sum += w * p["ns_per_row"]
    return c_sum / w_sum


def for_planner(spec: ReproSpec, backend: str) -> Calibration | None:
    """The planner's lazy calibration source (memoized per process).

    Loads the persisted cache when present; when it holds no points for
    this (backend, spec) and ``REPRO_TORCH_AUTOTUNE`` is truthy, runs a
    quick calibration for *this* spec on first use and merges it into the
    cache (opt-in, so tests and cold runs never pay or depend on it).
    Memoized per (cache, backend, spec) so a second spec in the same
    process still gets its first-use calibration.
    """
    memo_key = (cache_path(), backend, spec_key(spec))
    if memo_key in _memo:
        return _memo[memo_key]
    cal = load()
    covered = cal is not None and any(
        p.get("backend", cal.backend) == backend
        and p["spec"] == spec_key(spec) for p in cal.points)
    if not covered and os.environ.get(AUTOTUNE_ENV, "") not in ("", "0"):
        cal = calibrate(spec, backend=backend, quick=True)
    if cal is not None and not any(
            p.get("backend", cal.backend) == backend for p in cal.points):
        cal = None          # cache exists but has no points for this backend
    _memo[memo_key] = cal
    return cal


# ---------------------------------------------------------------------------
# the card's cold-start model: its form, and its fit to measured points
# ---------------------------------------------------------------------------

COLD_METHODS = ("scatter", "sort", "onehot", "pallas", "rsum")


def _group_tiles(num_segments: int, ncols: int, nlev: int) -> int:
    """Group tiles of one segment kernel launch (1 on the private path)."""
    if num_segments <= group_limits(ncols, nlev)[0]:
        return 1
    return -(-num_segments // group_tile(num_segments, ncols, nlev))


def cold_features(method: str, num_segments: int, ncols: int,
                  nlev: int) -> tuple:
    """The features of the planner's cold-start model on the card: a
    strategy's ns per row (its table in cache) is ``sum(c * f)`` over its
    constants ``c`` and these ``f``.  Every strategy pays a fixed cost per
    row and one per column-level (``w = ncols * nlev``).  Scatter and sort
    pay both again for int64 atomics that contend on few groups, a part
    that falls as ``G ** -1/4``; onehot pays per group and row (building
    the one-hot, whatever the columns); the segment kernel pays once per
    group tile (one tile on its private path)."""
    w = float(max(int(ncols), 1) * nlev)
    if method in ("scatter", "sort"):
        q = float(num_segments) ** -0.25
        return (1.0, w, q, q * w)
    if method == "onehot":
        return (1.0, w, float(num_segments))
    if method == "pallas":
        t = float(_group_tiles(num_segments, ncols, nlev))
        return (t, t * w)
    return (1.0, w)


def _fit_nonneg(A: np.ndarray, y: np.ndarray) -> tuple:
    """Least squares in relative error with non-negative constants: refit
    without the most negative constant until none is negative."""
    A = A / y[:, None]
    keep = list(range(A.shape[1]))
    c = np.zeros(0)
    while keep:
        c = np.linalg.lstsq(A[:, keep], np.ones(len(y)), rcond=None)[0]
        if (c >= 0).all():
            break
        keep.pop(int(np.argmin(c)))
    out = np.zeros(A.shape[1])
    out[keep] = c
    return tuple(float(x) for x in out)


def fit_cold_model(cal: Calibration, spec: ReproSpec,
                   backend: str = "cuda") -> dict:
    """The cold-start model's constants ``{method: (c, ...)}`` fitted to
    the (backend, spec) points of ``cal``: for each strategy with points,
    the least-squares fit of :func:`cold_features` in relative error.
    Points are measured over all ``spec.L`` levels; scatter's points whose
    table leaves the cache are left out (the spill factor is not fitted)."""
    model = {}
    for method in COLD_METHODS:
        pts = [p for p in cal.select(spec, method, backend)
               if method != "scatter" or table_bytes(
                   p["G"], p["ncols"], spec) <= DEFAULT_CACHE_BYTES]
        if pts:
            A = np.array([cold_features(method, p["G"], p["ncols"], spec.L)
                          for p in pts])
            y = np.array([p["ns_per_row"] for p in pts])
            model[method] = _fit_nonneg(A, y)
    return model
