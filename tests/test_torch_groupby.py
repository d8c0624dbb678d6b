"""``repro_torch.ops.groupby_agg`` against ``repro.ops.groupby_agg``, bit
for bit, across method x row permutation x chunk; the planner on the CPU;
signatures; the device rule; and MIN/MAX on signed zeros and NaN.

Inputs stay inside the finite contract (no square overflows float32), where
every strategy of the reference agrees with every other.  Each reference
result is computed once per dataset, over the full level window (the
reference proves pruned and unpruned tables bit-identical, and skipping its
prescan keeps these tests cheap), and every port variant — prescan on — is
held to it.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro.ops import groupby_agg as ref_groupby  # noqa: E402
from repro.ops import partial as ref_partial  # noqa: E402
from repro.ops.plan import plan_groupby as ref_plan  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.obs.fingerprint import (fingerprint_results,  # noqa: E402
                                         fingerprint_table)
from repro_torch.ops import groupby_agg  # noqa: E402
from repro_torch.ops import partial as port_partial  # noqa: E402
from repro_torch.ops.plan import METHODS, plan_groupby  # noqa: E402

ALL_AGGS = [("sum", 0), ("count",), ("mean", 0), ("var", 1), ("std", 1),
            ("sum_prod", 0, 1), ("min", 0), ("max", 1)]
Q1_AGGS = [("sum", 0), ("sum", 1), ("sum_prod", 1, 2), ("mean", 0),
           ("mean", 1), ("mean", 3), ("var", 1), ("count",), ("min", 0),
           ("max", 1)]
MERGE_AGGS = ("sum", "count", "mean", "var", "min", "max", ("sum", 1))
F32 = (RefSpec(dtype=jnp.float32, L=2), ReproSpec(dtype=torch.float32, L=2))


def _groupby_data(n, g, seed):
    """tests/test_groupby_agg.py's inputs: heavy-tailed and lognormal."""
    rng = np.random.default_rng(seed)
    vals = np.stack([
        rng.standard_normal(n) * np.exp(rng.standard_normal(n) * 2),
        rng.lognormal(1.0, 1.5, n),
    ], axis=1).astype(np.float32)
    return vals, rng.integers(0, g, n).astype(np.int32)


def _merge_data(n, seed):
    """tests/test_partial_merge.py's inputs: magnitudes 2^-60..2^60."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(-2.0, 2.0, (n, 2))
    exp = rng.integers(-60, 61, (n, 2))
    return (mant * 2.0 ** exp).astype(np.float32), \
        rng.integers(0, 4, n).astype(np.int32)


def _q1_data(n, g, seed):
    """examples/groupby_analytics.py's Q1-shaped lineitem columns."""
    rng = np.random.default_rng(seed)
    qty = (rng.integers(1, 51, n) + rng.standard_normal(n) * 1e-3)
    price = rng.lognormal(7, 1.5, n)
    disc = rng.random(n) * 0.1
    table = np.stack([qty, price, 1.0 - disc, disc], axis=1)
    return table.astype(np.float32), rng.integers(0, g, n).astype(np.int32)


DATASETS = {
    "groupby": (lambda: _groupby_data(4097, 33, seed=1), 33, ALL_AGGS),
    "merge": (lambda: _merge_data(48, seed=5), 4, MERGE_AGGS),
    "q1": (lambda: _q1_data(20_000, 6, seed=1), 6, Q1_AGGS),
    "flat": (lambda: _groupby_data(4097, 1, seed=3), 1, ALL_AGGS),
}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(values, keys, G, aggs, reference results, reference table)."""
    make, g, aggs = DATASETS[name]
    vals, keys = make()
    res, tab = ref_groupby(vals, keys, g, aggs, F32[0], method="onehot",
                           return_table=True, levels=None)
    return vals, keys, g, aggs, {k: np.asarray(v) for k, v in res.items()}, \
        tuple(np.asarray(x) for x in tab)


def _assert_results(ref, got, what):
    assert list(ref) == list(got), what
    for key in ref:
        a, b = ref[key], got[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, key)
        assert a.tobytes() == b.tobytes(), (what, key)


def _assert_table(ref, got, what):
    for a, b in zip(ref, got):
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("dataset", ["groupby", "merge", "q1"])
@pytest.mark.parametrize("method", [m for m in METHODS if m != "rsum"]
                         + ["auto"])
def test_groupby_bitwise_across_method_permutation_chunk(method, dataset):
    vals, keys, g, aggs, ref, ref_tab = _reference(dataset)
    perm = np.random.default_rng(7).permutation(len(keys))
    for order in (np.arange(len(keys)), perm):
        for chunk in (None, 64, 1024):
            got, tab = groupby_agg(vals[order], keys[order], g, aggs, F32[1],
                                   method=method, chunk=chunk,
                                   return_table=True, device="cpu")
            what = f"{dataset} {method} chunk={chunk}"
            _assert_results(ref, got, what)
            _assert_table(ref_tab, tab, what)


def test_flat_groupby_through_rsum_matches_reference():
    """G == 1 (SQL aggregates without GROUP BY): every method, rsum
    included, gives the reference's bytes."""
    vals, keys, g, aggs, ref, ref_tab = _reference("flat")
    perm = np.random.default_rng(8).permutation(len(keys))
    for method in METHODS + ("auto",):
        got, tab = groupby_agg(vals[perm], keys[perm], g, aggs, F32[1],
                               method=method, return_table=True,
                               device="cpu")
        _assert_results(ref, got, method)
        _assert_table(ref_tab, tab, method)


def test_q1_digests_match_reference_layout():
    """Port digests equal digests of the reference's arrays under the JAX
    package's fingerprint layout: results compare as strings."""
    from repro.core.accumulator import ReproAcc as RefAcc
    from repro.obs.fingerprint import fingerprint_results as ref_fp
    from repro.obs.fingerprint import fingerprint_table as ref_fpt
    vals, keys, g, aggs, ref, ref_tab = _reference("q1")
    got, tab = groupby_agg(vals, keys, g, aggs, F32[1], return_table=True,
                           device="cpu")
    assert fingerprint_results(got) == ref_fp(ref)
    assert fingerprint_table(tab, F32[1]) == ref_fpt(RefAcc(*ref_tab), F32[0])


def test_float64_groupby_matches_reference():
    rspec, spec = RefSpec(dtype=jnp.float64, L=2), \
        ReproSpec(dtype=torch.float64, L=2)
    vals, keys = _groupby_data(2000, 9, seed=4)
    vals = vals.astype(np.float64) * np.pi
    ref = ref_groupby(vals, keys, 9, ALL_AGGS, rspec, method="onehot",
                      levels=None)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for method in ("scatter", "onehot", "sort", "auto"):
        _assert_results(ref, groupby_agg(vals, keys, 9, ALL_AGGS, spec,
                                         method=method, device="cpu"), method)
    with pytest.raises(ValueError, match="float32"):
        groupby_agg(vals, keys, 9, ALL_AGGS, spec, method="pallas",
                    device="cpu")


def test_level_window_requests_change_no_bits():
    vals, keys, g, aggs, ref, _ = _reference("groupby")
    for levels in (None, (0, 2), "auto"):
        for method in ("scatter", "pallas"):
            _assert_results(ref, groupby_agg(vals, keys, g, aggs, F32[1],
                                             method=method, levels=levels,
                                             device="cpu"),
                            f"{method} {levels}")


def test_planner_matches_reference_on_cpu():
    """On backend 'cpu' with the cold-start model both packages choose the
    same strategy, chunk and fan-out, for the same stated reason."""
    for spec_args in ((jnp.float32, torch.float32, 2, None),
                      (jnp.float32, torch.float32, 3, 12),
                      (jnp.float64, torch.float64, 2, None)):
        rspec = RefSpec(dtype=spec_args[0], L=spec_args[2], W=spec_args[3])
        spec = ReproSpec(dtype=spec_args[1], L=spec_args[2], W=spec_args[3])
        for n in (1_000, 10**6):
            for g in (1, 4, 64, 700, 1 << 14, 1 << 20):
                for ncols in (1, 6):
                    for levels in (None, (0, 1), (1, spec.L)):
                        a = ref_plan(n, g, rspec, ncols=ncols, backend="cpu",
                                     levels=levels, calibration=None)
                        b = plan_groupby(n, g, spec, ncols=ncols,
                                         backend="cpu", levels=levels,
                                         calibration=None)
                        assert (a.method, a.chunk, a.buckets, a.cost,
                                a.reason) == (b.method, b.chunk, b.buckets,
                                              b.cost, b.reason)
                        for m in ("onehot", "scatter", "sort", "radix",
                                  "pallas"):
                            a = ref_plan(n, g, rspec, ncols=ncols,
                                         method=m, levels=levels)
                            b = plan_groupby(n, g, spec, ncols=ncols,
                                             method=m, levels=levels)
                            assert (a.method, a.chunk, a.buckets) == \
                                (b.method, b.chunk, b.buckets)


def test_planner_offers_the_kernels_on_cuda():
    spec = ReproSpec()
    assert plan_groupby(59_986_052, 4, spec, ncols=6).method == "pallas"
    assert plan_groupby(59_986_052, 1, spec, ncols=5).method == "rsum"
    assert plan_groupby(60_000_000, 15_000_000, spec).method == "pallas"
    f64 = ReproSpec(dtype=torch.float64)
    assert plan_groupby(10**6, 64, f64).method not in ("pallas", "rsum")


def test_signature_json_matches_reference():
    for aggs, g, args in ((ALL_AGGS, 33, (2, None)), (Q1_AGGS, 6, (3, 12)),
                          (("sum", "avg", ("std", 1)), 1, (1, None))):
        for rdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            rsig = ref_partial.AggSignature.build(
                aggs, g, RefSpec(dtype=rdt, L=args[0], W=args[1]))
            sig = port_partial.AggSignature.build(
                aggs, g, ReproSpec(dtype=tdt, L=args[0], W=args[1]))
            assert json.dumps(rsig.to_json()) == json.dumps(sig.to_json())
            assert port_partial.AggSignature.from_json(
                rsig.to_json()) == sig
            assert rsig.compiled == sig.compiled


def test_default_device_is_cuda_and_raises_without_one():
    vals, keys = _groupby_data(100, 3, seed=0)
    if torch.cuda.is_available():
        out = groupby_agg(vals, keys, 3)
        assert out["sum(0)"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        groupby_agg(vals, keys, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_partial.partial_agg(vals, keys, 3)


def _bits(a):
    return np.asarray(a).view(np.uint32).tolist()


def test_min_max_signed_zeros_and_nan_match_reference():
    """MAX gives +0.0 and MIN -0.0 for a group holding both zeros, in
    either row order; a group holding a NaN gives the reference's NaN; an
    empty group gives the ±inf identities."""
    nan_pos = np.float32(np.nan)
    nan_neg = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    col = np.array([-0.0, 0.0, 0.0, -0.0, 1.0, nan_pos, 3.0, nan_neg, 2.0,
                    -np.inf, 5.0, -0.0, 7.0, -7.0], np.float32)
    keys = np.array([0, 0, 1, 1, 2, 2, 2, 3, 3, 5, 5, 6, 7, 7], np.int32)
    vals = np.stack([col, col[::-1].copy()], axis=1)
    aggs = [("min", 0), ("max", 0), ("min", 1), ("max", 1)]
    g = 8                                           # group 4 stays empty
    ref = ref_groupby(vals, keys, g, aggs, F32[0])
    rng = np.random.default_rng(0)
    for order in [np.arange(len(keys)), np.arange(len(keys))[::-1]] + [
            rng.permutation(len(keys)) for _ in range(3)]:
        got = groupby_agg(vals[order], keys[order], g, aggs, F32[1],
                          device="cpu")
        for name in ref:
            assert _bits(ref[name]) == _bits(got[name]), (name, order)
    assert _bits(got["max(0)"])[0] == 0x00000000
    assert _bits(got["min(0)"])[0] == 0x80000000
    # merging partial states keeps the same order and NaN choice
    parts = [port_partial.partial_agg(vals[s], keys[s], g, aggs, F32[1],
                                      device="cpu")
             for s in (slice(0, 3), slice(3, 9), slice(9, None))]
    for merged in (port_partial.merge(port_partial.merge(parts[2], parts[0]),
                                      parts[1]),
                   port_partial.merge_all(parts[::-1])):
        got = port_partial.finalize(merged)
        for name in ref:
            assert _bits(ref[name]) == _bits(got[name]), name


def test_std_square_root_is_correctly_rounded():
    """STD's square root matches the reference's (correctly rounded) one,
    although ``torch.sqrt`` on the CPU is not correctly rounded.  XLA's CPU
    backend flushes subnormal inputs to zero; there the port keeps IEEE
    (numpy's) square root."""
    rng = np.random.default_rng(0)
    x = (rng.random(1 << 20) * np.exp(rng.standard_normal(1 << 20) * 12)) \
        .astype(np.float32)
    x[:6] = [0.0, -0.0, np.inf, 1e-45, 3.4e38, 2.0]
    got = port_partial._sqrt_rn(torch.from_numpy(x)).numpy().view(np.uint32)
    normal = ~((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny))
    want = np.asarray(jnp.sqrt(jnp.asarray(x))).view(np.uint32)
    assert np.array_equal(want[normal], got[normal])
    assert np.array_equal(np.sqrt(x).view(np.uint32), got)
    x64 = rng.random(1 << 16) * np.exp(rng.standard_normal(1 << 16) * 25)
    assert np.array_equal(
        np.asarray(jnp.sqrt(jnp.asarray(x64))).view(np.uint64),
        port_partial._sqrt_rn(torch.from_numpy(x64)).numpy().view(np.uint64))
