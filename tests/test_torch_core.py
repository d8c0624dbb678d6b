"""The port's accumulator core against the JAX package, bit for bit.

Inputs are made from a seed with numpy and fed to both packages; every
table field (k, C, e1) and every finalized float must carry the same bytes
and the same dtype.  Tolerance is zero.  The reference's accumulator
functions run under one ``jax.jit`` per spec (integer arithmetic and the
EFT extraction are exact under fusion); its ``finalize`` runs eagerly, as
the JAX package runs it.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as ref_acc  # noqa: E402
from repro.core import eft as ref_eft  # noqa: E402
from repro.core import prescan as ref_prescan  # noqa: E402
from repro.core.aggregates import pad_and_chunk as ref_pad_and_chunk  # noqa: E402,E501
from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro_torch.core import accumulator as acc  # noqa: E402
from repro_torch.core import eft  # noqa: E402
from repro_torch.core import prescan  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402

# (dtype name, L, W): f32 L=1/2/3, f32 W=12, f64 L=2
SPEC_ARGS = [("float32", 1, None), ("float32", 2, None), ("float32", 3, None),
             ("float32", 2, 12), ("float64", 2, None)]


def _specs(args):
    name, L, W = args
    return (RefSpec(dtype=getattr(jnp, name), L=L, W=W),
            ReproSpec(dtype=getattr(torch, name), L=L, W=W))


def _np_dtype(spec):
    return np.float32 if spec.m <= 30 else np.float64


def _mixed(shape, dtype, seed):
    """Wide magnitudes, exact zeros, denormals and a large outlier."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape) * np.exp(rng.standard_normal(shape) * 4)
    v = v.astype(dtype)
    v[::53] = 0.0
    v[3::211] = np.finfo(dtype).smallest_subnormal * 7
    v[5] = 4.2e8
    return v


def _same(a, b, what=""):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def _same_acc(ref, got, what=""):
    for name, x, y in zip(("k", "C", "e1"), ref, got):
        _same(x, y, f"{what} {name}")


def _ref_battery(parts, e1, window, rspec):
    """Everything the port's accumulator is held to, in one traced call:
    per-part sums on their own lattices, a pairwise merge (demotion), a
    k-way merge, a demotion two lattice steps up, and the extraction of
    part 1 under the full and the prescan-proved level windows."""
    accs = [ref_acc.from_values(p, rspec, axis=0) for p in parts]
    return (accs, ref_acc.merge(accs[0], accs[2], rspec),
            ref_acc.merge_all(accs, rspec),
            ref_acc.demote_to(accs[0], accs[0].e1 + 2 * rspec.W, rspec),
            ref_acc.extract(parts[1], e1[None, :], rspec),
            ref_acc.extract(parts[1], e1[None, :], rspec, levels=window))


@pytest.mark.parametrize("args", SPEC_ARGS, ids=str)
def test_accumulator_matches_reference(args):
    """from_values (flat and per column), extract under level windows,
    merge, merge_all, demote_to and finalize, on mixed magnitudes with
    zeros and denormals.  Parts of very different magnitude sit on
    different lattices, so the merges exercise demotion."""
    rspec, spec = _specs(args)
    dt = _np_dtype(spec)
    parts = [_mixed((700, 2), dt, seed=1) * dt(s) for s in (1e-6, 1.0, 3e5)]
    e1_ref = ref_acc.required_e1(jnp.asarray(parts[1]), rspec, axis=0)
    window = ref_prescan.static_window(jnp.asarray(parts[1]), e1_ref, rspec)
    accs_r, merge_r, all_r, demote_r, ext_r, win_r = jax.jit(
        functools.partial(_ref_battery, rspec=rspec, window=window))(
        parts, e1_ref)

    tparts = [torch.from_numpy(p) for p in parts]
    accs = [acc.from_values(p, spec, axis=0) for p in tparts]
    for r, g in zip(accs_r, accs):
        _same_acc(r, g, "from_values axis=0")
    e1 = acc.required_e1(tparts[1], spec, axis=0)
    _same(e1_ref, e1, "required_e1")
    assert prescan.static_window(tparts[1], e1, spec) == window
    _same(ext_r, acc.extract(tparts[1], e1[None, :], spec), "extract")
    win = acc.extract(tparts[1], e1[None, :], spec, levels=window)
    _same(win_r, win, f"extract {window}")
    _same(ext_r, acc.pad_levels(win, window, spec), "pad_levels")
    _same_acc(merge_r, acc.merge(accs[0], accs[2], spec), "merge")
    _same_acc(merge_r, acc.merge(accs[2], accs[0], spec), "merge commutes")
    merged = acc.merge_all(accs, spec)
    _same_acc(all_r, merged, "merge_all")
    _same_acc(merged, acc.merge(acc.merge(accs[1], accs[2], spec), accs[0],
                                spec), "fold == merge_all")
    _same_acc(merged, acc.from_values(torch.cat(tparts), spec, axis=0),
              "one-shot == merge of parts")
    _same_acc(demote_r, acc.demote_to(accs[0], accs[0].e1 + 2 * spec.W,
                                      spec), "demote_to")
    _same(ref_acc.finalize(all_r, rspec), acc.finalize(merged, spec),
          "finalize")
    # a flat sum over every element, under a row permutation
    flat = np.concatenate(parts).reshape(-1)
    perm = np.random.default_rng(3).permutation(flat.shape[0])
    _same_acc(jax.jit(functools.partial(ref_acc.from_values, spec=rspec))(
        flat), acc.from_values(torch.from_numpy(flat[perm]), spec), "flat")


def test_scalar_demotion_branch_matches_reference():
    """Per-tensor lattices take the reference's clamped switch branch."""
    rspec, spec = _specs(SPEC_ARGS[2])
    x = _mixed((999,), np.float32, seed=4)
    r0 = jax.jit(functools.partial(ref_acc.from_values, spec=rspec))(x)
    g0 = acc.from_values(torch.from_numpy(x), spec)
    _same_acc(r0, g0, "scalar from_values")
    for s in (0, 1, spec.L + 2):
        _same_acc(ref_acc.demote_to(r0, r0.e1 + s * rspec.W, rspec),
                  acc.demote_to(g0, int(r0.e1) + s * spec.W, spec),
                  f"demote scalar {s}")


def test_renorm_on_negative_k_is_floor():
    """``>>`` must be an arithmetic shift on negative window offsets."""
    assert torch.equal(torch.tensor([-5, -1, 3]) >> 2,
                       torch.tensor([-2, -1, 0]))
    for args in (SPEC_ARGS[1], SPEC_ARGS[4]):
        rspec, spec = _specs(args)
        idt = np.int32 if spec.m <= 30 else np.int64
        rng = np.random.default_rng(1)
        bound = 1 << (spec.m - 1)
        k = rng.integers(-bound, bound, 4096).astype(idt)
        k[:4] = [-1, -(1 << (spec.m - 2)), -(1 << (spec.m - 2)) - 1, 0]
        C = rng.integers(-1000, 1000, 4096).astype(idt)
        rk, rc = ref_acc.renorm(jnp.asarray(k), jnp.asarray(C), rspec)
        gk, gc = acc.renorm(torch.from_numpy(k), torch.from_numpy(C), spec)
        _same(rk, gk, "k")
        _same(rc, gc, "C")
        assert int(gk.min()) >= 0 and int(gk.max()) < (1 << (spec.m - 2))


def test_zeros_and_eft_primitives_match_reference():
    for args in (SPEC_ARGS[1], SPEC_ARGS[4]):
        rspec, spec = _specs(args)
        _same_acc(ref_acc.zeros(rspec, (3, 2)), acc.zeros(spec, (3, 2)),
                  "zeros")
        e = np.arange(rspec.fspec.min_exp, rspec.fspec.max_exp + 1,
                      dtype=np.int32)
        _same(ref_eft.pow2(e, rspec.dtype),
              eft.pow2(torch.from_numpy(e), spec.dtype), "pow2")
        _same(ref_eft.extractor(e, rspec.dtype),
              eft.extractor(torch.from_numpy(e), spec.dtype), "extractor")
        x = _mixed((999,), _np_dtype(spec), seed=2)
        x[7] = -np.inf
        x[8] = np.nan
        _same(ref_eft.exponent(jnp.asarray(x)),
              eft.exponent(torch.from_numpy(x)), "exponent")


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_ulp_eft_and_int_scaling_match_reference(name):
    """``ulp``, ``eft`` against a running sum in its window, and the exact
    ``scale_to_int`` / ``int_to_scaled`` round trip: same bytes as the JAX
    package's on wide magnitudes, zeros and subnormals."""
    rspec, spec = _specs((name, 2, None))
    dt = _np_dtype(spec)
    x = _mixed((999,), dt, seed=11)
    _same(ref_eft.ulp(jnp.asarray(x)), eft.ulp(torch.from_numpy(x)), "ulp")
    rng = np.random.default_rng(12)
    m, e = spec.m, 10
    S = (np.ldexp(1.5, e) + rng.integers(0, 2**20, 999)
         * np.ldexp(1.0, e - m)).astype(dt)
    b = (rng.standard_normal(999) * np.ldexp(1.0, e - m + 16)).astype(dt)
    b[::7] = _mixed((143,), dt, seed=13) * np.ldexp(1.0, -40)
    for ref, got, what in zip(ref_eft.eft(jnp.asarray(S), jnp.asarray(b)),
                              eft.eft(torch.from_numpy(S),
                                      torch.from_numpy(b)), ("q", "r")):
        _same(ref, got, f"eft {what}")
    A = ref_eft.extractor(e, rspec.dtype)
    q = np.array(ref_eft.eft_fixed(A, jnp.asarray(b))[0])
    k_ref = ref_eft.scale_to_int(jnp.asarray(q), e, m)
    k = eft.scale_to_int(torch.from_numpy(q), e, m)
    _same(k_ref, k, "scale_to_int")
    _same(ref_eft.int_to_scaled(k_ref, e, m, rspec.dtype),
          eft.int_to_scaled(k, e, m, spec.dtype), "int_to_scaled")
    np.testing.assert_array_equal(
        eft.int_to_scaled(k, e, m, spec.dtype).numpy(), q)


def _prescan_cases():
    """Equal-shape inputs (so the reference's compiled ops are reused):
    wide magnitudes, tiny normals, integers (dead bottom levels), two
    magnitude regimes in separate chunks, and all zeros."""
    rng = np.random.default_rng(37)
    shape = (3000, 2)
    return [
        (rng.standard_normal(shape) *
         np.exp(rng.standard_normal(shape) * 5)).astype(np.float32),
        ((rng.random(shape) + 1.0) * 1e-30).astype(np.float32),
        rng.integers(-1000, 1000, shape).astype(np.float32),
        np.concatenate([(rng.random((1024, 2)) + 1.0) * 2**30,
                        (rng.random((1976, 2)) + 1.0) * 2**-20]
                       ).astype(np.float32),
        np.zeros(shape, np.float32),
    ]


@pytest.mark.parametrize("L", [1, 2, 4])
def test_prescan_level_window_matches_reference(L):
    rspec, spec = _specs(("float32", L, None))
    for i, x in enumerate(_prescan_cases()):
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        e1_ref = ref_acc.required_e1(xj, rspec, axis=0)
        e1 = acc.required_e1(xt, spec, axis=0)
        _same(e1_ref, e1, f"required_e1 {i}")
        rs = ref_prescan.column_stats(xj, rspec)
        gs = prescan.column_stats(xt, spec)
        _same(rs.max_exp, gs.max_exp, f"max_exp {i}")
        _same(rs.min_nz_exp, gs.min_nz_exp, f"min_nz_exp {i}")
        for a, b in zip(ref_prescan.level_window(rs, e1_ref, rspec),
                        prescan.level_window(gs, e1, spec)):
            _same(a, b, f"level_window {i}")
        assert ref_prescan.static_window(xj, e1_ref, rspec) == \
            prescan.static_window(xt, e1, spec), i
        # per-chunk stats equal the reference's over zero-padded chunks
        rc = ref_prescan.chunk_stats(ref_pad_and_chunk(xj, 1024), rspec)
        gc = prescan.chunk_stats(xt, 1024, spec)
        _same(rc.max_exp, gc.max_exp, f"chunk max {i}")
        _same(rc.min_nz_exp, gc.min_nz_exp, f"chunk min {i}")
