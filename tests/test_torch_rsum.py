"""The paper's baselines in ``repro_torch`` against the JAX package, bit for
bit: RSUM Algorithms 2 and 3 and the chunked Fig. 6 form
(``core/rsum.py``) at ``tests/test_rsum.py``'s specs and shapes, the
summation buffers (``core/buffers.py``) and DECIMAL sums
(``numerics/decimal.py``) at ``tests/test_segment.py``'s, and the
accumulator's paper-state conversions.  Sizes stay small: the algorithms
are per-element and per-block loops of eager operations."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as ref_acc  # noqa: E402
from repro.core import buffers as ref_buffers  # noqa: E402
from repro.core import rsum as ref_rsum  # noqa: E402
from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro.numerics import DecimalSpec as RefDecimal  # noqa: E402
from repro.numerics import decimal_segment_sum as ref_decimal  # noqa: E402
from repro_torch.core import accumulator as acc_mod  # noqa: E402
from repro_torch.core import buffers, rsum  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.interop import acc_from_numpy, acc_to_numpy  # noqa: E402
from repro_torch.numerics import DecimalSpec, decimal_segment_sum  # noqa: E402

SPECS = {
    "f32-L2": (RefSpec(dtype=jnp.float32, L=2),
               ReproSpec(dtype=torch.float32, L=2)),
    "f32-L3": (RefSpec(dtype=jnp.float32, L=3),
               ReproSpec(dtype=torch.float32, L=3)),
    "f64-L2": (RefSpec(dtype=jnp.float64, L=2),
               ReproSpec(dtype=torch.float64, L=2)),
}
F32 = SPECS["f32-L2"]


def _rand(n, seed, spec, scale=1.0):
    """tests/test_rsum.py's inputs."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * scale).astype(
        np.dtype(str(spec.dtype).rsplit(".", 1)[-1]))


def _same_state(ref, port):
    """Paper states (S, C): the same bytes and dtypes."""
    for a, b in zip(ref, port):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _same_float(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_scalar_and_simd_equal_reference(name):
    rspec, spec = SPECS[name]
    x = _rand(512, 1, spec)
    got = rsum.rsum_scalar(torch.from_numpy(x), spec)
    _same_state(ref_rsum.rsum_scalar(x, rspec), got)
    _same_float(ref_rsum.finalize_state(*ref_rsum.rsum_scalar(x, rspec),
                                        rspec),
                rsum.finalize_state(*got, spec))
    x = _rand(4096, 2, spec)
    _same_state(ref_rsum.rsum_simd(x, rspec, V=8),
                rsum.rsum_simd(torch.from_numpy(x), spec, V=8))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_scalar_and_simd_agree_at_a_given_f(name):
    """test_rsum.py's shared-ladder case: f from choose_f, V=8 and V=16."""
    rspec, spec = SPECS[name]
    x = _rand(1024, 3, spec)
    f = int(rsum.choose_f(torch.from_numpy(x), spec))
    assert f == int(ref_rsum.choose_f(jnp.asarray(x), rspec))
    s = rsum.rsum_scalar(torch.from_numpy(x), spec, f=f)
    _same_state(ref_rsum.rsum_scalar(x, rspec, f=f), s)
    for V in (8, 16):
        v = rsum.rsum_simd(torch.from_numpy(x), spec, V=V, f=f)
        _same_state(ref_rsum.rsum_simd(x, rspec, V=V, f=f), v)
        assert rsum.finalize_state(*s, spec).numpy().tobytes() == \
            rsum.finalize_state(*v, spec).numpy().tobytes()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_demotion_equals_reference(name):
    """A large late value forces Algorithm 2's lines 4-7."""
    rspec, spec = SPECS[name]
    x = np.concatenate([_rand(100, 6, spec, 1e-4),
                        np.array([1e6], dtype=_rand(1, 0, spec).dtype),
                        _rand(100, 7, spec, 1e-4)])
    _same_state(ref_rsum.rsum_scalar(x, rspec),
                rsum.rsum_scalar(torch.from_numpy(x), spec))
    _same_state(ref_rsum.rsum_simd(x, rspec, V=8),
                rsum.rsum_simd(torch.from_numpy(x), spec, V=8))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_chunked_equals_reference(name):
    """Fig. 6 chunking, including chunk sizes that round up to whole V*NB
    blocks (c = 0, 1, 100, 257)."""
    rspec, spec = SPECS[name]
    x = _rand(2048, 8, spec)
    whole = rsum.rsum_simd_chunked(torch.from_numpy(x), spec, c=2048, V=8)
    for c in (2048, 256, 257, 100, 1, 0):
        got = rsum.rsum_simd_chunked(torch.from_numpy(x), spec, c=c, V=8)
        _same_state(ref_rsum.rsum_simd_chunked(x, rspec, c=c, V=8), got)
        assert rsum.finalize_state(*got, spec).numpy().tobytes() == \
            rsum.finalize_state(*whole, spec).numpy().tobytes()


def test_window_invariant_and_conventional_sum():
    rspec, spec = F32
    x = _rand(777, 10, spec, 42.0)
    S, C = rsum.rsum_scalar(torch.from_numpy(x), spec)
    S = S.numpy()
    u = 2.0 ** np.floor(np.log2(np.abs(S)))
    assert np.all(S >= 1.5 * u) and np.all(S < 1.75 * u)
    assert C.dtype == torch.int32
    conv = rsum.conventional_sum(torch.from_numpy(x))
    assert conv.dtype == torch.float32
    np.testing.assert_allclose(float(conv), x.astype(np.float64).sum(),
                               rtol=1e-5)


def _segment_data(n, g, seed):
    """tests/test_segment.py's inputs."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n).astype(np.float32)
    return vals, rng.integers(0, g, n).astype(np.int32)


def test_buffers_and_paper_state_default_to_the_card():
    """``buffers.init`` and ``rsum.init_state`` put their state on the card
    unless asked for the CPU (``init_state`` follows a tensor ``f``)."""
    spec = F32[1]
    if torch.cuda.is_available():
        assert buffers.init(4, 8, spec).buf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            buffers.init(4, 8, spec)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rsum.init_state(3, spec)
    assert buffers.init(4, 8, spec, device="cpu").acc.k.device.type == "cpu"
    S, C = rsum.init_state(torch.tensor(3), spec)
    assert S.device.type == C.device.type == "cpu"


@pytest.mark.parametrize("bsz", [16, 7])
def test_summation_buffers_equal_reference(bsz):
    rspec, spec = F32
    vals, ids = _segment_data(300, 4, seed=9)
    ref = ref_buffers.flush_all(ref_buffers.append(
        ref_buffers.init(4, bsz=bsz, spec=rspec), ids, vals, rspec), rspec)
    st = buffers.append(buffers.init(4, bsz=bsz, spec=spec, device="cpu"),
                        torch.from_numpy(ids), torch.from_numpy(vals), spec)
    got = buffers.flush_all(st, spec)
    for a, b in zip(acc_to_numpy(got), ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    want = acc_mod.finalize(acc_mod.from_values(
        torch.from_numpy(vals)[:, None].expand(-1, 4)
        * (torch.from_numpy(ids)[:, None] == torch.arange(4)), spec, axis=0),
        spec)
    assert acc_mod.finalize(got, spec).numpy().tobytes() == \
        want.numpy().tobytes()


def test_optimal_bsz_eq4():
    for args in ((1, 1, 4), (2 ** 12, 1, 4), (2 ** 12, 256, 4), (300, 7, 8)):
        assert buffers.optimal_bsz(*args, cache_bytes=2 ** 20) == \
            ref_buffers.optimal_bsz(*args, cache_bytes=2 ** 20)


@pytest.mark.parametrize("precision,scale", [(9, 4), (18, 6), (4, 2)])
def test_decimal_equals_reference(precision, scale):
    """DECIMAL(9) on int32, DECIMAL(18) on int64, and a DECIMAL(4) that
    overflows."""
    vals, ids = _segment_data(1000, 10, seed=10)
    vals = vals * 10
    ref = ref_decimal(vals, ids, 10, RefDecimal(precision, scale))
    got = decimal_segment_sum(torch.from_numpy(vals), torch.from_numpy(ids),
                              10, DecimalSpec(precision, scale))
    for a, b in zip(ref, got):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert bool(got[1].any()) == (precision == 4)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_paper_state_and_add_values_equal_reference(name):
    rspec, spec = SPECS[name]
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((5, 64)) * 1e3).astype(
        _rand(1, 0, spec).dtype)
    racc = ref_acc.from_values(x, rspec, axis=1)
    acc = acc_from_numpy(racc, spec, device="cpu")
    S, C = acc_mod.to_paper_state(acc, spec)
    _same_state(ref_acc.to_paper_state(racc, rspec), (S, C))
    back = acc_mod.from_paper_state(S, C, acc.e1, spec)
    for a, b in zip(back, acc):
        assert torch.equal(a, b)
    y = x * 1e4                         # a coarser lattice: demotes acc
    got = acc_mod.add_values(acc, torch.from_numpy(y), spec, axis=1)
    for a, b in zip(acc_to_numpy(got), ref_acc.add_values(racc, y, rspec,
                                                          axis=1)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
