"""On the card: the hand-written CUDA kernels against their plain PyTorch
versions, and ``groupby_agg`` on the card against the CPU, bit for bit.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
module imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import accumulator as acc  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.kernels.rsum import ops as rsum_ops  # noqa: E402
from repro_torch.kernels.segment_rsum import ops as seg_ops  # noqa: E402
from repro_torch.ops import groupby_agg  # noqa: E402

SPECS = [ReproSpec(L=1), ReproSpec(L=2), ReproSpec(L=3), ReproSpec(L=2, W=12)]
AGGS = [("sum", 0), ("count",), ("mean", 0), ("var", 1), ("std", 1),
        ("sum_prod", 0, 1), ("min", 0), ("max", 1)]


def _values(kind, n, ncols, seed):
    rng = np.random.default_rng(seed)
    if kind == "wide":
        x = rng.standard_normal((n, ncols)) * np.exp(
            rng.standard_normal((n, ncols)) * 3)
    elif kind == "denormal":
        tiny = np.float32(1.4e-45) * rng.integers(1, 200, (n, ncols))
        x = np.where(rng.random((n, ncols)) < 0.4, tiny,
                     rng.standard_normal((n, ncols)) * 0.25)
        x[0] = 1.0
    elif kind == "cancel":
        half = rng.standard_normal((n // 2, ncols)) * 1e3
        noise = rng.standard_normal((n - 2 * (n // 2), ncols)) * 1e-3
        x = np.concatenate([half, -half, noise])
        rng.shuffle(x)
    else:
        assert kind == "carry"
        x = 1000.0 + rng.random((n, ncols)) * 64
    return x.astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_cuda_kernels_match_plain(cuda, spec):
    for (n, g, ncols), kind in [((1, 1, 1), "wide"), ((4096, 100, 3), "wide"),
                                ((50_001, 700, 6), "cancel"),
                                ((20_000, 4, 2), "denormal"),
                                ((200_000, 70_000, 1), "carry")]:
        x = torch.from_numpy(_values(kind, n, ncols, seed=n)).to(cuda)
        ids = torch.from_numpy(np.random.default_rng(g).integers(
            0, g, n).astype(np.int32)).to(cuda)
        e1 = acc.required_e1(x, spec, axis=0)
        A, iu = rsum_ops.ladder(e1, spec, (0, spec.L))
        before = seg_ops.LAUNCHES
        for got, want in (
                (seg_ops.segment_levels_kernel(x, ids, g, A, iu, spec),
                 seg_ops.segment_levels_plain(x, ids, g, A, iu, spec)),
                (seg_ops.segment_levels_kernel(x, ids, g, A, iu, spec, 8),
                 seg_ops.segment_levels_plain(x, ids, g, A, iu, spec)),
                (rsum_ops.rsum_levels_kernel(x, A, iu, spec),
                 rsum_ops.rsum_levels_plain(x, A, iu, spec))):
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), (n, g, ncols, kind)
        assert seg_ops.LAUNCHES == before + 4      # two kernels a call


@pytest.mark.cuda
def test_groupby_on_the_card_equals_the_cpu(cuda):
    x = _values("wide", 30_000, 2, seed=2)
    for g in (1, 4, 50, 5000):
        keys = np.random.default_rng(g).integers(0, g, 30_000) \
            .astype(np.int32)
        launches = (seg_ops.LAUNCHES, rsum_ops.LAUNCHES)
        on_card = groupby_agg(x, keys, g, AGGS)       # default device: cuda
        on_cpu = groupby_agg(x, keys, g, AGGS, device="cpu")
        assert (seg_ops.LAUNCHES, rsum_ops.LAUNCHES) != launches
        for name in on_cpu:
            assert on_card[name].device.type == "cuda"
            assert on_card[name].cpu().numpy().tobytes() == \
                on_cpu[name].numpy().tobytes(), (g, name)


def _same_as_plain(x, ids, g, spec, tile=None):
    """Both kernels against their plain versions, bit for bit; returns the
    segment launch's path."""
    e1 = acc.required_e1(x, spec, axis=0)
    A, iu = rsum_ops.ladder(e1, spec, (0, spec.L))
    got = seg_ops.segment_levels_kernel(x, ids, g, A, iu, spec, tile)
    want = seg_ops.segment_levels_plain(x, ids, g, A, iu, spec)
    got_f = rsum_ops.rsum_levels_kernel(x, A, iu, spec)
    want_f = rsum_ops.rsum_levels_plain(x, A, iu, spec)
    torch.cuda.synchronize()
    for a, b in zip(got + got_f, want + want_f):
        assert torch.equal(a, b), (tuple(x.shape), g, spec)
    return seg_ops.launch_shape(x.shape[0], g, x.shape[1], spec.L, 132,
                                tile).path


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_cuda_kernels_ragged_shapes(cuda, spec):
    """Row counts around the 4-row and 16-byte vector edges, every column
    count of the rsum column mapping and the private path's templates."""
    for n in (1, 3, 5, 4097):
        for ncols in (1, 3, 4, 5, 6, 7, 8):
            x = torch.from_numpy(_values("wide", n, ncols,
                                         seed=n * 10 + ncols)).to(cuda)
            ids = torch.from_numpy(np.random.default_rng(ncols).integers(
                0, 3, n).astype(np.int32)).to(cuda)
            _same_as_plain(x, ids, 3, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_cuda_kernels_at_path_limits(cuda, spec):
    """G on each side of the private-table limit and of the tiled path's
    one-tile limit, with padding ids (-1) among the rows; every path is
    reached."""
    seen = set()
    for ncols in (1, 6):
        private_max, one_tile = seg_ops.group_limits(ncols, spec.L)
        for g in (private_max, private_max + 1, one_tile, one_tile + 1):
            if g < 1:
                continue
            n = 20_000
            x = torch.from_numpy(_values("cancel", n, ncols, seed=g)) \
                .to(cuda)
            rng = np.random.default_rng(g)
            ids = rng.integers(0, g, n).astype(np.int32)
            ids[rng.random(n) < 0.1] = -1
            seen.add(_same_as_plain(
                x, torch.from_numpy(ids).to(cuda), g, spec))
    assert seen == set(seg_ops.PATHS)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_cuda_kernels_unaligned_views(cuda, spec):
    """Contiguous views whose data_ptr is not 16-byte aligned take the
    scalar head, tail and row loads; sorted ids put a whole warp on one
    group."""
    for n, g, ncols in [(4097, 3, 6), (10_001, 700, 5), (3, 2, 4),
                        (50_000, 20_000, 1)]:
        flat = torch.from_numpy(_values("wide", n * ncols + 1, 1,
                                        seed=n)[:, 0]).to(cuda)
        x = flat[1:].view(n, ncols)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        raw = torch.from_numpy(np.sort(np.random.default_rng(n).integers(
            0, g, n + 1)).astype(np.int32)).to(cuda)
        ids = raw[1:]
        assert ids.data_ptr() % 16 != 0
        _same_as_plain(x, ids, g, spec)
