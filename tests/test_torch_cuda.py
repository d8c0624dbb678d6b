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
        assert seg_ops.LAUNCHES == before + 2


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
