"""The port's two kernels: their plain PyTorch versions against the JAX
package's Pallas kernels (run in interpret mode, as tests/test_kernels.py
runs them), bit for bit, and the wrappers' checks.  The CUDA kernels
themselves are held to these plain versions on the card, in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as ref_acc  # noqa: E402
from repro.core import prescan as ref_prescan  # noqa: E402
from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro.kernels.rsum import ops as ref_rsum  # noqa: E402
from repro.kernels.segment_rsum import ops as ref_seg  # noqa: E402
from repro_torch.core import accumulator as acc  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rsum import ops as rsum_ops  # noqa: E402
from repro_torch.kernels.rsum import ref as rsum_ref  # noqa: E402
from repro_torch.kernels.segment_rsum import ops as seg_ops  # noqa: E402
from repro_torch.kernels.segment_rsum import ref as seg_ref  # noqa: E402

SPEC_ARGS = [(1, None), (2, None), (3, None), (2, 12)]   # f32 (L, W)


def _specs(args):
    L, W = args
    return (RefSpec(dtype=jnp.float32, L=L, W=W),
            ReproSpec(dtype=torch.float32, L=L, W=W))


def _same_acc(ref, got, what=""):
    for name, x, y in zip(("k", "C", "e1"), ref, got):
        a, b = np.asarray(x), y.detach().cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert a.tobytes() == b.tobytes(), f"{what} {name}"


def _same_flat_acc(ref, got, what=""):
    """The reference's ``rsum_table`` sums its lanes without pinning the
    dtype, so under ``jax_enable_x64`` (tests/conftest.py) its k and C come
    back as int64; the port keeps the int32 table of every other strategy.
    Values must agree exactly."""
    assert got.k.dtype == got.C.dtype == torch.int32
    _same_acc(tuple(np.asarray(x).astype(np.int32) for x in ref[:2])
              + (ref[2],), got, what)
    for x in ref[:2]:
        assert np.array_equal(np.asarray(x), np.asarray(x).astype(np.int32))


def _values(kind, n, ncols, seed):
    """The stress inputs of tests/test_rsum_kernel_blocks.py, per column:
    denormals among normals, exact ± cancellation, near-bound carries."""
    rng = np.random.default_rng(seed)
    if kind == "wide":
        x = rng.standard_normal((n, ncols)) * 3.0
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
    elif kind == "carry":
        x = 1000.0 + rng.random((n, ncols)) * 64
    else:
        assert kind == "mixed"
        x = np.concatenate([rng.standard_normal((n // 2, ncols)) * 1e-5,
                            np.full((1, ncols), 4.2e8),
                            rng.standard_normal((n - n // 2 - 1, ncols))
                            * 1e3])
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

# (n, G) sweep of tests/test_kernels.py, one spec per shape
SEGMENT_CASES = [((1000, 1), (1, None)), ((1000, 16), (2, None)),
                 ((4096, 100), (3, None)), ((20_000, 700), (2, 12))]


@pytest.mark.parametrize("ng,args", SEGMENT_CASES, ids=str)
def test_segment_plain_matches_pallas_kernel(ng, args):
    n, g = ng
    rspec, spec = _specs(args)
    x = _values("wide", n, 2, seed=n + g)
    ids = np.random.default_rng(n * 31 + g).integers(0, g, n) \
        .astype(np.int32)
    want = ref_seg.segment_agg_kernel(x, ids, g, rspec, interpret=True)
    got = seg_ops.segment_agg_kernel(x, ids, g, spec, device="cpu")
    _same_acc(want, got, "segment_agg_kernel")
    # the port's oracle (the onehot strategy) and any group tile agree
    _same_acc(want, seg_ref.segment_agg_ref(x, ids, g, spec, device="cpu"),
              "oracle")
    _same_acc(want, seg_ops.segment_agg_kernel(x, ids, g, spec, group_tile=8,
                                               block_n=64, device="cpu"),
              "tile 8")


@pytest.mark.parametrize("kind", ["denormal", "cancel", "carry", "mixed"])
def test_segment_plain_stress_inputs_match_pallas_kernel(kind):
    rspec, spec = _specs((2, None))
    n, g = 3000, 8
    x = _values(kind, n, 2, seed=3)
    ids = np.random.default_rng(4).integers(0, g, n).astype(np.int32)
    want = ref_seg.segment_agg_kernel(x, ids, g, rspec, interpret=True)
    _same_acc(want, seg_ops.segment_agg_kernel(x, ids, g, spec,
                                               device="cpu"), kind)


def test_segment_plain_pruned_window_matches_pallas_kernel():
    rspec, spec = _specs((3, None))
    x = _values("wide", 4000, 2, seed=1)
    x = np.round(x * 300)                        # integers: dead bottom
    ids = np.random.default_rng(2).integers(0, 13, 4000).astype(np.int32)
    e1 = ref_acc.required_e1(jnp.asarray(x), rspec, axis=0)
    lv = ref_prescan.static_window(jnp.asarray(x), e1, rspec)
    assert lv != (0, rspec.L)
    want = ref_seg.segment_agg_kernel(x, ids, 13, rspec, e1=e1, levels=lv,
                                      interpret=True)
    got = seg_ops.segment_agg_kernel(x, ids, 13, spec,
                                     e1=torch.tensor(np.asarray(e1)),
                                     levels=lv, device="cpu")
    _same_acc(want, got, f"levels {lv}")
    _same_acc(want, seg_ops.segment_agg_kernel(x, ids, 13, spec,
                                               device="cpu"), "full window")


def test_segment_rsum_single_column_matches_pallas_kernel():
    rspec, spec = _specs((2, None))
    x = _values("wide", 5000, 1, seed=9)[:, 0]
    ids = np.random.default_rng(10).integers(0, 300, 5000).astype(np.int32)
    want = ref_seg.segment_rsum_kernel(x, ids, 300, rspec, interpret=True)
    _same_acc(want, seg_ops.segment_rsum_kernel(x, ids, 300, spec,
                                                device="cpu"), "rsum kernel")
    _same_acc(want, seg_ref.segment_rsum_ref(x, ids, 300, spec,
                                             device="cpu"), "oracle")


# (n, ncols) sweep of tests/test_kernels.py, one spec per shape
RSUM_CASES = [((1, 1), (1, None)), ((127, 3), (2, None)),
              ((8192, 4), (3, None)), ((100_001, 2), (2, 12))]


@pytest.mark.parametrize("shape,args", RSUM_CASES, ids=str)
def test_rsum_plain_matches_pallas_kernel(shape, args):
    n, ncols = shape
    rspec, spec = _specs(args)
    x = _values("wide", n, ncols, seed=n + ncols) * 5
    want = ref_rsum.rsum_table(x, num_segments=1, spec=rspec, interpret=True)
    got = rsum_ops.rsum_table(x, num_segments=1, spec=spec, device="cpu")
    assert got.k.shape == (1, ncols, spec.L)
    _same_flat_acc(want, got, "rsum_table")
    _same_acc(got, rsum_ref.rsum_table_ref(torch.from_numpy(x), spec),
              "oracle")


@pytest.mark.parametrize("kind", ["denormal", "cancel", "carry", "mixed"])
def test_rsum_plain_stress_inputs_match_pallas_kernel(kind):
    rspec, spec = _specs((2, None))
    x = _values(kind, 2048 * 3, 1, seed=5)
    want = ref_rsum.rsum_table(x, num_segments=1, spec=rspec, interpret=True)
    _same_flat_acc(want, rsum_ops.rsum_table(x, num_segments=1, spec=spec,
                                             device="cpu"), kind)


def test_rsum_plain_pruned_window_and_flat_api():
    rspec, spec = _specs((3, None))
    x = np.random.default_rng(1).integers(-1000, 1000, (4000, 2)) \
        .astype(np.float32)
    e1 = ref_acc.required_e1(jnp.asarray(x), rspec, axis=0)
    lv = ref_prescan.static_window(jnp.asarray(x), e1, rspec)
    assert lv != (0, rspec.L)
    want = ref_rsum.rsum_table(x, num_segments=1, spec=rspec, e1=e1,
                               levels=lv, interpret=True)
    got = rsum_ops.rsum_table(x, num_segments=1, spec=spec,
                              e1=torch.tensor(np.asarray(e1)), levels=lv,
                              device="cpu")
    _same_flat_acc(want, got, f"levels {lv}")
    flat = x[:, 0]
    _same_flat_acc(ref_rsum.rsum_acc(flat, rspec, interpret=True),
                   rsum_ops.rsum_acc(flat, spec, device="cpu"), "rsum_acc")


# ---------------------------------------------------------------------------
# wrappers: dispatch, checks, launch counts, build recipe
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    spec = ReproSpec()
    x = torch.from_numpy(_values("wide", 500, 3, seed=1))
    ids = torch.randint(0, 7, (500,), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0))
    before = (seg_ops.LAUNCHES, rsum_ops.LAUNCHES)
    seg_ops.segment_agg_kernel(x, ids, 7, spec, device="cpu")
    rsum_ops.rsum_table(x, num_segments=1, spec=spec, device="cpu")
    assert (seg_ops.LAUNCHES, rsum_ops.LAUNCHES) == before
    # the kernel entry points take CUDA tensors only: no silent CPU path
    e1 = acc.required_e1(x, spec, axis=0)
    A, iu = rsum_ops.ladder(e1, spec, (0, spec.L))
    with pytest.raises(ValueError, match="CUDA"):
        seg_ops.segment_levels_kernel(x, ids, 7, A, iu, spec)
    with pytest.raises(ValueError, match="CUDA"):
        rsum_ops.rsum_levels_kernel(x, A, iu, spec)


def test_wrappers_reject_what_the_kernels_do_not_take():
    f64 = ReproSpec(dtype=torch.float64)
    x = np.ones((8, 1), np.float64)
    with pytest.raises(ValueError, match="float32"):
        seg_ops.segment_agg_kernel(x, np.zeros(8, np.int32), 2, f64,
                                   device="cpu")
    with pytest.raises(ValueError, match="float32"):
        rsum_ops.rsum_table(x, num_segments=1, spec=f64, device="cpu")
    with pytest.raises(ValueError, match="num_segments"):
        rsum_ops.rsum_table(np.ones((8, 1), np.float32), num_segments=4,
                            spec=ReproSpec(), device="cpu")


def test_launch_shape_bounds():
    """Every path's shared memory fits one block, partial tables stay
    bounded at large G, and every row lands in some slab of 4-row groups."""
    for n, g, ncols, nlev in [(59_986_052, 4, 6, 2), (1, 1, 1, 1),
                              (60_000_000, 15_000_000, 1, 2),
                              (1 << 20, 1 << 20, 1, 3), (10, 3, 200, 8),
                              (4097, 700, 6, 2), (5, 47, 1, 2)]:
        for per_sm in (1, 4):
            shape = seg_ops.launch_shape(n, g, ncols, nlev, 132,
                                         blocks_per_sm=per_sm)
            assert shape.path in seg_ops.PATHS
            assert 1 <= shape.tile <= g
            assert shape.smem <= seg_ops.SMEM_BYTES
            assert shape.slabs * shape.rows_per_slab >= n
            assert (shape.slabs - 1) * shape.rows_per_slab < n
            assert shape.rows_per_slab % 4 == 0
            assert 1 <= shape.slabs <= 65_535
            assert shape.slabs == 1 or \
                shape.slabs * 8 * nlev * ncols * g <= seg_ops.PARTIAL_BYTES
            if shape.path != "private":
                table = 2 * 4 * nlev * ncols * shape.tile
                assert 1 <= shape.replicas <= seg_ops.THREADS // 32
                assert shape.smem == shape.replicas * table + 8 * nlev * ncols
    forced = seg_ops.launch_shape(1000, 300, 2, 2, 132, tile=8)
    assert forced.path == "tiled" and forced.tile == 8


# (n, G, ncols, nlev) -> path: TPC-H Q1 SF10, Q1 at L=3 and at 8 groups,
# Q18's inner GROUP BY at SF10, the flat query's one group, wide and deep
# tables
PATH_CASES = [((59_986_052, 4, 6, 2), "private"),
              ((59_986_052, 4, 6, 3), "private"),
              ((59_986_052, 8, 6, 2), "tiled"),
              ((59_986_052, 15_000_000, 1, 2), "tiled"),
              ((59_986_052, 1, 4, 2), "private"),
              ((1000, 3, 9, 2), "tiled"),
              ((1000, 3, 4, 5), "tiled"),
              ((1 << 20, 1 << 20, 1, 3), "tiled")]


@pytest.mark.parametrize("shape,path", PATH_CASES, ids=str)
def test_launch_path_choice(shape, path):
    n, g, ncols, nlev = shape
    assert seg_ops.launch_shape(n, g, ncols, nlev, 132).path == path


@pytest.mark.parametrize("ncols,nlev", [(1, 1), (1, 2), (2, 3), (6, 2),
                                        (8, 4), (9, 2), (3, 8)])
def test_launch_path_limits(ncols, nlev):
    """G on each side of the private path's limit and of the tiled path's
    one-tile limit takes the path and tiling the limits name, and each
    path's shared memory stays within its budget."""
    private_max, one_tile = seg_ops.group_limits(ncols, nlev)
    assert one_tile > private_max
    if ncols > seg_ops.PRIVATE_MAX_COLS or nlev > seg_ops.PRIVATE_MAX_LEVELS:
        assert private_max == 0
    else:
        assert private_max >= 1
        at = seg_ops.launch_shape(10_000, private_max, ncols, nlev, 132)
        assert at.path == "private" and at.smem <= seg_ops.SMEM_BYTES
        assert seg_ops.private_bytes(private_max, ncols, nlev) \
            <= seg_ops.PRIVATE_BYTES
        assert seg_ops.private_bytes(private_max + 1, ncols, nlev) \
            > seg_ops.PRIVATE_BYTES
        assert at.threads == at.replicas == seg_ops.PRIVATE_THREADS
    past = seg_ops.launch_shape(10_000, private_max + 1, ncols, nlev, 132)
    assert past.path == "tiled" and past.tile == private_max + 1
    assert past.replicas > 1
    at = seg_ops.launch_shape(10_000, one_tile, ncols, nlev, 132)
    assert at.path == "tiled" and at.tile == one_tile
    assert at.replicas == 1 and at.smem <= seg_ops.SMEM_BYTES
    past = seg_ops.launch_shape(10_000, one_tile + 1, ncols, nlev, 132)
    assert past.path == "tiled" and past.tile == one_tile
    assert past.smem <= seg_ops.SMEM_BYTES


@pytest.mark.parametrize("W", [2, 6, 12, 18, 21])
def test_int32_overflow_bounds(W):
    """Between flushes (private path) or renorms (tiled path) no
    int32 table entry can leave [-2^31, 2^31): a row adds at most 2^(W-1)
    to one entry of each (column, level), a flush starts from 0 and a
    renorm from a canonical k < 2^(m-2); a thread's step is 4 rows, a
    block's at most THREADS."""
    spec = ReproSpec(W=W)
    rows = seg_ops.flush_rows(spec)
    assert rows >= seg_ops.THREADS >= 4
    assert rows * (1 << (W - 1)) <= 1 << 30
    assert (1 << (spec.m - 2)) + rows * (1 << (W - 1)) < 1 << 31
    # tiled path: a warp of one group sums to at most 32 * 2^(W-1) in int32
    assert 32 * (1 << (W - 1)) < 1 << 31


@pytest.mark.parametrize("args", SPEC_ARGS, ids=str)
def test_extracted_integers_stay_within_half_window(args):
    """The bound the int32 arithmetic rests on: every extracted k of the
    plain version has |k| <= 2^(W-1), on the stress inputs."""
    _, spec = _specs(args)
    for kind in ("wide", "denormal", "cancel", "carry", "mixed"):
        x = torch.from_numpy(_values(kind, 3000, 3, seed=11))
        e1 = acc.required_e1(x, spec, axis=0)
        A, iu = rsum_ops.ladder(e1, spec, (0, spec.L))
        r = x
        for lv in range(A.shape[0]):
            q = (r + A[lv]) - A[lv]
            r = r - q
            k = (q * iu[lv]).to(torch.int64)
            assert int(k.abs().max()) <= 1 << (spec.W - 1), (kind, lv)


def _rsum_cover(total, ncols, head, blocks):
    """The rsum kernel's index arithmetic, in Python: which flat element
    each (thread, vector slot) reads, head and tail included."""
    threads = blocks * rsum_ops.THREADS
    nvec = (total - head) // 4
    seen = np.zeros(total, np.int64)
    slot_cols = {}
    for v in range(nvec):
        t = v % threads
        for j in range(4):
            e = head + 4 * v + j
            seen[e] += 1
            col = slot_cols.setdefault((t, j), e % ncols)
            assert col == e % ncols, "a slot changed column"
    seen[:head] += 1
    seen[head + 4 * nvec:] += 1
    return seen


@pytest.mark.parametrize("ncols", [1, 3, 4, 5, 6, 7, 8, 9, 200])
def test_rsum_grid_keeps_each_slot_on_one_column(ncols):
    """The grid's element stride per step is a multiple of ncols, within
    one resident wave unless one step exceeds it, and the vectors plus the
    ragged head and tail cover every element exactly once."""
    for total, per_sm, sms in [(59_986_052 * 4, 8, 132), (1, 8, 132),
                               (5 * ncols, 1, 2), (4097 * ncols, 2, 3)]:
        total = max(total // ncols, 1) * ncols
        blocks = rsum_ops.grid_blocks(total, ncols, sms, per_sm)
        step = rsum_ops.THREADS * rsum_ops.VEC
        assert (blocks * step) % ncols == 0
        assert blocks <= max(per_sm * sms, ncols // np.gcd(ncols, step))
    for total, head in [(1, 1), (3, 3), (5, 1), (4097 * ncols, 2),
                        (3 * ncols, 0), (2 * 256 * 4 * ncols + 7, 3)]:
        head = min(head, total)
        blocks = rsum_ops.grid_blocks(total, ncols, 2, 1)
        if total <= 20_000:
            assert (_rsum_cover(total, ncols, head, blocks) == 1).all()


def test_build_recipe():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags
    assert "-Xptxas -v" in flags            # registers and spills reported
    for name in _build.KERNEL_SOURCES:
        src = _build.source_path(name)
        assert src.is_file() and src.suffix == ".cu"
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR
        assert lib.name.startswith(f"lib{name}-") and lib.suffix == ".so"
        text = src.read_text()
        assert "__fadd_rn" in text and "__float2int_rz" in text
        assert "Replaces: src/repro/kernels/" in text
        assert "What bounds it on an H100" in text
    # vector loads: streaming float4 (rsum), cp.async chunks (segment)
    assert "__ldcs" in _build.source_path("rsum").read_text()
    seg = _build.source_path("segment_rsum").read_text()
    assert "cp.async.cg.shared.global" in seg
    assert "__all_sync" in seg and "__reduce_add_sync" in seg
    assert f"kPrivateThreads = {seg_ops.PRIVATE_THREADS};" in seg


def test_ptxas_report_parses_nvcc_output(tmp_path, monkeypatch):
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi2ELi6EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi2ELi6EEvPKf
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 400 bytes cmem[0]
"""
    lib = tmp_path / "libk-0.so"
    lib.with_suffix(".log").write_text(log)
    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(tmp_path / "nvcc"))
    assert _build.ptxas_report("k") == [{
        "function": "_Z6kernelILi2ELi6EEvPKf", "registers": 72,
        "spill_stores": 8, "spill_loads": 12}]
    monkeypatch.setattr(_build, "library_path",
                        lambda name: tmp_path / "missing.so")
    assert _build.ptxas_report("k") == []
