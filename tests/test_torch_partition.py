"""The segment kernel's partition by group tile (the tiled path over several
tiles), on the CPU: ``partition_plain`` against a numpy counting sort, the
table of the partitioned rows against the original rows' and the JAX
package's, the launch shape's promises, and a property-based parity test of
``groupby_agg`` against the JAX package's across the path limits.  The
kernels themselves are held to these plain versions on the card, in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro.kernels.segment_rsum.ref import segment_agg_ref  # noqa: E402
from repro.ops import groupby_agg as ref_groupby  # noqa: E402
from repro_torch.core import accumulator as acc  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.kernels.rsum import ops as rsum_ops  # noqa: E402
from repro_torch.kernels.segment_rsum import ops as seg_ops  # noqa: E402
from repro_torch.ops import groupby_agg  # noqa: E402


def _ids(kind, n, g, tile, rng):
    """Ids with empty tiles, one hot tile, sorted or permuted rows, and
    padding (-1)."""
    if kind == "hot":                    # every row in tile 1
        ids = rng.integers(tile, min(g, 2 * tile), n)
    elif kind == "sparse":               # few rows over many tiles
        ids = rng.integers(0, g, n // 40)
        ids = np.concatenate([ids, np.full(n - ids.size, -1)])
        rng.shuffle(ids)
    else:
        ids = rng.integers(0, g, n)
        ids[rng.random(n) < 0.1] = -1
        if kind == "sorted":
            ids.sort()
    return ids.astype(np.int32)


# (kind, n, G, tile, chunk_rows): empty tiles, one hot tile split over
# items, G one past one tile (its last tile of one group), sorted and
# permuted rows
CASES = [("sparse", 400, 300, 8, 16), ("hot", 500, 300, 8, 64),
         ("permuted", 700, 14_528, 14_527, 100),
         ("sorted", 1000, 97, 10, 40), ("permuted", 1000, 97, 10, 40),
         ("permuted", 3, 50, 7, 1)]


@pytest.mark.parametrize("kind,n,g,tile,chunk", CASES, ids=str)
def test_partition_plain_matches_a_counting_sort(kind, n, g, tile, chunk):
    ids = _ids(kind, n, g, tile, np.random.default_rng(n + g))
    got = seg_ops.partition_plain(torch.from_numpy(ids), g, tile, chunk)
    tiles = -(-g // tile)
    kept = np.flatnonzero((ids >= 0) & (ids < g))
    counts = np.zeros(tiles, np.int64)
    for t in ids[kept] // tile:
        counts[t] += 1
    offsets = np.concatenate([[0], np.cumsum(counts)])
    items = [max(1, -(-int(c) // chunk)) for c in counts]
    hot = [k if k > 1 else 0 for k in items]
    assert got.counts.tolist() == counts.tolist()
    assert got.offsets.tolist() == offsets.tolist()
    assert got.work_offsets.tolist() == [0] + np.cumsum(items).tolist()
    assert got.hot_offsets.tolist() == (np.cumsum(hot) - hot).tolist()
    order = got.order.numpy()
    assert sorted(order.tolist()) == kept.tolist()   # each kept row once
    for t in range(tiles):                           # ... in its bucket
        rows = order[offsets[t]:offsets[t + 1]]
        assert np.all(ids[rows] // tile == t)
        assert np.all(np.diff(rows) > 0)             # input order inside
    assert got.offsets[-1] == kept.size
    if kind == "hot":
        assert int((got.work_offsets.diff() > 1).sum()) == 1
    if kind == "sparse":
        assert int((got.counts == 0).sum()) > tiles // 2


def test_partitioned_rows_give_the_table_of_the_rows_and_the_reference():
    """G = 300 over tiles of 8 groups: the plain table of the rows in
    bucket order equals that of the rows as given, and the JAX package's
    ``segment_agg_ref``, bit for bit."""
    g, tile = 300, 8
    rng = np.random.default_rng(3)
    n = 2000
    x = (rng.standard_normal((n, 3)) * np.exp(
        rng.standard_normal((n, 3)) * 3)).astype(np.float32)
    ids = rng.integers(0, g, n).astype(np.int32)
    spec, rspec = ReproSpec(L=2), RefSpec(dtype=jnp.float32, L=2)
    xt, it = torch.from_numpy(x), torch.from_numpy(ids)
    e1 = acc.required_e1(xt, spec, axis=0)
    A, iu = rsum_ops.ladder(e1, spec, (0, spec.L))
    part = seg_ops.partition_plain(it, g, tile, 64)
    assert part.counts.numel() == 38 and part.offsets[-1] == n
    k, c = seg_ops.segment_levels_plain(xt, it, g, A, iu, spec)
    kp, cp = seg_ops.segment_levels_plain(xt[part.order], it[part.order], g,
                                          A, iu, spec)
    assert torch.equal(k, kp) and torch.equal(c, cp)
    ref = segment_agg_ref(x, ids, g, rspec, e1=np.asarray(e1))
    assert np.asarray(ref.k).tobytes() == k.numpy().tobytes()
    assert np.asarray(ref.C).tobytes() == c.numpy().tobytes()
    got = seg_ops.segment_agg_kernel(x[part.order.numpy()],
                                     ids[part.order.numpy()], g, spec,
                                     group_tile=tile, device="cpu")
    assert np.asarray(ref.k).tobytes() == got.k.numpy().tobytes()


# (n, G, ncols, nlev): TPC-H Q18's inner GROUP BY at SF10, the embedding
# gradient of a 49,152-token vocabulary (1,024 rows, 576 columns), a
# 64,128-entry vocabulary shard (256 x 3,072), one past one tile, skew-size
SHAPES = [(59_986_052, 15_000_000, 1, 2), (1024, 49_152, 576, 2),
          (256, 64_128, 3072, 2), (10_000, 14_528, 1, 2),
          (50_000, 5000, 6, 3), (1, 20_000, 1, 2)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_partitioned_launch_shape_bounds(shape):
    """Over several group tiles: one slab, a persistent grid of resident
    blocks, at least one work item a tile and at most tiles + n //
    chunk_rows, int64 partials for at most two tables a block (never a
    slabs x G array), and a scratch of the head, the item map, one copy of
    the rows and those partials."""
    n, g, ncols, nlev = shape
    for sms, per_sm in ((132, 1), (132, 4), (2, 1)):
        s = seg_ops.launch_shape(n, g, ncols, nlev, sms,
                                 blocks_per_sm=per_sm)
        assert s.path == "tiled" and s.tiles == -(-g // s.tile) > 1
        assert s.tile == seg_ops.group_limits(ncols, nlev)[1]
        assert s.slabs == 1 and s.rows_per_slab >= n
        assert s.blocks == sms * per_sm
        assert s.chunk_rows >= max(seg_ops.MIN_CHUNK_ROWS, n / s.blocks)
        assert s.work_items == s.tiles + n // s.chunk_rows
        assert s.partials == 2 * n // (s.chunk_rows + 1) <= 2 * s.blocks
        table = 8 * s.tile * ncols * nlev               # one int64 partial
        assert table <= seg_ops.SMEM_BYTES
        layout = seg_ops.scratch_layout(n, ncols, nlev, s.tile, s.tiles,
                                        s.work_items, s.partials)
        assert layout[-1] == s.scratch_bytes
        assert s.scratch_bytes <= 8 * seg_ops.head_words(s.tiles) \
            + 4 * s.work_items + 4 * n * (ncols + 1) + s.partials * table \
            + 4 * 16
        assert s.partials * table <= 2 * s.blocks * seg_ops.SMEM_BYTES
        assert s.part_blocks * s.part_rows >= n
        assert (s.part_blocks - 1) * s.part_rows < max(n, 1)
        assert s.part_smem in (0, 4 * s.tiles) \
            and s.part_smem <= seg_ops.SMEM_BYTES
        assert seg_ops.launch_count(g, ncols, nlev) == 4
    assert seg_ops.launch_count(4, 6, 2) == 2            # private
    assert seg_ops.launch_count(175, 1, 2) == 2          # one tile
    assert seg_ops.launch_count(300, 2, 2, tile=8) == 4  # forced tiles


@pytest.mark.parametrize("kind", ["hot", "permuted", "sorted"])
def test_work_list_fits_the_launch(kind):
    """The work list of real ids fits the launch's bounds: items, the hot
    tiles' partial slots, and the tiles split over several items."""
    n, g, ncols, nlev = 30_000, 3 * 14_527 + 5, 1, 2
    s = seg_ops.launch_shape(n, g, ncols, nlev, 4, blocks_per_sm=1)
    ids = _ids(kind, n, g, s.tile, np.random.default_rng(5))
    p = seg_ops.partition_plain(torch.from_numpy(ids), g, s.tile,
                                s.chunk_rows)
    hot = torch.where(p.work_offsets.diff() > 1, p.work_offsets.diff(), 0)
    assert int(p.work_offsets[-1]) <= s.work_items
    assert int(hot.sum()) <= s.partials
    if kind == "hot":
        assert int(hot.sum()) > 1


def test_the_planner_keeps_partitioned_launches_under_the_row_limit():
    """Over several group tiles a launch takes fewer than 2^31 rows (its
    slots are 32-bit): the launch shape refuses more, and the cold planner
    then does not offer the kernel; in one tile, or on the private path, it
    still does."""
    from repro_torch.ops.plan import plan_groupby
    spec, q18 = ReproSpec(), 15_000_000
    big = seg_ops.PARTITION_MAX_ROWS
    assert seg_ops.launch_shape(big - 1, q18, 1, 2, 132).tiles > 1
    with pytest.raises(ValueError):
        seg_ops.launch_shape(big, q18, 1, 2, 132)
    assert seg_ops.takes_rows(big - 1, q18, 1, 2)
    assert not seg_ops.takes_rows(big, q18, 1, 2)
    assert seg_ops.takes_rows(big, 4, 6, 2)              # private
    assert seg_ops.takes_rows(big, 175, 1, 2)            # one tile
    assert plan_groupby(big - 1, q18, spec, calibration=None).method \
        == "pallas"
    assert plan_groupby(big, q18, spec, calibration=None).method \
        != "pallas"
    assert plan_groupby(big, 4, spec, ncols=6, calibration=None).method \
        == "pallas"


SPEC = ReproSpec(L=2)
PRIVATE_MAX, ONE_TILE = seg_ops.group_limits(1, SPEC.L)


@settings(max_examples=12, deadline=None, database=None)
@given(g=st.sampled_from([PRIVATE_MAX, PRIVATE_MAX + 1, ONE_TILE,
                          ONE_TILE + 1, 2 * ONE_TILE + 5]),
       seed=st.integers(0, 2**32 - 1), sort=st.booleans(),
       pad=st.booleans())
def test_groupby_parity_across_the_path_limits(g, seed, sort, pad):
    """``groupby_agg`` through the segment kernel's plain version equals
    the JAX package's ``groupby_agg`` bit for bit on random rows, with G on
    each side of the private and one-tile limits and past them, sorted or
    not, with padding or not; and the rows in bucket order give the same
    table as the rows as given."""
    rng = np.random.default_rng(seed)
    n = 128
    x = (rng.standard_normal(n) * np.exp(rng.standard_normal(n) * 4)) \
        .astype(np.float32)[:, None]
    keys = rng.integers(0, g, n).astype(np.int32)
    if sort:
        keys.sort()
    aggs = [("sum", 0), ("count",)]
    want = ref_groupby(x, keys, g, aggs, RefSpec(dtype=jnp.float32, L=2),
                       method="scatter")
    got = groupby_agg(x, keys, g, aggs, SPEC, method="pallas", device="cpu")
    for name in want:
        assert np.asarray(want[name]).tobytes() == got[name].numpy().tobytes()
    ids = torch.from_numpy(keys)
    if pad:
        ids[torch.from_numpy(rng.random(n) < 0.2)] = -1
    xt = torch.from_numpy(x)
    s = seg_ops.launch_shape(n, g, 1, SPEC.L, 132)
    p = seg_ops.partition_plain(ids, g, s.tile, s.chunk_rows or n)
    e1 = acc.required_e1(xt, SPEC, axis=0)
    A, iu = rsum_ops.ladder(e1, SPEC, (0, SPEC.L))
    a = seg_ops.segment_levels_plain(xt, ids, g, A, iu, SPEC)
    b = seg_ops.segment_levels_plain(xt[p.order], ids[p.order], g, A, iu,
                                     SPEC)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
