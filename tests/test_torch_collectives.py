"""``repro_torch.core.collectives`` over ``torch.distributed`` (gloo, CPU):
``repro_psum``, ``repro_psum_scatter`` and ``repro_psum_packed`` at world
sizes 2 and 4 give the same bytes as ``accumulator.merge_all`` of every
rank's accumulator — the port's and the JAX package's — in one group and in
a hierarchy of two; the packed wire format and ``max_axis_size`` equal the
JAX package's.

The ranks run in a fresh subprocess (``tests/_torch_dist.py``); this file
is also their script: ``python tests/test_torch_collectives.py <world>
<out_dir>``.  Each rank draws every rank's accumulators from one seed, so
the test rebuilds them in-process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro_torch.core import accumulator as acc_mod  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.core.accumulator import ReproAcc  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.interop import acc_from_numpy, acc_to_numpy  # noqa: E402

SPECS = {"f32-L2": (torch.float32, 2), "f32-L3": (torch.float32, 3),
         "f64-L2": (torch.float64, 2)}
ROWS, COLS, REDUCED = 8, 12, 5


def _spec(name) -> ReproSpec:
    dtype, L = SPECS[name]
    return ReproSpec(dtype=dtype, L=L)


def _accs(name, rank):
    """Rank ``rank``'s accumulators (per-element e1, and the per-tensor e1
    a reduce-scatter needs), each rank on its own magnitude so the merge
    demotes."""
    spec = _spec(name)
    rng = np.random.default_rng(1000 + 17 * rank + len(name))
    x = torch.from_numpy(rng.standard_normal((ROWS, COLS, REDUCED))
                         * 10.0 ** (3 * rank)).to(spec.dtype)
    x[rank % ROWS, :, 0] = -0.0
    acc = acc_mod.from_values(x, spec, axis=2)
    e1 = acc_mod.required_e1(x, spec)
    one = acc_mod.from_values(x, spec, axis=2, e1=e1)
    return acc, ReproAcc(k=one.k, C=one.C, e1=e1)


def _hex(acc):
    return [[str(t.dtype), list(t.shape), t.numpy().tobytes().hex()]
            for t in acc]


def _hierarchy(rank):
    """World 4 as 2 x 2: this rank's (row, column) groups."""
    import torch.distributed as dist

    rows = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    cols = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    return [rows[rank // 2], cols[rank % 2]]


def _rank(rank, world):
    out = {}
    layouts = {"world": None}
    if world == 4:
        layouts["2x2"] = _hierarchy(rank)
    for name in SPECS:
        spec = _spec(name)
        acc, one = _accs(name, rank)
        for layout, groups in layouts.items():
            out[f"{name}/{layout}/psum"] = _hex(
                collectives.repro_psum(acc, spec, groups))
            out[f"{name}/{layout}/packed"] = _hex(
                collectives.repro_psum_packed(acc, spec, groups))
            for dim in (0, 1):
                out[f"{name}/{layout}/scatter{dim}"] = _hex(
                    collectives.repro_psum_scatter(one, spec, groups,
                                                   dim=dim))
    return out


def _reference_merge_all(accs, name):
    """The JAX package's merge_all of the port's accumulators, back in the
    port."""
    import jax.numpy as jnp

    from repro.core import accumulator as ref_acc
    from repro.core.types import ReproSpec as RefSpec

    dtype, L = SPECS[name]
    rspec = RefSpec(dtype=jnp.float32 if dtype == torch.float32
                    else jnp.float64, L=L)
    merged = ref_acc.merge_all(
        [ref_acc.ReproAcc(*acc_to_numpy(a)) for a in accs], rspec)
    return acc_from_numpy(merged, _spec(name), device="cpu")


def _slice(acc, dim, index, parts):
    """The ``index``-th of ``parts`` equal slices along batch ``dim``."""
    size = acc.k.shape[dim] // parts
    k, C = (torch.narrow(t, dim, index * size, size) for t in acc[:2])
    return ReproAcc(k=k, C=C, e1=acc.e1)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_equal_merge_all(world, tmp_path):
    ranks = _torch_dist.run_ranks(__file__, world, tmp_path)
    for name in SPECS:
        spec = _spec(name)
        accs = [_accs(name, r) for r in range(world)]
        full = acc_mod.merge_all([a for a, _ in accs], spec)
        one = acc_mod.merge_all([o for _, o in accs], spec)
        assert one.e1.ndim == 0
        assert _hex(_reference_merge_all([a for a, _ in accs], name)) == \
            _hex(full)
        layouts = ["world"] + (["2x2"] if world == 4 else [])
        for r, got in enumerate(ranks):
            for layout in layouts:
                assert got[f"{name}/{layout}/psum"] == _hex(full)
                assert got[f"{name}/{layout}/packed"] == _hex(full)
                for dim in (0, 1):
                    if layout == "world":
                        want = _slice(one, dim, r, world)
                    else:   # the row group's slice, then the column group's
                        want = _slice(_slice(one, dim, r % 2, 2), dim,
                                      r // 2, 2)
                    assert got[f"{name}/{layout}/scatter{dim}"] == \
                        _hex(want), (name, layout, dim, r)


def test_pack_and_bounds_equal_reference():
    import jax.numpy as jnp

    from repro.core import accumulator as ref_acc
    from repro.core import collectives as ref_coll
    from repro.core.types import ReproSpec as RefSpec

    for dtype, L in ((jnp.float32, 2), (jnp.float32, 3), (jnp.float64, 2)):
        rspec = RefSpec(dtype=dtype, L=L)
        spec = ReproSpec(dtype=torch.float32 if dtype == jnp.float32
                         else torch.float64, L=L)
        assert collectives.max_axis_size(spec) == \
            ref_coll.max_axis_size(rspec)
        if spec.m > 30:
            continue                    # the packed layout is f32 only
        rng = np.random.default_rng(L)
        x = (rng.standard_normal((64, 33))
             * np.exp(rng.standard_normal((64, 1)) * 4)).astype(np.float32)
        racc = ref_acc.from_values(x, rspec, axis=1)
        acc = acc_from_numpy(racc, spec, device="cpu")
        word, e1 = collectives.pack_acc(acc, spec)
        rword, _ = ref_coll.pack_acc(racc, rspec)
        assert word.dtype == torch.int32
        assert word.numpy().tobytes() == np.asarray(rword).tobytes()
        for a, b in zip(collectives.unpack_acc(word, e1, spec), acc):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_group_larger_than_the_exact_bound_raises(monkeypatch):
    spec = ReproSpec()
    acc = acc_mod.from_values(torch.ones(4, 3), spec, axis=1)
    monkeypatch.setattr(collectives.dist, "get_world_size",
                        lambda group=None: collectives.max_axis_size(spec)
                        + 1)
    with pytest.raises(ValueError, match="exact-sum bound"):
        collectives.repro_psum(acc, spec)
    with pytest.raises(ValueError, match="per-tensor e1"):
        collectives.repro_psum_scatter(acc, spec)


if __name__ == "__main__":
    _torch_dist.main(_rank)
