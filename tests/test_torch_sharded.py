"""``repro_torch.ops.sharded`` over ``torch.distributed`` (gloo, CPU): at
world sizes 1 to 4 every rank's ``sharded_groupby_agg`` gives the same
bytes, equal to the JAX package's ``groupby_agg`` over all rows — on the
dataset of ``tests/_groupby_shard_check.py`` (N = 10,007, G = 23, its 8
aggregates, float32 L = 2, seed 42) and at float64, with each process's
level window proved on its rows or the full window — and MIN/MAX keep the
signed-zero and NaN rules of the port's single-device result for any split
of the rows, an empty shard included.

The ranks run in a fresh subprocess (``tests/_torch_dist.py``); this file
is also their script: ``python tests/test_torch_sharded.py <world>
<out_dir>``.  Rank r takes the r-th of ``world`` contiguous row ranges.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.ops import groupby_agg  # noqa: E402
from repro_torch.ops.partial import partial_agg  # noqa: E402
from repro_torch.ops.sharded import (sharded_groupby_agg,  # noqa: E402
                                     sharded_partial_agg)

N, G = 10_007, 23
AGGS = [("sum", 0), ("count",), ("mean", 0), ("var", 1), ("std", 1),
        ("sum_prod", 0, 1), ("min", 0), ("max", 1)]
ZERO_AGGS = [("min", 0), ("max", 0), ("sum", 0), ("count",), ("min", 1),
             ("max", 1)]
CASES = {"f32": (np.float32, "auto"), "f64": (np.float64, "auto"),
         "f32-onehot": (np.float32, "onehot")}


def _shard_check_data():
    """tests/_groupby_shard_check.py's dataset."""
    rng = np.random.default_rng(42)
    vals = np.stack([
        rng.standard_normal(N) * np.exp(rng.standard_normal(N) * 3),
        rng.lognormal(2.0, 1.5, N),
    ], axis=1).astype(np.float32)
    return vals, rng.integers(0, G, N).astype(np.int32)


def _zero_data():
    """Signed zeros and NaNs in a few groups, spread over the whole row
    range so every split puts them on several ranks."""
    rng = np.random.default_rng(7)
    n, g = 64, 4
    vals = rng.standard_normal((n, 2)).astype(np.float32)
    keys = rng.integers(2, g, n).astype(np.int32)
    keys[::8], keys[4::8] = 0, 1
    vals[::8, 0] = np.where(np.arange(8) % 2, -0.0, 0.0)    # group 0: ±0
    vals[4::8, 0] = -0.0                                     # group 1: -0
    vals[[5, 45], 1], keys[[5, 45]] = np.nan, 2              # group 2: NaN
    return vals, keys, g


def _split(n, world, rank, empty_first=False):
    """Rank ``rank``'s contiguous row range; ``empty_first`` gives rank 0
    no rows (when there is another rank)."""
    if empty_first and world > 1:
        cuts = [0] + np.linspace(0, n, world).astype(int).tolist()
    else:
        cuts = np.linspace(0, n, world + 1).astype(int).tolist()
    return slice(cuts[rank], cuts[rank + 1])


def _hex(results: dict) -> dict:
    return {k: [str(v.dtype), v.numpy().tobytes().hex()]
            for k, v in results.items()}


def _rank(rank, world):
    spec = {"f32": ReproSpec(dtype=torch.float32, L=2),
            "f64": ReproSpec(dtype=torch.float64, L=2)}
    vals, keys = _shard_check_data()
    rows = _split(N, world, rank)
    out = {}
    for name, (dtype, method) in CASES.items():
        s = spec[name[:3]]
        x = torch.from_numpy(vals[rows].astype(dtype))
        out[name] = _hex(sharded_groupby_agg(
            x, torch.from_numpy(keys[rows]), G, AGGS, s, method=method,
            device="cpu"))
    state = sharded_partial_agg(torch.from_numpy(vals[rows]),
                                torch.from_numpy(keys[rows]), G, AGGS,
                                spec["f32"], device="cpu")
    out["table"] = [t.numpy().tobytes().hex() for t in state.table] \
        + [int(state.rows)]
    full = sharded_partial_agg(torch.from_numpy(vals[rows]),
                               torch.from_numpy(keys[rows]), G, AGGS,
                               spec["f32"], levels=None, device="cpu")
    out["table_full_window"] = [t.numpy().tobytes().hex()
                                for t in full.table] + [int(full.rows)]
    zv, zk, zg = _zero_data()
    rows = _split(len(zk), world, rank, empty_first=True)
    out["zeros"] = _hex(sharded_groupby_agg(
        torch.from_numpy(zv[rows]), torch.from_numpy(zk[rows]), zg,
        ZERO_AGGS, spec["f32"], device="cpu"))
    return out


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX package's groupby_agg over all rows, and the port's
    single-device results."""
    import jax.numpy as jnp

    from repro.core.types import ReproSpec as RefSpec
    from repro.ops import groupby_agg as ref_groupby

    vals, keys = _shard_check_data()
    want = {}
    for name, (dtype, _) in CASES.items():
        rspec = RefSpec(dtype=jnp.float32 if dtype == np.float32
                        else jnp.float64, L=2)
        res = ref_groupby(vals.astype(dtype), keys, G, AGGS, rspec)
        want[name] = {k: [np.asarray(v).dtype.name,
                          np.asarray(v).tobytes().hex()]
                      for k, v in res.items()}
    spec = ReproSpec(dtype=torch.float32, L=2)
    state = partial_agg(torch.from_numpy(vals), torch.from_numpy(keys), G,
                        AGGS, spec, device="cpu")
    want["table"] = [t.numpy().tobytes().hex() for t in state.table] + [N]
    zv, zk, zg = _zero_data()
    want["zeros"] = _hex(groupby_agg(zv, zk, zg, ZERO_AGGS, spec,
                                     device="cpu"))
    return want


def _dtype_names(d: dict) -> dict:
    return {k: [v[0].replace("torch.", ""), v[1]] for k, v in d.items()}


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_sharded_equals_single_device_reference(world, tmp_path):
    ranks = _torch_dist.run_ranks(__file__, world, tmp_path)
    want = _reference()
    for got in ranks:
        assert got == ranks[0]
        for name in CASES:
            assert _dtype_names(got[name]) == want[name], name
        assert got["table"] == want["table"]
        assert got["table_full_window"] == want["table"]
        assert got["zeros"] == want["zeros"]
    zeros = ranks[0]["zeros"]
    # the rules themselves: MAX +0.0 over {±0}, MIN -0.0, a NaN stays
    mins = np.frombuffer(bytes.fromhex(zeros["min(0)"][1]), np.float32)
    maxs = np.frombuffer(bytes.fromhex(zeros["max(0)"][1]), np.float32)
    assert np.signbit(mins[0]) and not np.signbit(maxs[0])
    assert np.signbit(mins[1]) and np.signbit(maxs[1])
    assert np.isnan(np.frombuffer(bytes.fromhex(zeros["max(1)"][1]),
                                  np.float32)[2])


def test_sharded_needs_matching_rows():
    with pytest.raises(ValueError, match="row count"):
        sharded_partial_agg(torch.ones(3), torch.zeros(2, dtype=torch.int32),
                            2, device="cpu")


if __name__ == "__main__":
    _torch_dist.main(_rank)
