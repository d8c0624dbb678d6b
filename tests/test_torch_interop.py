"""Partial states carried from the JAX package into the port and back.

The reference aggregates half of the rows; its state crosses as numpy
leaves plus the signature's JSON, merges in the port with the port's
partial of the other half, and finalizes to the reference's one-shot
``groupby_agg`` bytes.  The halves sit on different lattices, so the merge
exercises demotion.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.types import ReproSpec as RefSpec  # noqa: E402
from repro.ops import groupby_agg as ref_groupby  # noqa: E402
from repro.ops import partial as ref_partial  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.ops import partial as port_partial  # noqa: E402

AGGS = ("sum", "count", "mean", "var", "std", "min", "max", ("sum", 1),
        ("sum_prod", 0, 1))
G = 5


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    vals = np.stack([rng.standard_normal(n) * 1e-3,
                     rng.lognormal(1.0, 1.5, n)], axis=1)
    vals[n // 2:] *= 3e4               # the second half on a coarser lattice
    vals[7] = [-0.0, 0.0]
    return vals.astype(np.float32), rng.integers(0, G, n).astype(np.int32)


def _leaves(state):
    return (state.table.k, state.table.C, state.table.e1, state.minv,
            state.maxv, state.rows)


def _same(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("dtype", ["float32"])
def test_reference_state_merges_and_finalizes_in_the_port(dtype):
    rspec = RefSpec(dtype=getattr(jnp, dtype), L=2)
    spec = ReproSpec(dtype=getattr(torch, dtype), L=2)
    vals, keys = _rows(3000, seed=1)
    vals = vals.astype(dtype)
    half = len(keys) // 2
    # full level window on the reference side: its tables equal the pruned
    # ones bit for bit, and skipping its prescan keeps the test cheap
    one_shot = ref_groupby(vals, keys, G, AGGS, rspec, method="onehot",
                           levels=None)
    ref_a = ref_partial.partial_agg(vals[:half], keys[:half], G, AGGS, rspec,
                                    method="onehot", levels=None)
    ref_b = ref_partial.partial_agg(vals[half:], keys[half:], G, AGGS, rspec,
                                    method="onehot", levels=None)
    carried = state_from_numpy([np.asarray(x) for x in _leaves(ref_a)],
                               ref_a.sig.to_json(), device="cpu")
    for x, y in zip(_leaves(ref_a), _leaves(carried)):
        _same(x, y, "carried leaf")
    ours = port_partial.partial_agg(vals[half:], keys[half:], G, AGGS, spec,
                                    device="cpu")
    for x, y in zip(_leaves(ref_b), _leaves(ours)):
        _same(x, y, "port partial")
    merged = port_partial.merge(carried, ours)
    got = port_partial.finalize(merged)
    assert list(got) == list(one_shot)
    for name in one_shot:
        _same(one_shot[name], got[name], name)
    # the round trip back: the reference's own merge, leaf for leaf
    leaves, sig_json = state_to_numpy(merged)
    assert sig_json == ref_a.sig.to_json()
    for x, y in zip(_leaves(ref_partial.merge(ref_a, ref_b)), leaves):
        _same(x, y, "round trip")
    back = state_from_numpy(dict(zip(("k", "C", "e1", "minv", "maxv",
                                      "rows"), leaves)), sig_json,
                            device="cpu")
    for x, y in zip(leaves, _leaves(back)):
        _same(x, y, "numpy -> port")


def test_state_from_numpy_checks_dtypes():
    vals, keys = _rows(64, seed=2)
    ref_a = ref_partial.partial_agg(vals, keys, G, AGGS,
                                    RefSpec(dtype=jnp.float32),
                                    method="onehot", levels=None)
    leaves = [np.asarray(x) for x in _leaves(ref_a)]
    leaves[0] = leaves[0].astype(np.int64)
    with pytest.raises(ValueError, match="dtype"):
        state_from_numpy(leaves, ref_a.sig.to_json(), device="cpu")
