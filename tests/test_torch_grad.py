"""``repro_torch.optim`` against the JAX package on identical gradient trees.

The gradient sums are held to the reference bit for bit (accumulators by
value — under ``jax_enable_x64`` the reference's rsum tables are int64 —
and finalized floats by bytes): ``tree_to_acc``, ``acc_merge_tree``,
``acc_finalize_tree``, ``accumulate_microbatches``, ``flat_sum_acc``,
``repro_global_norm``, the reproducible embedding backward, and
``reduce_grads`` at world sizes 1, 2 and 4 over gloo (plain and packed).
AdamW is held to the reference within 2 float32 ulps per step (XLA's
``pow`` and ``cos`` in the schedule and bias correction are not torch's).

Gradient trees have the smollm leaf layout at a small size, with random
and adversarial magnitudes: mixed signs, 2^±60, exact zeros and
subnormals.  The ranks run in a fresh subprocess (``tests/_torch_dist.py``);
this file is also their script: ``python tests/test_torch_grad.py <world>
<out_dir>``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.optim import adamw, grad  # noqa: E402

SHAPES = {"embed": (16, 8), "final_norm": {"scale": (8,)},
          "blocks": {"attn": {"wq": (2, 8, 12), "wk": (2, 8, 4),
                              "wv": (2, 8, 4), "wo": (2, 12, 8)},
                     "ln_attn": {"scale": (2, 8)},
                     "mlp": {"w_up": (6, 8, 5)}}}
N_QUANTA = 4


def _values(shape, rng, kind):
    n = int(np.prod(shape))
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "subnormal":
        v = np.float32(1.4e-45) * rng.integers(-300, 300, n)
        return v.reshape(shape).astype(np.float32)
    v = rng.standard_normal(n) * np.exp(rng.standard_normal(n) * 4)
    v[::5] *= -1.0
    v[1::11] = 0.0
    v[2::13] = np.float32(1.4e-45) * rng.integers(1, 99, len(v[2::13]))
    v[3::17] = rng.choice([2.0 ** 60, -(2.0 ** 60), 2.0 ** -60,
                           -(2.0 ** -60)], len(v[3::17]))
    return v.reshape(shape).astype(np.float32)


def _grad_tree(seed):
    """One quantum's gradient tree (numpy float32)."""
    rng = np.random.default_rng(seed)
    kinds = {("blocks", "ln_attn", "scale"): "zeros" if seed % 3 == 0
             else "mixed",
             ("final_norm", "scale"): "subnormal"}
    return tree_mod.from_paths(
        (path, _values(shape, rng, kinds.get(path, "mixed")))
        for path, shape in tree_mod.paths(SHAPES))


def _torch_tree(tree):
    return tree_mod.tree_map(torch.from_numpy, tree)


def _spec():
    return ReproSpec(torch.float32, L=2)


# ---------------------------------------------------------------------------
# the reference, on the same trees
# ---------------------------------------------------------------------------

def _ref():
    import jax.numpy as jnp

    from repro.core.types import ReproSpec as RefSpec
    from repro.optim import grad as rgrad
    return rgrad, RefSpec(jnp.float32, L=2)


def _jnp_tree(tree):
    import jax.numpy as jnp
    return tree_mod.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _same_acc(ref, got, what):
    """Accumulators equal by value; the port keeps int32 tables."""
    for name, r, g in zip(("k", "C", "e1"), ref, got):
        assert g.dtype == torch.int32, (what, name, g.dtype)
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy().astype(np.int64),
                                      err_msg=f"{what} {name}")


def _same_bytes(ref, got, what):
    r = np.asarray(ref)
    g = got.detach().numpy()
    assert r.dtype == g.dtype and r.shape == g.shape, (what, r.dtype,
                                                      g.dtype)
    assert r.tobytes() == g.tobytes(), what


def _ref_leaves(tree):
    import jax
    from repro.core.accumulator import ReproAcc
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, ReproAcc))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_tree_to_acc_merge_finalize_match_reference():
    rgrad, rspec = _ref()
    spec = _spec()
    g1, g2 = _grad_tree(1), _grad_tree(2)
    r1, r2 = rgrad.tree_to_acc(_jnp_tree(g1), rspec), \
        rgrad.tree_to_acc(_jnp_tree(g2), rspec)
    p1, p2 = grad.tree_to_acc(_torch_tree(g1), spec), \
        grad.tree_to_acc(_torch_tree(g2), spec)
    for (path, a), b in zip(tree_mod.paths(p1), _ref_leaves(r1)):
        _same_acc(b, a, f"tree_to_acc {path}")
        assert a.e1.ndim == 0                 # one lattice per leaf
    rm = rgrad.acc_merge_tree(r1, r2, rspec)
    pm = grad.acc_merge_tree(p1, p2, spec)
    for (path, a), b in zip(tree_mod.paths(pm), _ref_leaves(rm)):
        _same_acc(b, a, f"merge {path}")
    rf = rgrad.acc_finalize_tree(rm, rspec)
    pf = grad.acc_finalize_tree(pm, spec)
    for (path, a), b in zip(tree_mod.paths(pf), _ref_leaves(rf)):
        _same_bytes(b, a, f"finalize {path}")
    for (path, z), shape in zip(tree_mod.paths(grad.acc_zeros_like(
            _torch_tree(g1), spec)), tree_mod.leaves(SHAPES)):
        assert z.k.shape == (*shape, 2) and int(z.k.abs().sum()) == 0


@pytest.mark.parametrize("mode", ["repro", "baseline"])
def test_accumulate_microbatches_matches_reference(mode):
    import jax
    import jax.numpy as jnp

    rgrad, rspec = _ref()
    spec = _spec() if mode == "repro" else None
    trees = [_grad_tree(10 + q) for q in range(N_QUANTA)]
    if spec is None:
        # XLA's CPU backend flushes subnormal operands of float adds to zero
        tiny = np.finfo(np.float32).tiny
        trees = [tree_mod.tree_map(
            lambda a: np.where(np.abs(a) < tiny, np.float32(0), a), t)
            for t in trees]
    losses = np.float32([2.5, 1.0e-3, -7.25, 3.0e7])
    stacked = tree_mod.tree_map(lambda *xs: np.stack(xs), *trees)
    mbs = {"idx": np.arange(N_QUANTA, dtype=np.int32)}

    def ref_fn(_params, mb):
        return (jax.tree.map(lambda s: jnp.asarray(s)[mb["idx"]], stacked),
                {"loss": jnp.asarray(losses)[mb["idx"]]})

    def port_fn(_params, mb):
        i = int(mb["idx"])
        return _torch_tree(trees[i]), {"loss": torch.tensor(losses[i])}

    r_acc, r_m = rgrad.accumulate_microbatches(
        ref_fn, None, {"idx": jnp.asarray(mbs["idx"])},
        rspec if spec is not None else None)
    p_acc, p_m = grad.accumulate_microbatches(
        port_fn, None, {"idx": torch.from_numpy(mbs["idx"])}, spec)
    pairs = zip(tree_mod.paths(p_acc), _ref_leaves(r_acc))
    if spec is None:
        for (path, a), b in pairs:
            _same_bytes(b, a, f"float sum {path}")
        _same_bytes(r_m["loss"], p_m["loss"], "metric")
        return
    for (path, a), b in pairs:
        _same_acc(b, a, f"accumulated {path}")
    _same_acc(r_m["loss"], p_m["loss"], "metric acc")


def test_flat_sum_and_global_norm_match_reference():
    rgrad, rspec = _ref()
    spec = _spec()
    import jax.numpy as jnp
    for seed in range(3):
        x = _values((777,), np.random.default_rng(seed), "mixed")
        _same_acc(rgrad.flat_sum_acc(jnp.asarray(x), rspec),
                  grad.flat_sum_acc(torch.from_numpy(x), spec),
                  f"flat_sum_acc {seed}")
    g = _grad_tree(5)
    _same_bytes(rgrad.repro_global_norm(_jnp_tree(g), rspec),
                grad.repro_global_norm(_torch_tree(g), spec), "norm")
    # baseline norm: float sums in another order; within 4 ulps
    np.testing.assert_allclose(
        float(grad.repro_global_norm(_torch_tree(g), None)),
        float(rgrad.repro_global_norm(_jnp_tree(g), None)), rtol=5e-7)


@pytest.mark.parametrize("chunk", [64, 4096])
def test_embedding_backward_matches_reference_scatter(chunk):
    """The embedding gradient is a GROUPBY-SUM over token ids: the port's
    autograd backward equals the reference's custom VJP and its
    ``segment_rsum(method="scatter")`` on the same cotangents and ids."""
    import jax
    import jax.numpy as jnp

    from repro.core import accumulator as racc
    from repro.core import segment as rseg
    from repro.models import common as rcommon

    _, rspec = _ref()
    spec = _spec()
    rng = np.random.default_rng(chunk)
    vocab, d = 40, 6
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    ids = rng.integers(0, vocab, (3, 50)).astype(np.int32)
    ids[0, :7] = 3                              # a heavy repeated id
    cot = _values((3, 50, d), rng, "mixed")

    t = torch.from_numpy(table).requires_grad_(True)
    out = common.embed_lookup(t, torch.from_numpy(ids), spec, chunk=chunk)
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    out.backward(torch.from_numpy(cot))

    _, vjp = jax.vjp(lambda tb: rcommon.embed_lookup(
        tb, jnp.asarray(ids), rspec, chunk=chunk), jnp.asarray(table))
    _same_bytes(vjp(jnp.asarray(cot))[0], t.grad, "custom vjp")
    acc = rseg.segment_rsum(jnp.asarray(cot.reshape(-1, d)),
                            jnp.asarray(ids.reshape(-1)), vocab, rspec,
                            method="scatter", chunk=chunk)
    _same_bytes(racc.finalize(acc, rspec), t.grad, "segment_rsum scatter")


def _rank_trees(rank, world):
    per = N_QUANTA // world
    return [_grad_tree(20 + q) for q in range(rank * per, (rank + 1) * per)]


def _rank(rank, world):
    """Accumulate this rank's quanta, then reduce over the world."""
    import torch.distributed as dist

    spec = _spec()
    trees = _rank_trees(rank, world)

    def fn(_params, mb):
        return _torch_tree(trees[int(mb["i"])]), {}

    out = {}
    for packed in (False, True):
        accs, _ = grad.accumulate_microbatches(
            fn, None, {"i": torch.arange(len(trees))}, spec)
        g = grad.reduce_grads(accs, spec, (None,), N_QUANTA, packed=packed)
        out[f"packed={packed}"] = {
            "/".join(path): leaf.numpy().tobytes().hex()
            for path, leaf in tree_mod.paths(g)}
    dist.barrier()
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_reduce_grads_equals_reference_merge(world, tmp_path):
    """Exact all-reduce of accumulator trees at any width equals merging
    every quantum's tree in one process with the reference."""
    import jax.numpy as jnp

    rgrad, rspec = _ref()
    merged = None
    for q in range(N_QUANTA):
        acc = rgrad.tree_to_acc(_jnp_tree(_grad_tree(20 + q)), rspec)
        merged = acc if merged is None else rgrad.acc_merge_tree(
            merged, acc, rspec)
    want = {"/".join(path): np.asarray(leaf / jnp.float32(N_QUANTA))
            .tobytes().hex() for path, leaf in tree_mod.paths(
                rgrad.acc_finalize_tree(merged, rspec))}
    ranks = _torch_dist.run_ranks(__file__, world, tmp_path)
    for r, got in enumerate(ranks):
        for packed, leaves in got.items():
            assert leaves == want, (world, r, packed)


def _adamw_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"scale": rng.standard_normal((5,)).astype(np.float32)},
            "s": rng.standard_normal((2, 3, 4)).astype(np.float32) * 3}


def test_adamw_update_close_to_reference():
    import jax.numpy as jnp

    from repro.optim import adamw as radamw

    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    rcfg = radamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    params = _adamw_tree(0)
    rp = _jnp_tree(params)
    pp = _torch_tree(params)
    rs, ps = radamw.init(rp), adamw.init(pp)
    for step in range(5):
        g = _adamw_tree(100 + step)
        norm = np.float32(0.5 + 3 * step)       # clips on later steps
        np.testing.assert_allclose(
            float(adamw.schedule(cfg, ps.count)),
            float(radamw.schedule(rcfg, rs.count)), rtol=2.4e-7)
        rp, rs = radamw.update(_jnp_tree(g), rs, rp, rcfg,
                               grad_norm=jnp.float32(norm))
        pp, ps = adamw.update(_torch_tree(g), ps, pp, cfg,
                              grad_norm=torch.tensor(norm))
        assert int(ps.count) == int(rs.count) == step + 1
        for name, r, p in (("params", rp, pp), ("mu", rs.mu, ps.mu),
                           ("nu", rs.nu, ps.nu),
                           ("master", rs.master, ps.master)):
            for (path, a), b in zip(tree_mod.paths(p), _ref_leaves(r)):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(b), rtol=2.4e-7 * (step + 1),
                    atol=1e-30, err_msg=f"{name} {path} step {step}")
    # without a given norm the update computes its own float norm
    p2, _ = adamw.update(_torch_tree(_adamw_tree(7)), adamw.init(pp), pp, cfg)
    assert all(torch.isfinite(x).all() for x in tree_mod.leaves(p2))


if __name__ == "__main__":
    _torch_dist.main(_rank)


@pytest.mark.parametrize("mode", ["accumulate", "reduce"])
def test_accumulator_slices_change_no_bit(mode, monkeypatch):
    """Large leaves fold and reduce in ``ACC_SLICE``-element slices; at a
    slice of 37 elements (every leaf but the scalars sliced, ragged
    tails) the accumulators and reduced gradients have the bytes and
    shapes of one pass."""
    spec = _spec()
    trees = [_torch_tree(_grad_tree(20 + q)) for q in range(N_QUANTA)]
    mbs = {"idx": torch.arange(N_QUANTA, dtype=torch.int32)}

    def fn(_params, mb):
        return trees[int(mb["idx"])], {"loss": torch.tensor(1.0)}

    def run():
        accs, _ = grad.accumulate_microbatches(fn, None, mbs, spec)
        if mode == "accumulate":
            return [t for a in tree_mod.leaves(accs) for t in a]
        return tree_mod.leaves(grad.reduce_grads(accs, spec, (), N_QUANTA))

    whole = run()
    monkeypatch.setattr(grad, "ACC_SLICE", 37)
    sliced = run()
    assert max(t.numel() for t in whole) > 37
    for a, b in zip(whole, sliced):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_adamw_slices_change_no_bit(monkeypatch):
    """AdamW updates leaves larger than ``adamw.SLICE`` in slices; at a
    slice of 7 elements (ragged tails) the parameters and state have the
    bytes of one pass over two steps."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)

    def run():
        params = _torch_tree(_adamw_tree(0))
        state = adamw.init(params)
        for step in range(2):
            params, state = adamw.update(
                _torch_tree(_adamw_tree(100 + step)), state, params, cfg)
        return tree_mod.leaves(params) + [t for tree in state[:3]
                                          for t in tree_mod.leaves(tree)]

    whole = run()
    monkeypatch.setattr(adamw, "SLICE", 7)
    sliced = run()
    assert max(t.numel() for t in whole) > 7
    for a, b in zip(whole, sliced):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.numpy().tobytes() == b.numpy().tobytes()
