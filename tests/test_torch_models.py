"""``repro_torch.models`` against the JAX package on all ten configs
(dense, moe, hybrid, xlstm, audio, vlm), ``.reduced()`` and in float32,
from the same weights (``interop.lm_params_from_numpy`` of the reference's
``init_params``).

Tolerances: the two packages sum matrix products, softmaxes and norms in
different orders, so forwards and losses agree to a few float32 ulps
(``rtol=2e-5``) and gradients to ``rtol=1e-4, atol=1e-5`` (gradient entries
are O(1e-2); the largest differences seen are about 7e-7).  Port-only
properties are exact: remat policies and the embedding-gradient chunk
change no bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.interop import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from repro_torch.models import lm, moe  # noqa: E402

ARCHS = ["llama3.2-3b", "stablelm-3b", "smollm-135m", "gemma2-27b",
         "musicgen-medium", "qwen2-vl-72b", "granite-moe-3b-a800m",
         "phi3.5-moe-42b-a6.6b", "hymba-1.5b", "xlstm-350m"]


def _cfgs(arch):
    return ref_configs.get_config(arch).reduced(), \
        configs.get_config(arch).reduced()


def _weights(rcfg, seed):
    rp = ref_lm.init_params(jax.random.PRNGKey(seed), rcfg)
    return rp, lm_params_from_numpy(jax.tree.map(np.asarray, rp),
                                    device="cpu")


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["targets"][0, -3:] = -1                       # masked positions
    if cfg.embed_frontend == "stub":
        batch["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                           * 0.02).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.rope_kind == "mrope":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, 3, S)).copy()
        pos[:, 1:] //= 2                                 # h/w ids differ
        batch["positions"] = pos
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(params, batch, cfg, **kw):
    leaves = [p.detach().requires_grad_(True) for p in
              tree_mod.leaves(params)]
    tree = tree_mod.from_paths(
        (path, leaf) for (path, _), leaf in zip(tree_mod.paths(params),
                                                leaves))
    loss, aux = lm.loss_fn(tree, _torch(batch), cfg, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, aux, [torch.zeros_like(p) if g is None else g
                       for g, p in zip(grads, leaves)]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_close_to_reference(arch):
    rcfg, cfg = _cfgs(arch)
    rp, pp = _weights(rcfg, 0)
    batch = _batch(rcfg)
    assert [p for p, _ in tree_mod.paths(pp)] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(rp)[0]]

    hidden_ref, _, _ = jax.jit(lambda p, b: ref_lm.forward(p, b, rcfg))(
        rp, _jnp(batch))
    with torch.no_grad():
        hidden, _, _ = lm.forward(pp, _torch(batch), cfg)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(hidden_ref),
                               rtol=2e-5, atol=2e-5)

    (loss_ref, aux_ref), g_ref = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(p, _jnp(batch), rcfg), has_aux=True))(rp)
    loss, aux, grads = _port_grads(pp, batch, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=2e-5)
    np.testing.assert_allclose(float(aux["xent"].detach()),
                               float(aux_ref["xent"]),
                               rtol=2e-5)
    for (path, _), g, r in zip(tree_mod.paths(pp), grads,
                               jax.tree.leaves(g_ref)):
        assert g.dtype == torch.float32 and g.shape == r.shape, path
        assert torch.isfinite(g).all(), path
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


def _decode_step(cfg, B, S, logits, seed):
    step = {}
    if cfg.embed_frontend == "stub":
        rng = np.random.default_rng(seed)
        step["embeds"] = (rng.standard_normal((B, 1, cfg.d_model))
                          * 0.02).astype(np.float32)
    else:
        step["tokens"] = np.argmax(logits[:, -1], axis=-1).astype(
            np.int32)[:, None]
    shape = (B, 3, 1) if cfg.rope_kind == "mrope" else (B, 1)
    step["positions"] = np.full(shape, S, np.int32)
    return step


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_close_to_reference(arch):
    rcfg, cfg = _cfgs(arch)
    rp, pp = _weights(rcfg, 2)
    B, S, max_seq = 2, 16, 40            # > the reduced window of 32
    batch = _batch(rcfg, B=B, S=S, seed=2)
    batch.pop("targets")
    logits_ref, caches_ref = jax.jit(
        lambda p, b: ref_lm.prefill_step(p, b, rcfg, max_seq))(
            rp, _jnp(batch))
    with torch.no_grad():
        logits, caches = lm.prefill_step(pp, _torch(batch), cfg, max_seq)
    assert logits.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref),
                               rtol=1e-4, atol=1e-4)
    step = _decode_step(cfg, B, S, np.asarray(logits_ref), seed=3)
    dec_ref, caches_ref = jax.jit(
        lambda p, c, b: ref_lm.decode_step(p, c, b, rcfg))(
            rp, caches_ref, _jnp(step))
    with torch.no_grad():
        dec, caches = lm.decode_step(pp, caches, _torch(step), cfg)
    assert torch.isfinite(dec).all()
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_ref), rtol=1e-4,
                               atol=1e-4)
    # every cache entry (KV ring buffers, SSM and xLSTM states) under the
    # reference's keys and fields
    assert sorted(caches) == sorted(caches_ref)
    for key, state in caches.items():
        ref_state = caches_ref[key]
        assert state._fields == ref_state._fields, key
        for field, t, r in zip(state._fields, state, ref_state):
            assert t.shape == r.shape, (key, field)
            np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{key}.{field}")
        if hasattr(state, "pos"):
            assert state.pos.dtype == torch.int32
            assert int(state.pos.max()) == S


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-27b", "hymba-1.5b",
                                  "xlstm-350m", "granite-moe-3b-a800m"])
def test_decode_matches_prefill_logits(arch):
    """Teacher-forced decode reproduces prefill's next-token logits (gemma2
    and hymba: through the sliding-window ring buffer, S > window; hymba and
    xlstm: through the recurrent states).  MoE: a prefill dispatches the
    whole sequence as one group of capacity C and drops what overflows,
    while a decode step's group of one token never drops; so the identity
    holds where the prefill drops nothing either, at capacity factor
    E / K (C = the group)."""
    _, cfg = _cfgs(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = lm.init_params(4, cfg, device="cpu")
    rng = np.random.default_rng(5)
    B, S = 1, 40
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1))
                            .astype(np.int32))
    with torch.no_grad():
        full, _ = lm.prefill_step(params, {"tokens": toks}, cfg, max_seq=48)
        _, caches = lm.prefill_step(params, {"tokens": toks[:, :S]}, cfg,
                                    max_seq=48)
        dec, _ = lm.decode_step(params, caches, {
            "tokens": toks[:, S:],
            "positions": torch.full((B, 1), S, dtype=torch.int32)}, cfg)
    torch.testing.assert_close(dec[:, -1], full[:, -1], rtol=1e-4,
                               atol=1e-4)


def test_all_cells_enumerated_as_reference():
    mine = [(n, s.name, s.seq_len, s.global_batch, s.kind)
            for n, _, s in configs.all_cells()]
    ref = [(n, s.name, s.seq_len, s.global_batch, s.kind)
           for n, _, s in ref_configs.all_cells()]
    assert mine == ref and len(mine) == 10 * 4 - 8
    for name in configs.list_archs():
        a, b = configs.get_config(name), ref_configs.get_config(name)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "hd", "attn_kind", "window", "rope_theta"):
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert a.pdtype == getattr(torch, str(b.pdtype))
        assert a.reduced().hd == b.reduced().hd


def test_remat_policies_and_embed_chunk_change_no_bit():
    rcfg, cfg = _cfgs("smollm-135m")
    _, pp = _weights(rcfg, 6)
    batch = _batch(rcfg, seed=6)
    runs = {}
    for remat in ("nothing", "dots", "none"):
        _, _, runs[remat] = _port_grads(pp, batch, cfg, remat_policy=remat)
    spec = ReproSpec(torch.float32, L=2)
    for chunk in (7, 4096):
        _, _, runs[f"embed{chunk}"] = _port_grads(
            pp, batch, cfg, repro_embed=spec, embed_chunk=chunk)
    for name in ("dots", "none"):
        for a, b in zip(runs["nothing"], runs[name]):
            assert torch.equal(a, b), name
    for a, b in zip(runs["embed7"], runs["embed4096"]):
        assert torch.equal(a, b)
    # the reproducible embedding gradient is the same sum, exactly rounded
    torch.testing.assert_close(runs["embed7"][9], runs["nothing"][9],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_remat_policies_change_no_bit_in_recurrent_units(arch):
    """The units' remat (``nothing``, ``dots``, ``none``) around the scan's
    own checkpointed time chunks: 72 steps are a chunk of 64 and an exact
    tail of 8.  Every policy gives the same gradient bits."""
    rcfg, cfg = _cfgs(arch)
    _, pp = _weights(rcfg, 6)
    batch = _batch(rcfg, B=1, S=72, seed=6)
    runs = {remat: _port_grads(pp, batch, cfg, remat_policy=remat)
            for remat in ("nothing", "dots", "none")}
    for name in ("dots", "none"):
        assert torch.equal(runs[name][0], runs["nothing"][0]), name
        for (path, _), a, b in zip(tree_mod.paths(pp), runs["nothing"][2],
                                   runs[name][2]):
            assert torch.equal(a, b), (name, path)
    with torch.no_grad():
        loss, _ = lm.loss_fn(pp, _torch(batch), cfg)
    assert torch.equal(loss, runs["nothing"][0].detach())


def test_moe_top_k_ties_follow_the_reference():
    """Exact router ties go to the lower expert index, as ``lax.top_k``
    orders them: on a tie-heavy table, and through a whole MoE block whose
    zero router ties every expert (every token picks experts 0..K-1, and
    the capacity drops what overflows in the reference's slot order)."""
    from repro.models import moe as ref_moe

    rng = np.random.default_rng(9)
    probs = (rng.integers(0, 4, (64, 40)) / 4).astype(np.float32)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(probs), 8)
    v, i = moe.top_k(torch.from_numpy(probs), 8)
    assert i.dtype == torch.int64
    assert np.array_equal(i.numpy(), np.asarray(ref_i))
    assert np.array_equal(v.numpy(), np.asarray(ref_v))

    rcfg, cfg = _cfgs("granite-moe-3b-a800m")
    rp = ref_moe.moe_init(jax.random.PRNGKey(3), rcfg)
    rp["router"] = jnp.zeros_like(rp["router"])
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    x = (rng.standard_normal((2, 24, rcfg.d_model))).astype(np.float32)
    ref_out, ref_aux = ref_moe.moe_block(jnp.asarray(x), rp, rcfg, group=24)
    with torch.no_grad():
        out, aux = moe.moe_block(torch.from_numpy(x), pp, cfg, group=24)
    # capacity 8 of 24 tokens: the first 8 tokens keep expert 0 and 1
    assert moe.group_capacity(24, cfg) == 8
    kept = out.abs().sum(-1) > 0
    assert kept[:, :8].all() and not kept[:, 8:].any()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=2e-5,
                               atol=2e-5)
    assert list(aux) == list(ref_aux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]),
                                   rtol=1e-6)


def test_moe_prefill_length_must_split_into_groups():
    _, cfg = _cfgs("granite-moe-3b-a800m")
    params = lm.init_params(0, dataclasses.replace(cfg, moe_group=16),
                            device="cpu")
    toks = torch.zeros((1, 24), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of min"):
        lm.prefill_step(params, {"tokens": toks},
                        dataclasses.replace(cfg, moe_group=16), max_seq=32)


def test_repro_embed_grads_close_to_reference():
    from repro.core.types import ReproSpec as RefSpec

    rcfg, cfg = _cfgs("smollm-135m")
    rp, pp = _weights(rcfg, 8)
    batch = _batch(rcfg, seed=8)
    rspec = RefSpec(jnp.float32, L=2)
    g_ref = jax.jit(jax.grad(lambda p: ref_lm.loss_fn(
        p, _jnp(batch), rcfg, repro_embed=rspec, embed_chunk=64)[0]))(rp)
    _, _, grads = _port_grads(pp, batch, cfg,
                              repro_embed=ReproSpec(torch.float32, L=2),
                              embed_chunk=64)
    for g, r in zip(grads, jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def test_lm_module_param_count_and_weight_interop():
    rcfg, cfg = _cfgs("gemma2-27b")
    rp, pp = _weights(rcfg, 1)
    assert lm.param_count(pp) == ref_lm.param_count(rp)
    model = lm.LM(cfg, pp)
    names = dict(model.named_parameters())
    assert "blocks.local.attn.wq" in names and "embed" in names
    assert sum(p.numel() for p in model.parameters()) == lm.param_count(pp)
    for (path, a), (_, b) in zip(tree_mod.paths(model.tree()),
                                 tree_mod.paths(pp)):
        assert torch.equal(a, b), path
    batch = _batch(rcfg, seed=1)
    loss, _ = model(_torch(batch))
    loss.backward()
    assert torch.isfinite(model.embed.grad).all()
    back = lm_params_to_numpy(pp)
    for a, b in zip(tree_mod.leaves(back), jax.tree.leaves(rp)):
        assert a.dtype == np.asarray(b).dtype
        assert a.tobytes() == np.asarray(b).tobytes()
    # bfloat16 weights cross with their bits
    r16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), rp)
    p16 = lm_params_from_numpy(jax.tree.map(np.asarray, r16), device="cpu")
    for a, b in zip(tree_mod.leaves(p16), jax.tree.leaves(r16)):
        assert a.dtype == torch.bfloat16
        assert a.view(torch.int16).numpy().tobytes() == \
            np.asarray(b).tobytes()
    for a, b in zip(tree_mod.leaves(lm_params_to_numpy(p16)),
                    jax.tree.leaves(r16)):
        assert a.dtype == np.asarray(b).dtype
        assert a.tobytes() == np.asarray(b).tobytes()
    # ... and hash to the reference's fingerprint, bfloat16 leaves included
    from repro.obs import fingerprint as ref_fp
    from repro_torch.obs import fingerprint as fp
    assert fp.fingerprint_pytree(p16) == ref_fp.fingerprint_pytree(
        jax.tree.map(np.asarray, r16))


def test_entry_points_default_to_the_card():
    _, cfg = _cfgs("smollm-135m")
    if torch.cuda.is_available():
        assert lm.init_params(0, cfg)["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(0, cfg)
