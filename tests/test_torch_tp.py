"""Tensor parallelism over the ``model`` axis (``repro_torch.models.tp``,
``launch/mesh.py``, ``launch/shardings.py``), on gloo ranks on the CPU.

The JAX package's own model-axis path does not run on this jax version
(``ShardingTypeError`` in ``embed_lookup``), so its numbers cannot be the
oracle at ``model > 1``.  The port is held:

* at ``model`` 2 and 4 against itself at ``model`` 1, on reduced dense
  (llama), MoE (granite), hybrid (hymba), xLSTM and stub-frontend
  (musicgen) configs in float32: losses within ``LOSS_RTOL``, gathered
  gradients within ``GRAD_RTOL``/``GRAD_ATOL`` (the row-parallel products
  and the vocabulary's log-sum-exp add in another order; the same bounds
  as ``tests/test_torch_models.py`` against the reference), served tokens
  equal and logits within ``LOGIT_TOL``; the ``repro_embed`` gradient
  (a GROUPBY over each rank's vocabulary shard) likewise;
* at ``model`` 1 the port keeps its bits (every earlier port test is
  unchanged), and the reference's weights go ``interop`` -> shard ->
  gather bit for bit, with the sharded loss within ``LOSS_RTOL`` of the
  reference's ``lm.loss_fn``;
* at a fixed ``model`` 2 to the paper's claim: ``repro`` and
  ``repro_zero2`` at data 1 and 2, ``packed_wire`` and a rerun give equal
  losses, parameter digests and optimizer digests, and so does
  ``repro_embed`` at data 1 and 2; a checkpoint written at
  ``(data, model) = (2, 2)`` resumes at ``(1, 2)`` on the same bits and
  at ``(1, 1)`` within ``LOSS_RTOL``; replicated leaves are bit-identical
  across the model ranks after training.

Each world size runs in a fresh subprocess (``tests/_torch_dist.py``);
this file is also its script: ``python tests/test_torch_tp.py <world>
<out_dir> models|train [ckpt_dir]``.
"""
import contextlib
import dataclasses
import io
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.core.types import ReproSpec  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.launch.specs import param_specs  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.launch.train_step import TrainConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import tp as tp_mod  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

FAMILIES = ["llama3.2-3b", "granite-moe-3b-a800m", "hymba-1.5b",
            "xlstm-350m", "musicgen-medium"]
LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LOGIT_TOL = 1e-4
TRAIN_ARCH = "llama3.2-3b"
TRAIN_SHAPE = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
STEPS = 3
SERVE = {"prompt_len": 12, "gen": 6, "batch": 2}
REPRO_EMBED = ReproSpec(torch.float32)


def _cfg(arch):
    return configs.get_config(arch).reduced()


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["targets"][0, -3:] = -1
    if cfg.embed_frontend == "stub":
        batch["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                           * 0.02).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_grads(params, cfg, tp=None, repro_embed=None):
    items = list(tree_mod.paths(params))
    req = [p.detach().requires_grad_(True) for _, p in items]
    tree = tree_mod.from_paths((path, r) for (path, _), r in zip(items, req))
    loss, aux = lm.loss_fn(tree, _batch(cfg), cfg, tp=tp,
                           repro_embed=repro_embed)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(r) if g is None else g
             for g, r in zip(grads, req)]
    return loss.detach(), tree_mod.from_paths(
        (path, g) for (path, _), g in zip(items, grads))


def _prompts(cfg):
    rng = np.random.default_rng(9)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE["batch"], SERVE["prompt_len"])).astype(np.int32))


def _serve(params, cfg, mesh=None):
    from repro_torch.launch import serve
    toks, _, logits = serve.generate_with_stats(
        params, cfg, _prompts(cfg), SERVE["prompt_len"] + SERVE["gen"],
        SERVE["gen"], return_logits=True, mesh=mesh)
    return toks, logits


def _flat(tree) -> dict:
    return {"/".join(p): t.detach().numpy() for p, t in tree_mod.paths(tree)}


def _unflat(npz) -> dict:
    return tree_mod.from_paths((tuple(k.split("/")), npz[k]) for k in npz)


def _tc(mode, steps=STEPS, **kw):
    return TrainConfig(grad_mode=mode, mb_size=1,
                       adamw=AdamWConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=steps), **kw)


def _summary(res):
    return {"losses": [float(v).hex() for _, v in res.losses],
            "values": [v for _, v in res.losses],
            "restarts": res.restarts, **res.fingerprints}


def _train(mesh=None, mode="repro_zero2", steps=STEPS, **kw):
    tc_kw = {k: kw.pop(k) for k in ("packed_wire", "repro_embed")
             if k in kw}
    return train_loop(_cfg(TRAIN_ARCH), TRAIN_SHAPE,
                      _tc(mode, steps, **tc_kw), mesh, steps=steps, seed=3,
                      log_every=10 ** 9, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the rank programs


def _rank_models(rank, world):
    """model = world, data = 1: losses and gathered gradients of every
    family, the shard round trips, the reference's weights, the vocabulary
    functions, the attention shard modes, serving and the CLIs."""
    out_dir = Path(sys.argv[2])
    mesh = make_mesh(data=1, model=world)
    tp = mesh.tp
    out = {"shape": mesh.shape, "families": {}}
    grads = {}
    for arch in FAMILIES:
        cfg = _cfg(arch)
        full = lm.init_params(0, cfg, "cpu")
        local = sh.shard_params(full, mesh, cfg)
        back = sh.gather_params(local, mesh, cfg)
        loss, g = _loss_grads(local, cfg, tp)
        g = sh.gather_params(g, mesh, cfg)
        grads.update({f"{arch}/{k}": v for k, v in _flat(g).items()})
        out["families"][arch] = {
            "loss": float(loss),
            "roundtrip": all(torch.equal(a, b) for a, b in zip(
                tree_mod.leaves(full), tree_mod.leaves(back))),
            "split": sum(a.shape != b.shape for a, b in zip(
                tree_mod.leaves(full), tree_mod.leaves(local)))}
    # the reproducible embedding gradient over the vocabulary shards
    cfg = _cfg("llama3.2-3b")
    local = sh.shard_params(lm.init_params(0, cfg, "cpu"), mesh, cfg)
    loss, g = _loss_grads(local, cfg, tp, REPRO_EMBED)
    out["repro_embed_loss"] = float(loss)
    grads.update({f"repro_embed/{k}": v for k, v in _flat(
        sh.gather_params(g, mesh, cfg)).items()})
    # the reference's weights through interop, sharded and gathered
    from repro_torch.interop import lm_params_from_numpy
    with np.load(out_dir / "ref_params.npz") as npz:
        ref = lm_params_from_numpy(_unflat(npz), device="cpu")
    cfg = _cfg("llama3.2-3b")
    local = sh.shard_params(ref, mesh, cfg)
    back = sh.gather_params(local, mesh, cfg)
    out["ref_roundtrip"] = all(
        torch.equal(a, b) and a.dtype == b.dtype
        for a, b in zip(tree_mod.leaves(ref), tree_mod.leaves(back)))
    out["ref_loss"] = float(_loss_grads(local, cfg, tp)[0])
    # the vocabulary functions on logits with planted ties
    gen = torch.Generator().manual_seed(11)
    V = 64 * world
    logits = torch.randint(0, 5, (6, V), generator=gen).to(torch.float32)
    logits[0, :] = 7.0                          # tie over every shard
    logits[1, V - 1] = logits[1, V // 2] = 9.0  # tie across the last shards
    logits[2, 3] = 9.0
    shard = logits.narrow(1, tp.rank * (V // world), V // world)
    out["argmax"] = tp_mod.vocab_argmax(shard, tp).tolist()
    out["argmax_want"] = torch.argmax(logits, dim=-1).tolist()
    lse = tp_mod.vocab_logsumexp(shard, tp)
    out["lse_err"] = float((lse - torch.logsumexp(logits, -1)).abs().max())
    cfg = _cfg("llama3.2-3b")
    table = lm.init_params(0, cfg, "cpu")["embed"]
    hidden = torch.randn((2, 24, cfg.d_model), generator=gen)
    targets = _batch(cfg)["targets"]
    from repro_torch.models import common
    out["xent"] = float(common.chunked_xent(hidden, table, targets, cfg,
                                            chunk=8))
    out["xent_tp"] = float(common.chunked_xent(
        hidden, sh.shard_params({"embed": table}, mesh, cfg)["embed"],
        targets, cfg, chunk=8, tp=tp))
    # the attention shard modes
    out["modes"] = {}
    for mode in ("auto", "heads", "replicate"):
        cfg = dataclasses.replace(_cfg("llama3.2-3b"), attn_shard=mode)
        try:
            local = sh.shard_params(lm.init_params(0, cfg, "cpu"), mesh, cfg)
        except ValueError as exc:     # 'heads' where they do not divide
            out["modes"][mode] = {"error": str(exc)}
            continue
        out["modes"][mode] = {
            "loss": float(_loss_grads(local, cfg, tp)[0]).hex(),
            "wq": list(local["blocks"]["attn"]["wq"].shape)}
    # serving: the batch over data 1, weights and caches over the model axis
    serve_out = {}
    for arch in ("llama3.2-3b", "granite-moe-3b-a800m"):
        cfg = _cfg(arch)
        local = sh.shard_params(lm.init_params(0, cfg, "cpu"), mesh, cfg)
        toks, logits = _serve(local, cfg, mesh)
        toks2, logits2 = _serve(local, cfg, mesh)
        serve_out[f"{arch}/tokens"] = toks.numpy()
        serve_out[f"{arch}/logits"] = logits.numpy()
        out[f"{arch}/rerun_equal"] = bool(
            torch.equal(toks, toks2) and torch.equal(logits, logits2))
    if rank == 0:
        np.savez(out_dir / "grads.npz", **grads)
        np.savez(out_dir / "serve.npz", **serve_out)
    if world == 2:
        out["cli"] = _clis()
    return out


def _clis() -> dict:
    """Both CLIs with the mesh flags, in this rank's process group."""
    from repro_torch.launch import serve, train
    out = {}
    for name, fn, argv in (
            ("train", train.main, [
                "--arch", "smollm-135m", "--reduced", "--steps", "2",
                "--seq-len", "16", "--global-batch", "2", "--device", "cpu",
                "--data", "1", "--model", "2"]),
            ("serve", serve.main, [
                "--arch", "llama3.2-3b", "--reduced", "--batch", "2",
                "--prompt-len", "8", "--gen", "4", "--device", "cpu",
                "--model", "2"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        out[name] = {"rc": rc, "stdout": buf.getvalue()}
    return out


def _rank_train(rank, world):
    """model = 2, data = world / 2: the repro modes, packed_wire, a rerun,
    a checkpoint written at (2, 2) and resumed at (1, 2), and the bytes of
    every replicated leaf on this rank."""
    ckpt = Path(sys.argv[4])
    mesh = make_mesh(data=world // 2, model=2)
    out = {"shape": mesh.shape}
    res = _train(mesh, "repro_zero2")
    out["repro_zero2"] = _summary(res)
    out["repro"] = _summary(_train(mesh, "repro"))
    out["repro_embed"] = _summary(_train(mesh, steps=2, repro_embed=True))
    if world == 4:
        out["packed_wire"] = _summary(_train(mesh, "repro",
                                             packed_wire=True))
        out["written"] = _summary(_train(mesh, steps=STEPS - 1,
                                         ckpt_dir=str(ckpt), ckpt_every=1))
    else:
        out["rerun"] = _summary(_train(mesh, "repro_zero2"))
        out["resumed"] = _summary(_train(mesh, ckpt_dir=str(ckpt),
                                         resume=True, ckpt_every=STEPS))
    # the replicated leaves after training: compare across model ranks
    params, step = _final_params(mesh)
    out["replicated"] = {
        "/".join(p): t.numpy().tobytes().hex()
        for (p, t), dim in zip(tree_mod.paths(params),
                               tree_mod.leaves(step.mdims))
        if dim is None}
    return out


def _final_params(mesh):
    """This rank's parameters after the 3-step ``repro_zero2`` run, and
    its train step."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import build_batch
    from repro_torch.launch.train_step import local_quanta, make_train_step
    cfg = _cfg(TRAIN_ARCH)
    step = make_train_step(cfg, _tc("repro_zero2"), mesh, TRAIN_SHAPE,
                           device="cpu")
    params = sh.shard_params(lm.init_params(3, cfg, "cpu"), mesh, cfg)
    opt = step.init_opt(params)
    dcfg = DataConfig(seed=3, global_batch=TRAIN_SHAPE.global_batch,
                      seq_len=TRAIN_SHAPE.seq_len, vocab=cfg.vocab)
    lo, hi = local_quanta(mesh, TRAIN_SHAPE.global_batch)
    for s in range(STEPS):
        params, opt, _ = step(params, opt, build_batch(
            dcfg, cfg, s, TRAIN_SHAPE.global_batch, 1, lo, hi, "cpu"))
    return params, step


# ---------------------------------------------------------------------------
# fixtures: one subprocess per world size


@pytest.fixture(scope="module", autouse=True)
def _one_intraop_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_llama(tmp_path_factory):
    """The reference's reduced llama weights and its loss on ``_batch``."""
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import lm as ref_lm
    rcfg = ref_configs.get_config("llama3.2-3b").reduced()
    rp = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch(_cfg(
        "llama3.2-3b")).items()}
    loss, _ = jax.jit(lambda p: ref_lm.loss_fn(p, batch, rcfg))(rp)
    flat = {"/".join(k.key for k in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(rp)[0]}
    return flat, float(loss)


@pytest.fixture(scope="module")
def models(tmp_path_factory, ref_llama):
    """``models(world)``: the ranks' records and output directory of
    :func:`_rank_models` at that model size (run once per size)."""
    runs = {}

    def run(world):
        if world not in runs:
            out_dir = tmp_path_factory.mktemp(f"models{world}")
            np.savez(out_dir / "ref_params.npz", **ref_llama[0])
            runs[world] = (_torch_dist.run_ranks(
                __file__, world, out_dir, ("models",)), out_dir)
        return runs[world]
    return run


@pytest.fixture(scope="module")
def model1():
    """The port at model size 1: losses, gradients and served outputs."""
    out = {}
    for arch in FAMILIES:
        cfg = _cfg(arch)
        loss, g = _loss_grads(lm.init_params(0, cfg, "cpu"), cfg)
        out[arch] = (float(loss), g)
    for arch in ("llama3.2-3b", "granite-moe-3b-a800m"):
        cfg = _cfg(arch)
        out[f"{arch}/serve"] = _serve(lm.init_params(0, cfg, "cpu"), cfg)
    cfg = _cfg("llama3.2-3b")
    loss, g = _loss_grads(lm.init_params(0, cfg, "cpu"), cfg,
                          repro_embed=REPRO_EMBED)
    out["repro_embed"] = (float(loss), g)
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_ckpt")


@pytest.fixture(scope="module")
def train4(tmp_path_factory, ckpt_dir):
    return _torch_dist.run_ranks(__file__, 4, tmp_path_factory.mktemp(
        "train4"), ("train", str(ckpt_dir)))


@pytest.fixture(scope="module")
def train2(tmp_path_factory, ckpt_dir, train4):
    resume = tmp_path_factory.mktemp("resume12") / "ckpt"
    shutil.copytree(ckpt_dir, resume)
    return _torch_dist.run_ranks(__file__, 2, tmp_path_factory.mktemp(
        "train2"), ("train", str(resume)))


# ---------------------------------------------------------------------------
# tests


@pytest.mark.parametrize("size", [1, 2, 4])
def test_shard_then_concatenate_is_the_identity(size):
    """Every rank's ``shard_params`` shard, concatenated along the
    layout's model dim, is the full tree, bit for bit; model size 1 is the
    tree itself."""
    for arch in FAMILIES:
        cfg = _cfg(arch)
        full = lm.init_params(0, cfg, "cpu")
        shards = [sh.shard_params(full, Mesh((), 1, 0, tp_mod.TP(
            None, size, r)), cfg) for r in range(size)]
        if size == 1:
            assert shards[0] is full
        specs = param_specs(cfg, {"data": 1, "model": size})
        for (path, t), spec, *parts in zip(
                tree_mod.paths(full), tree_mod.leaves(specs),
                *map(tree_mod.leaves, shards)):
            dim = sh.model_dim(spec.pspec)
            got = parts[0] if dim is None else torch.cat(parts, dim)
            assert torch.equal(got, t), (arch, path)
            assert dim is None or parts[0].shape[dim] * size == t.shape[dim]


def test_layout_rules():
    """Attention splits only where both head counts divide the model size
    (smollm's 9 heads and hymba's 25 replicate); granite's vocabulary
    49155 keeps its embedding whole; attn_shard picks the mode."""
    def spec(arch, path, m, **kw):
        cfg = dataclasses.replace(configs.get_config(arch), **kw)
        shapes = sh.full_shapes(cfg)
        for p, s in tree_mod.paths(shapes):
            if p == path:
                return sh.layout_pspec(p, s, cfg, {"data": 1, "model": m})
    wq = ("blocks", "attn", "wq")
    assert spec("llama3.2-3b", wq, 2) == (None, None, "model")
    assert spec("llama3.2-3b", wq, 16) == (None, None, None)    # kv 8
    assert spec("smollm-135m", wq, 2) == (None, None, None)
    assert spec("hymba-1.5b", wq, 2) == (None, None, None)
    assert spec("llama3.2-3b", wq, 2, attn_shard="replicate") == \
        (None, None, None)
    assert spec("granite-moe-3b-a800m", ("embed",), 2) == (None, None)
    assert spec("granite-moe-3b-a800m", ("blocks", "moe", "w_up"), 2) == \
        (None, "model", None, None)
    assert spec("hymba-1.5b", ("blocks", "ssm", "w_bcdt"), 2) == \
        (None, "model", None)
    with pytest.raises(ValueError, match="heads"):
        spec("smollm-135m", wq, 2, attn_shard="heads")


WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gathered_grads_match_model_one(models, model1, arch,
                                                 world):
    ranks, out_dir = models(world)
    want_loss, want_grads = model1[arch]
    for r, rank in enumerate(ranks):
        fam = rank["families"][arch]
        assert fam["roundtrip"], (world, r)
        assert fam["split"] > 0, (world, arch)
        np.testing.assert_allclose(fam["loss"], want_loss, rtol=LOSS_RTOL)
    assert len({rank["families"][arch]["loss"] for rank in ranks}) == 1
    with np.load(out_dir / "grads.npz") as npz:
        for path, g in tree_mod.paths(want_grads):
            got = npz[f"{arch}/" + "/".join(path)]
            np.testing.assert_allclose(got, g.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=str(path))


@pytest.mark.parametrize("world", WORLDS)
def test_repro_embed_grads_match_model_one(models, model1, world):
    """The reproducible embedding gradient (``repro_embed``: a GROUPBY over
    each rank's vocabulary shard, zero rows for the ids it does not hold):
    the loss and the gathered gradients within the tolerances of
    model size 1's."""
    ranks, out_dir = models(world)
    want_loss, want_grads = model1["repro_embed"]
    for rank in ranks:
        np.testing.assert_allclose(rank["repro_embed_loss"], want_loss,
                                   rtol=LOSS_RTOL)
    with np.load(out_dir / "grads.npz") as npz:
        for path, g in tree_mod.paths(want_grads):
            got = npz["repro_embed/" + "/".join(path)]
            np.testing.assert_allclose(got, g.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=str(path))


@pytest.mark.parametrize("world", WORLDS)
def test_reference_weights_round_trip_and_loss(models, ref_llama, world):
    """reference params -> interop -> shard -> gather is the identity,
    and the sharded loss is the reference's within LOSS_RTOL."""
    ranks, _ = models(world)
    for rank in ranks:
        assert rank["ref_roundtrip"]
        np.testing.assert_allclose(rank["ref_loss"], ref_llama[1],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_argmax_ties_and_vocab_parallel_xent(models, world):
    ranks, _ = models(world)
    for rank in ranks:
        assert rank["argmax"] == rank["argmax_want"]
        assert rank["argmax"][0] == 0 and rank["argmax"][1] == \
            rank["argmax_want"][1]
        assert rank["lse_err"] < 1e-5
        np.testing.assert_allclose(rank["xent_tp"], rank["xent"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_attention_shard_modes(models, world):
    """The port's twin of the reference's ``test_attn_shard_modes_smoke``:
    at model size 1 the three modes give the same float32 loss bytes; on
    the axis ``auto`` and ``heads`` split the heads (the same bytes) and
    ``replicate`` keeps them whole, within LOSS_RTOL."""
    cfg = _cfg("llama3.2-3b")
    one = {m: float(_loss_grads(lm.init_params(0, dataclasses.replace(
        cfg, attn_shard=m), "cpu"), cfg)[0]).hex()
        for m in ("auto", "heads", "replicate")}
    assert len(set(one.values())) == 1
    ranks, _ = models(world)
    for rank in ranks:
        modes = rank["modes"]
        heads = cfg.n_heads * cfg.hd
        split = cfg.n_kv_heads % world == 0
        if split:
            assert modes["auto"] == modes["heads"]
        else:
            assert "n_kv_heads 2" in modes["heads"]["error"]
        assert modes["auto"]["wq"][-1] == (heads // world if split
                                           else heads)
        assert modes["replicate"]["wq"][-1] == heads
        np.testing.assert_allclose(float.fromhex(modes["replicate"]["loss"]),
                                   float.fromhex(one["auto"]),
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-3b-a800m"])
def test_serving_on_the_model_axis(models, model1, arch, world):
    """Greedy tokens equal model size 1's, logits within LOGIT_TOL, and a
    second generate gives the same bytes."""
    ranks, out_dir = models(world)
    toks, logits = model1[f"{arch}/serve"]
    with np.load(out_dir / "serve.npz") as npz:
        np.testing.assert_array_equal(npz[f"{arch}/tokens"], toks.numpy())
        np.testing.assert_allclose(npz[f"{arch}/logits"], logits.numpy(),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert all(rank[f"{arch}/rerun_equal"] for rank in ranks)


def test_clis_take_the_mesh_flags(models):
    """``train --data 1 --model 2`` and ``serve --model 2`` in the ranks of
    the model-2 run."""
    ranks, _ = models(2)
    for rank in ranks:
        cli = rank["cli"]
        assert cli["train"]["rc"] == 0 and cli["serve"]["rc"] == 0
        assert "trained 2 steps" in cli["train"]["stdout"]
        assert "'model': 2" in cli["train"]["stdout"]
        assert "generated (2, 4) tokens" in cli["serve"]["stdout"]


_RUN_KEYS = ("losses", "loss_trajectory", "params", "opt")


def test_fixed_layout_bitwise_across_widths_modes_and_reruns(train4,
                                                             train2):
    """At model 2: (data 1, data 2) x (repro_zero2, repro), packed_wire and
    a rerun: the same losses and parameter and optimizer digests on every
    rank."""
    want = {k: train2[0]["repro_zero2"][k] for k in _RUN_KEYS}
    for ranks in (train4, train2):
        for rank in ranks:
            for label in ("repro_zero2", "repro", "packed_wire", "rerun"):
                if label in rank:
                    assert {k: rank[label][k] for k in _RUN_KEYS} == want, \
                        (rank["shape"], label)
    assert train4[0]["shape"] == {"data": 2, "model": 2}


def test_repro_embed_bitwise_across_data_widths(train4, train2):
    """At model 2, ``repro_embed`` training at data 1 and data 2 gives the
    same losses and parameter and optimizer digests on every rank."""
    want = {k: train2[0]["repro_embed"][k] for k in _RUN_KEYS}
    for ranks in (train4, train2):
        for rank in ranks:
            assert {k: rank["repro_embed"][k] for k in _RUN_KEYS} == want, \
                rank["shape"]
    # the same forward: the first loss is repro_zero2's
    assert want["losses"][0] == train2[0]["repro_zero2"]["losses"][0]


def test_checkpoint_resumes_at_another_mesh(train4, train2, ckpt_dir,
                                            tmp_path):
    """Written at (2, 2) after 2 steps; resumed at (1, 2) it ends on the
    bits of an uninterrupted run, and at (1, 1) within LOSS_RTOL."""
    want = train2[0]["repro_zero2"]
    for rank in train2:
        got = rank["resumed"]
        assert got["losses"] == want["losses"][STEPS - 1:]
        assert got["params"] == want["params"] and got["opt"] == want["opt"]
    resume = tmp_path / "ckpt"
    shutil.copytree(ckpt_dir, resume)
    res = _train(None, ckpt_dir=str(resume), resume=True, ckpt_every=STEPS)
    assert [s for s, _ in res.losses] == [STEPS - 1]
    np.testing.assert_allclose(res.losses[0][1], want["values"][-1],
                               rtol=LOSS_RTOL)


def test_against_model_one_and_replicated_leaves(train2):
    """The model-2 run agrees with the model-1 run within LOSS_RTOL, and
    every replicated leaf has the same bytes on both model ranks."""
    one = _summary(_train())
    np.testing.assert_allclose(train2[0]["repro_zero2"]["values"],
                               one["values"], rtol=LOSS_RTOL)
    a, b = (rank["replicated"] for rank in train2)
    assert a and a == b
    assert "final_norm/scale" in a


if __name__ == "__main__":
    _torch_dist.main(_rank_models if sys.argv[3] == "models"
                     else _rank_train)
