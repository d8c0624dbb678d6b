"""``repro_torch.launch.specs`` against the JAX package's
``launch/specs.py``.

A fresh subprocess (this file run as a script) forces four host devices
(``XLA_FLAGS``) before it imports jax and prints, as JSON, the
reference's ``param_specs``, ``opt_specs``, ``train_batch_specs``,
``prefill_batch_specs``, ``decode_batch_specs``, ``decode_cache_specs``
and ``logits_sharding`` (shape, dtype, PartitionSpec of every leaf) on the
meshes (data, model) = (1, 1), (2, 1), (1, 2) and (2, 2), for reduced
llama3.2-3b, granite-moe, hymba, xlstm, musicgen (stub frontend) and
qwen2-vl (M-RoPE), and for full-size smollm-135m (9 heads: attention
cannot split over 2).  The port's specs must give the same entries, except
the documented differences, which are asserted as the port's own layout:

* attention ``wq``/``wk``/``wv``/``wo`` stay whole where the heads do not
  divide the model size (the reference splits smollm's ``wq`` mid-head);
* decode caches: the batch as the reference, then KV heads (head-parallel
  attention) and SSM channels over ``model``, xLSTM states whole (the
  reference puts the largest ``model``-divisible trailing dim there);
* the training batch's stub ``embeds`` are float32 (the port's data
  pipeline), where the reference declares bfloat16.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ["llama3.2-3b", "granite-moe-3b-a800m", "hymba-1.5b", "xlstm-350m",
         "musicgen-medium", "qwen2-vl-72b"]
FULL = ["smollm-135m"]                  # full size: params and optimizer
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
SHAPES = {"train": ("t", 32, 8, "train"), "prefill": ("p", 64, 4,
                                                      "prefill"),
          "decode": ("d", 64, 4, "decode")}
ATTN = {"wq", "wk", "wv", "wo"}


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    return list(e)


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _reference() -> dict:
    """The reference's specs (run in a subprocess with 4 host devices)."""
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.launch import specs
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train_step import TrainConfig
    from repro.models.config import ShapeConfig

    def tree(t):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
            spec = leaf.sharding.spec if hasattr(leaf, "sharding") else leaf
            shape = list(getattr(leaf, "shape", []))
            dtype = str(jnp.dtype(leaf.dtype)) if hasattr(leaf, "dtype") \
                else None
            out["/".join(_key(k) for k in path)] = [
                shape, dtype, [_entry(e) for e in spec]]
        return out

    out = {}
    for arch in ARCHS + FULL:
        cfg = configs.get_config(arch)
        cfg = cfg if arch in FULL else cfg.reduced()
        for data, model in MESHES:
            mesh = make_host_mesh(data=data, model=model)
            rec = {"params": tree(specs.param_specs(cfg, mesh)),
                   "opt": tree(specs.opt_specs(cfg, mesh))}
            if arch not in FULL:
                shapes = {k: ShapeConfig(*v) for k, v in SHAPES.items()}
                rec["train"] = tree(specs.train_batch_specs(
                    cfg, shapes["train"], TrainConfig(mb_size=1), mesh))
                rec["prefill"] = tree(specs.prefill_batch_specs(
                    cfg, shapes["prefill"], mesh))
                rec["decode"] = tree(specs.decode_batch_specs(
                    cfg, shapes["decode"], mesh))
                rec["cache"] = tree(specs.decode_cache_specs(
                    cfg, shapes["decode"], mesh))
                rec["logits"] = [_entry(e) for e in specs.logits_sharding(
                    cfg, shapes["decode"], mesh).spec]
            out[f"{arch}/{data}x{model}"] = rec
    return out


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, __file__], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port(tree) -> dict:
    from repro_torch import tree as tree_mod
    from repro_torch.launch.specs import TensorSpec

    def one(s):
        return [list(s.shape), str(s.dtype).replace("torch.", ""),
                [_entry(e) for e in s.pspec]]
    if isinstance(tree, tuple):           # AdamWState
        return {f"{name}/{k}" if name != "count" else name: v
                for name, sub in zip(tree._fields, tree)
                for k, v in (_port(sub).items()
                             if not isinstance(sub, TensorSpec)
                             else [("", one(sub))])}
    return {"/".join(p): one(s) for p, s in tree_mod.paths(tree)}


def _cfg(arch):
    from repro_torch import configs
    cfg = configs.get_config(arch)
    return cfg if arch in FULL else cfg.reduced()


def _attn_whole(cfg, key: str, model: int) -> bool:
    from repro_torch.models.tp import attn_heads_split
    parts = key.split("/")
    return "attn" in parts and parts[-1] in ATTN and \
        not attn_heads_split(cfg, model)


def _drop_model(entry):
    return None if entry == "model" else entry


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS + FULL)
def test_param_and_opt_specs_match_reference(reference, arch, mesh):
    from repro_torch.launch import specs
    data, model = mesh
    sizes = {"data": data, "model": model}
    cfg = _cfg(arch)
    ref = reference[f"{arch}/{data}x{model}"]
    whole = 0
    for kind, got in (("params", _port(specs.param_specs(cfg, sizes))),
                      ("opt", _port(specs.opt_specs(cfg, sizes)))):
        want = ref[kind]
        assert sorted(got) == sorted(want), kind
        for key, (shape, dtype, pspec) in want.items():
            if kind == "opt" and key == "count":
                assert got[key][:2] == [shape, dtype]
                continue
            if _attn_whole(cfg, key, model):
                whole += 1
                pspec = [_drop_model(e) for e in pspec]
            assert got[key] == [shape, dtype, pspec], (kind, key)
    if arch in FULL and model == 2:
        assert whole == 4 * 4                 # params, mu, nu, master
    # the shape a rank holds
    embed = specs.param_specs(cfg, sizes)["embed"]
    assert embed.local_shape == (cfg.vocab // model, cfg.d_model)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_logits_specs(reference, arch, mesh):
    from repro_torch.launch import specs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.launch.train_step import TrainConfig
    data, model = mesh
    sizes = {"data": data, "model": model}
    cfg = _cfg(arch)
    ref = reference[f"{arch}/{data}x{model}"]
    shapes = {k: ShapeConfig(*v) for k, v in SHAPES.items()}
    train = _port(specs.train_batch_specs(cfg, shapes["train"],
                                          TrainConfig(mb_size=1), sizes))
    for key, want in ref["train"].items():
        if key == "embeds":
            assert want[1] == "bfloat16" and train[key][1] == "float32"
            want = [want[0], "float32", want[2]]
        assert train[key] == want, key
    assert sorted(train) == sorted(ref["train"])
    assert _port(specs.prefill_batch_specs(cfg, shapes["prefill"], sizes)) \
        == ref["prefill"]
    assert _port(specs.decode_batch_specs(cfg, shapes["decode"], sizes)) \
        == ref["decode"]
    assert list(specs.logits_sharding(cfg, shapes["decode"], sizes)) == \
        ref["logits"]
    # caches: the reference's shapes, dtypes and batch entry; the port's
    # own model entries
    from repro_torch.models.tp import attn_heads_split
    cache = _port(specs.decode_cache_specs(cfg, shapes["decode"], sizes))
    assert sorted(cache) == sorted(ref["cache"])
    for key, (shape, dtype, pspec) in ref["cache"].items():
        got_shape, got_dtype, got = cache[key]
        assert (got_shape, got_dtype) == (shape, dtype), key
        assert got[:2] == pspec[:2], key
        want = [None] * (len(shape) - 2)
        state, field = key.split("/")
        if model > 1 and state in ("attn", "local", "global") and \
                field in ("k", "v") and attn_heads_split(cfg, model):
            want[1] = "model"                # KV heads
        if model > 1 and state == "ssm":
            want[0] = "model"                # SSM channels
        assert got[2:] == want, key


if __name__ == "__main__":
    print(json.dumps(_reference()))
