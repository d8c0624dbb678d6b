"""The port's training claims, on its own terms (the JAX package's own
training tests do not pass on this jax version, so the reference cannot be
the oracle here): smollm-135m ``.reduced()``, seq 32, global batch 8, 3
steps.

* byte-identical losses, parameter digests and optimizer digests at
  data-parallel widths 1, 2 and 4 (gloo ranks), in ``repro`` and
  ``repro_zero2``;
* ``repro`` == ``repro_zero2`` bitwise;
* an injected failure restarts under ``run_supervised`` from the last
  checkpoint and ends on the same bits as a run without one;
* the loss goes down; a ``repro_embed`` run works and its ``embed_chunk``
  changes no bit; ``packed_wire`` changes no bit;
* the CLI runs on the CPU when asked.

Widths run in a fresh subprocess each (``tests/_torch_dist.py``); this file
is also their script: ``python tests/test_torch_train.py <world>
<out_dir>``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.launch.train_step import TrainConfig  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

SHAPE = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
STEPS = 3


def _cfg():
    return configs.get_config("smollm-135m").reduced()


def _tc(grad_mode="repro_zero2", steps=STEPS, **kw):
    return TrainConfig(grad_mode=grad_mode, mb_size=1,
                       adamw=AdamWConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=steps), **kw)


def _run(grad_mode="repro_zero2", **kw):
    steps = kw.pop("steps", STEPS)
    tc_kw = {k: kw.pop(k) for k in ("repro_embed", "embed_chunk",
                                    "packed_wire") if k in kw}
    res = train_loop(_cfg(), SHAPE, _tc(grad_mode, steps, **tc_kw),
                     steps=steps, seed=7, log_every=10 ** 9, device="cpu",
                     **kw)
    return res


def _summary(res):
    return {"losses": [float(l).hex() for _, l in res.losses],
            **res.fingerprints}


def _rank(rank, world):
    return {mode: _summary(_run(mode)) for mode in ("repro_zero2", "repro")}


@pytest.fixture(scope="module", autouse=True)
def _one_intraop_thread():
    """The ranks run one thread each; so do the in-process runs compared
    with them (restored afterwards for the worker's other tests)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def one_process():
    return {mode: _summary(_run(mode)) for mode in ("repro_zero2", "repro")}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_width_invariance_and_grad_modes_bitwise(world, tmp_path,
                                                 one_process):
    """THE paper claim, end to end: every width, both repro modes, the
    same bytes — and the same as one process without a process group."""
    ranks = _torch_dist.run_ranks(__file__, world, tmp_path)
    want = one_process["repro_zero2"]
    assert one_process["repro"] == want
    for r, got in enumerate(ranks):
        for mode in ("repro_zero2", "repro"):
            assert got[mode] == want, (world, r, mode)


def test_failure_restart_bitwise_continuity(tmp_path, one_process):
    res = _run(ckpt_dir=str(tmp_path), ckpt_every=1, resume=True,
               fail_at=2)
    assert res.restarts == 1
    assert _summary(res) == one_process["repro_zero2"]
    # a restart from scratch (no checkpoint) replays the same run too
    res = _run(fail_at=1)
    assert res.restarts == 1
    assert res.fingerprints["params"] == one_process["repro_zero2"]["params"]


def test_training_reduces_loss():
    res = train_loop(_cfg(), ShapeConfig("t", 64, 8, "train"),
                     TrainConfig(adamw=AdamWConfig(lr=3e-3, warmup_steps=2,
                                                   total_steps=12)),
                     steps=12, seed=0, log_every=10 ** 9, device="cpu")
    losses = [l for _, l in res.losses]
    assert all(l == l for l in losses)
    assert sum(losses[-3:]) / 3 < sum(losses[:3]) / 3, losses


def test_repro_embed_step_and_wire_format_change_no_bit(one_process):
    a = _run("repro", steps=2, repro_embed=True, embed_chunk=4096)
    b = _run("repro", steps=2, repro_embed=True, embed_chunk=37)
    assert _summary(a) == _summary(b)
    assert all(l == l for _, l in a.losses)
    packed = _run("repro", packed_wire=True)
    assert _summary(packed) == one_process["repro"]


def test_baseline_runs_and_checkpoints_are_width_free(tmp_path):
    res = _run("baseline", steps=2, ckpt_dir=str(tmp_path), ckpt_every=1)
    assert len(res.losses) == 2 and res.restarts == 0
    from repro_torch.checkpoint import ckpt
    manifest = ckpt.read_manifest(str(tmp_path))
    assert manifest["extra"] == {"step": 2}
    assert manifest["arrays"]["params/embed"]["dtype"] == "float32"
    assert manifest["arrays"]["opt/0/embed"]["shape"] == [256, 128]


def test_cli_trains_on_the_cpu_when_asked(tmp_path):
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    fp = tmp_path / "fp.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--reduced", "--steps", "2", "--seq-len", "16",
         "--global-batch", "2", "--device", "cpu", "--fingerprints",
         str(fp)], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "trained 2 steps" in out.stdout
    assert {"loss_trajectory", "params", "opt", "_manifest"} <= set(
        json.loads(fp.read_text()))


if __name__ == "__main__":
    _torch_dist.main(_rank)
