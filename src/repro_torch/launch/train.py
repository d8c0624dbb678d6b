"""End-to-end trainer: checkpoint/restart, supervised recovery, run
fingerprints.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 20 [--reduced] [--device cpu] [--ckpt-dir /tmp/run1 --resume] \\
      [--grad-mode repro_zero2] [--fingerprints /tmp/run1.json] \\
      [--data D --model M [--pod P] | --production-mesh [--multi-pod]]

Runs on the card unless ``--device cpu``.  Under ``torchrun`` (the
``WORLD_SIZE``/``RANK`` variables; gloo on the CPU, NCCL on the card) or
any launcher that initialises a default process group first, the world is
laid out as the ``(pod, data, model)`` mesh of the flags
(:func:`repro_torch.launch.mesh.make_mesh`; without flags, one data axis);
otherwise it is one process.  The loop runs under the failure supervisor:
any step may raise, and the run resumes from the last checkpoint with a
bitwise identical trajectory.  A checkpoint holds the full-shape
parameters (as float32, exact for bfloat16) and the full-shape optimizer
state, gathered over the model and data axes, so a run resumes at any
``(data, model)``; the fingerprints hash the same gathered trees.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as registry
from repro_torch import tree as tree_mod
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.device import resolve_device
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.launch.train_step import (GRAD_MODES, TrainConfig,
                                           local_quanta, make_train_step)
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.obs import fingerprint as obs_fp
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw as adamw_mod
from repro_torch.runtime.failures import SimulatedFailure, run_supervised
from repro_torch.runtime.stragglers import StragglerMonitor

__all__ = ["RunState", "TrainResult", "build_batch", "train_loop",
           "add_mesh_flags", "mesh_from_flags", "main"]

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class RunState:
    params: object
    opt: object
    step: int


@dataclasses.dataclass
class TrainResult:
    """``losses``: (step, loss) per step run; ``step_seconds``: host-clock
    seconds of each step (synchronized on the card); ``fingerprints``: the
    run's determinism attestation (trajectory, params, opt digests)."""
    losses: list
    step_seconds: list
    fingerprints: dict
    restarts: int


def build_batch(dcfg: DataConfig, model_cfg: ModelConfig, step: int,
                n_quanta: int, mb_size: int, lo: int = 0,
                hi: Optional[int] = None, device=None):
    """Quanta [lo, hi) of a step's global batch: tensors (hi - lo, mb, ...).
    Each quantum is ``mb_size`` sequences, a pure function of its global
    index."""
    hi = n_quanta if hi is None else hi
    batch = synth_batch(dcfg, step, lo * mb_size, hi * mb_size, device)
    out = {k: v.reshape(hi - lo, mb_size, *v.shape[1:])
           for k, v in batch.items()}
    if model_cfg.rope_kind == "mrope" and "positions" not in out:
        S = dcfg.seq_len
        out["positions"] = torch.arange(
            S, dtype=torch.int32, device=out["targets"].device).expand(
                hi - lo, mb_size, 3, S)
    return out


def _skeleton(param_specs) -> dict:
    """The tree structure of a checkpoint: ``params`` and the optimizer
    state (an ``AdamWState``), keyed as the parameter specs."""
    return {"params": param_specs, "opt": adamw_mod.AdamWState(
        param_specs, param_specs, param_specs, count=None)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_loop(model_cfg: ModelConfig, shape: ShapeConfig,
               train_cfg: TrainConfig, mesh: Optional[Mesh] = None, *,
               steps: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 50, resume: bool = False, seed: int = 0,
               fail_at: Optional[int] = None, log_every: int = 10,
               fingerprint_path: Optional[str] = None,
               device=None) -> TrainResult:
    """Train ``steps`` steps; returns a :class:`TrainResult`.

    Every rank of ``mesh`` (default: the world, or one process) calls this
    with the same arguments.  ``fail_at`` injects one
    :class:`SimulatedFailure` at the start of that step; with ``ckpt_dir``
    and ``resume`` the supervisor restores the last checkpoint, else it
    starts over.  ``fingerprint_path``: rank 0 writes the run's
    fingerprints there (a chained digest of the per-step loss and grad
    norm, and digests of the final parameters and full optimizer state).
    """
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else make_mesh()
    dcfg = DataConfig(seed=seed, global_batch=shape.global_batch,
                      seq_len=shape.seq_len, vocab=model_cfg.vocab,
                      embed_dim=(model_cfg.d_model
                                 if model_cfg.embed_frontend == "stub"
                                 else 0),
                      mrope=model_cfg.rope_kind == "mrope")
    n_quanta = shape.global_batch // train_cfg.mb_size
    lo, hi = local_quanta(mesh, n_quanta)
    step_fn = make_train_step(model_cfg, train_cfg, mesh, shape, device=dev)

    log.info("mesh %s: %.3f GB of parameters and %.3f GB of optimizer "
             "state per rank", mesh.shape,
             specs_mod.local_bytes(step_fn.specs) / 1e9,
             specs_mod.local_bytes(specs_mod.opt_specs(
                 model_cfg, mesh, zero=step_fn.zero)) / 1e9)

    def fresh() -> RunState:
        params = sh.shard_params(lm.init_params(seed, model_cfg, dev),
                                 step_fn.mesh, model_cfg)
        return RunState(params=params, opt=step_fn.init_opt(params), step=0)

    def restore() -> Optional[RunState]:
        if ckpt_mod.latest_step(ckpt_dir) is None:
            return None
        tree, extra = ckpt_mod.restore(ckpt_dir, _skeleton(step_fn.specs),
                                       device="cpu")
        params = tree_mod.tree_map(
            lambda t: t.to(dev, model_cfg.pdtype),
            sh.shard_params(tree["params"], step_fn.mesh, model_cfg))
        opt = step_fn.local_opt(tree["opt"])
        opt = opt._replace(**{k: tree_mod.tree_map(
            lambda t: t.to(dev), getattr(opt, k))
            for k in ("mu", "nu", "master")}, count=opt.count.to(dev))
        log.info("restored step %d from %s", extra["step"], ckpt_dir)
        return RunState(params=params, opt=opt, step=int(extra["step"]))

    losses, seconds = [], []
    fail_armed = [fail_at]
    final_state: dict = {}
    traj = hashlib.sha256(obs_fp.MAGIC + b"trajectory\0")
    first = mesh.rank == 0 and mesh.model_rank == 0
    host = f"host{mesh.rank}"
    monitor = StragglerMonitor([host])

    def one_step(state: RunState, step: int) -> RunState:
        if fail_armed[0] is not None and step == fail_armed[0]:
            fail_armed[0] = None          # fire once, then recover
            raise SimulatedFailure(f"injected failure at step {step}")
        with obs_trace.span("train.step", step=step) as sp:
            with obs_trace.span("train.build_batch", step=step):
                batch = build_batch(dcfg, model_cfg, step, n_quanta,
                                    train_cfg.mb_size, lo, hi, dev)
            _sync(dev)
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(state.params, state.opt, batch)
            loss_arr = metrics["loss"].cpu().numpy()
            gnorm_arr = metrics["grad_norm"].cpu().numpy()
            _sync(dev)
            dt = time.perf_counter() - t0
            sp.set(loss=float(loss_arr), grad_norm=float(gnorm_arr))
        loss = float(loss_arr)
        traj.update(np.int64(step).tobytes())
        traj.update(obs_fp.fingerprint_array(loss_arr, "loss").encode())
        traj.update(obs_fp.fingerprint_array(gnorm_arr, "gnorm").encode())
        obs_metrics.histogram("train_step_seconds").observe(dt)
        obs_metrics.counter("train_steps_total").inc()
        obs_metrics.gauge("train_loss").set(loss)
        obs_metrics.gauge("train_grad_norm").set(float(gnorm_arr))
        monitor.record_step({host: dt})
        losses.append((step, loss))
        seconds.append(dt)
        if step % log_every == 0:
            log.info("step %d loss %.4f gnorm %.3f (%.3f s)", step, loss,
                     float(gnorm_arr), dt)
        new_state = RunState(params=params, opt=opt, step=step + 1)
        final_state["state"] = new_state
        return new_state

    # the last checkpoint's gathered trees (the first rank's), which the
    # fingerprints reuse when the run ends on that state
    saved: dict = {}

    def gathered(state: RunState):
        """(params, opt) at full shape on the first rank (``None`` leaves
        elsewhere); collectives on every rank."""
        if saved.get("state") is state:
            return saved["trees"]
        saved.clear()
        return (step_fn.full_params(state.params, keep=first),
                step_fn.full_opt(state.opt, keep=first))

    def save(state: RunState, step: int):
        if not ckpt_dir:
            return
        params, opt = gathered(state)
        saved.update(state=state, trees=(params, opt))
        if first:
            ckpt_mod.save(ckpt_dir, step, {
                "params": tree_mod.tree_map(lambda t: t.to(torch.float32),
                                            params),
                "opt": opt}, extra={"step": step})
        if dist.is_available() and dist.is_initialized():
            dist.barrier()

    report = run_supervised(
        fresh, restore if (resume and ckpt_dir) else lambda: None,
        one_step, save, total_steps=steps, ckpt_every=ckpt_every)
    fps = {}
    if "state" in final_state:
        params, opt = gathered(final_state["state"])
        saved.clear()
        fps = {"loss_trajectory": traj.hexdigest()}
        if first:
            fps.update(params=obs_fp.fingerprint_pytree(params),
                       opt=obs_fp.fingerprint_pytree(opt))
        del opt, params
        if dist.is_available() and dist.is_initialized():
            # the gathered trees' digests, from the first rank to all
            digests = [{k: fps.get(k) for k in ("params", "opt")}]
            dist.broadcast_object_list(digests, src=0)
            fps.update(digests[0])
        if fingerprint_path and first:
            obs_fp.write_fingerprints(
                fingerprint_path, fps,
                manifest=obs_fp.run_manifest(extra={
                    "steps": len(losses), "grad_mode": train_cfg.grad_mode,
                    "mb_size": train_cfg.mb_size,
                    "mesh": dict(mesh.shape), "seed": seed}))
            log.info("wrote run fingerprints to %s", fingerprint_path)
    obs_metrics.dump()
    obs_trace.flush()
    return TrainResult(losses=losses, step_seconds=seconds,
                       fingerprints=fps, restarts=report.restarts)


def add_mesh_flags(ap: argparse.ArgumentParser, pod: bool) -> None:
    """The JAX package's mesh flags."""
    ap.add_argument("--data", type=int, default=None,
                    help="data-parallel ranks (default: what the world "
                         "leaves)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel ranks")
    if pod:
        ap.add_argument("--pod", type=int, default=0,
                        help="pods (0: no pod axis)")
        ap.add_argument("--production-mesh", action="store_true",
                        help="(data=16, model=16): 256 ranks")
        ap.add_argument("--multi-pod", action="store_true",
                        help="with --production-mesh: (pod=2, data=16, "
                             "model=16), 512 ranks")


def mesh_from_flags(args, device=None) -> Mesh:
    """The mesh the flags ask for.  A process started by ``torchrun``
    (``WORLD_SIZE`` > 1) joins its process group first: gloo on the CPU,
    NCCL on the card."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
            not dist.is_initialized():
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if getattr(args, "production_mesh", False):
        return make_production_mesh(multi_pod=args.multi_pod)
    return make_mesh(args.data, args.model, getattr(args, "pod", 0))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train an LM of any family with reproducible gradient "
                    "sums.")
    ap.add_argument("--arch", required=True,
                    help="one of " + ", ".join(registry.list_archs()))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's small same-family variant")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mb-size", type=int, default=1)
    ap.add_argument("--grad-mode", default="repro_zero2", choices=GRAD_MODES)
    ap.add_argument("--repro-embed", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fingerprints", default=None, metavar="PATH",
                    help="write the run's determinism fingerprints "
                         "(loss trajectory + final params/opt) to PATH")
    add_mesh_flags(ap, pod=True)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = mesh_from_flags(args, args.device)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    tc = TrainConfig(grad_mode=args.grad_mode, mb_size=args.mb_size,
                     repro_embed=args.repro_embed,
                     adamw=adamw_mod.AdamWConfig(
                         lr=args.lr, total_steps=args.steps,
                         warmup_steps=max(1, args.steps // 10)))
    t0 = time.time()
    res = train_loop(cfg, shape, tc, mesh, steps=args.steps,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     resume=args.resume, seed=args.seed,
                     fail_at=args.fail_at,
                     fingerprint_path=args.fingerprints, device=args.device)
    dt = time.time() - t0
    print(f"trained {len(res.losses)} steps in {dt:.1f}s on mesh "
          f"{mesh.shape}; first loss {res.losses[0][1]:.4f} -> last "
          f"{res.losses[-1][1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
