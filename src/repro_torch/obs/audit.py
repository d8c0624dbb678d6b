"""Determinism audit: fresh-process fingerprint attestation.

The tests enforce the reproducibility claims in one process; this driver
re-checks them as an operator would — separate OS processes, an
adversarial workload, and persisted fingerprint files as the only channel
of comparison:

* **GROUPBY family** — one fixed adversarial workload (float32
  subnormals, exact zeros, a 50-decade magnitude spread, duplicate-heavy
  keys) under plans that must give the same bits: a fresh rerun, a row
  permutation, another summation-buffer chunk, and explicit strategies
  overriding the planner (on the card, the hand-written segment kernel
  too).  Each variant writes ``fp_groupby_<tag>.json``.
* **Stream family** — the same rows delivered as 1, 7 and 64 (permuted)
  micro-batches into a :class:`repro_torch.stream.StreamStore`, plus a
  variant that snapshots after three batches, restores into a fresh
  store and streams the rest; every variant must fingerprint like a
  one-shot ``groupby_agg`` over the rows.
* **Train family** — a short ``repro`` training of reduced smollm-135m
  (:func:`repro_torch.launch.train.train_loop`, reproducible embedding
  gradients) whose run fingerprints (loss trajectory, parameters,
  optimizer state) must not move with a fresh rerun, the embedding
  gradient's GROUPBY chunk, or a data-parallel width of 2 (spawned gloo
  ranks joined by a ``file://`` store in the output directory).  On the
  CPU every training process runs one torch thread, so the products'
  bits do not depend on the thread count.

Every worker runs on ``--device`` (default: the card).  The parent diffs
the files with :func:`repro_torch.obs.fingerprint.diff_fingerprints` and
exits non-zero on any mismatch; workers also write their trace (JSONL)
and metrics (JSON) into the output directory.  The comparison of the
GROUPBY and stream digests with the JAX package's lives in the CPU tests,
since the port runs without JAX.

CLI::

  PYTHONPATH=src python -m repro_torch.obs.audit --out audit_out [--quick]
      [--device cpu] [--skip-groupby] [--skip-stream] [--skip-train]
      [--serial] [--timeout SECONDS]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# ---------------------------------------------------------------------------
# workload definitions (shared between parent and workers)

GROUPBY_SEED = 0
GROUPBY_G = 129
GROUPBY_L = 3
AGGS = ("sum", "count", "mean", "var", "min", "max", ("sum", 1))

# (tag, {overrides}) — the base variant comes first; every other variant
# must fingerprint identically to it.
GROUPBY_VARIANTS = [
    ("base", {}),
    ("rerun", {}),                       # fresh process, same plan
    ("permuted", {"permute": True}),     # row order must not matter
    ("chunk8192", {"chunk": 8192}),      # summation-buffer size must not
    ("radix", {"method": "radix"}),      # planner choice must not
    ("onehot", {"method": "onehot"}),
]
CARD_VARIANTS = [("pallas", {"method": "pallas"})]   # the segment kernel

# (tag, {overrides}) — ``batches=0`` is the one-shot groupby_agg reference;
# every streamed variant must fingerprint identically to it.
STREAM_VARIANTS = [
    ("oneshot", {"batches": 0}),
    ("batches1", {"batches": 1}),
    ("batches7", {"batches": 7}),
    ("batches64perm", {"batches": 64, "permute_batches": True}),
    ("restart", {"batches": 7, "permute_batches": True,
                 "restart_after": 3}),
]

TRAIN_STEPS = 2
TRAIN_VARIANTS = [
    ("base", {"dp": 1, "embed_chunk": 4096}),
    ("rerun", {"dp": 1, "embed_chunk": 4096}),   # fresh process
    ("dp2", {"dp": 2, "embed_chunk": 4096}),     # data-parallel width
    ("chunk64", {"dp": 1, "embed_chunk": 64}),   # embed-grad chunk
]


def _groupby_dataset(n: int, permute: bool):
    """The JAX package's audit dataset, draw for draw: exact zeros,
    float32 subnormals (``1e-45``) and magnitudes over ~50 decades, capped
    at 1e15 so ``var``'s squares stay finite."""
    import numpy as np
    rng = np.random.default_rng(GROUPBY_SEED)
    mag = 10.0 ** rng.uniform(-35.0, 15.0, size=n)
    vals = (rng.standard_normal(n) * mag).astype(np.float32)
    vals[rng.integers(0, n, size=n // 16)] = 0.0
    vals[rng.integers(0, n, size=n // 16)] = np.float32(1e-45)  # subnormal
    col1 = rng.standard_normal(n).astype(np.float32)
    keys = rng.integers(0, GROUPBY_G, size=n).astype(np.int32)
    if permute:
        perm = np.random.default_rng(GROUPBY_SEED + 1).permutation(n)
        vals, col1, keys = vals[perm], col1[perm], keys[perm]
    return np.stack([vals, col1], axis=1), keys


def groupby_fingerprints(values, keys, device, method="auto", chunk=None):
    """The GROUPBY family's digests of one run."""
    from repro_torch.core.types import ReproSpec
    from repro_torch.obs import fingerprint as obs_fp
    from repro_torch.ops.groupby import groupby_agg

    spec = ReproSpec(L=GROUPBY_L)
    results, table = groupby_agg(values, keys, GROUPBY_G, aggs=AGGS,
                                 spec=spec, method=method, chunk=chunk,
                                 return_table=True, device=device)
    return {"groupby/table": obs_fp.fingerprint_table(table, spec),
            "groupby/results": obs_fp.fingerprint_results(results)}


def stream_fingerprints(values, keys, device, batches=0,
                        permute_batches=False, restart_after=0,
                        ckpt_dir=None):
    """The stream family's digests of one run (``batches=0``: one-shot)."""
    import numpy as np

    from repro_torch.core.types import ReproSpec
    from repro_torch.obs import fingerprint as obs_fp
    from repro_torch.ops.groupby import groupby_agg
    from repro_torch.stream import StreamStore

    spec = ReproSpec(L=GROUPBY_L)
    if batches == 0:
        results, table = groupby_agg(values, keys, GROUPBY_G, aggs=AGGS,
                                     spec=spec, return_table=True,
                                     device=device)
        return {"stream/table": obs_fp.fingerprint_table(table),
                "stream/results": obs_fp.fingerprint_results(results)}
    order = list(range(batches))
    if permute_batches:
        order = np.random.default_rng(
            GROUPBY_SEED + 2).permutation(batches).tolist()
    idx = np.array_split(np.arange(values.shape[0]), batches)
    store = StreamStore(GROUPBY_G, aggs=AGGS, spec=spec, device=device)
    for pos, b in enumerate(order):
        store.ingest(values[idx[b]], keys[idx[b]])
        if restart_after and pos + 1 == restart_after:
            store.snapshot(ckpt_dir)
            # restore verifies the state's bytes against the manifest
            store = StreamStore.restore(ckpt_dir, device=device)
    store.query()
    return store.fingerprints()


# ---------------------------------------------------------------------------
# workers (run in fresh subprocesses)

def _finish_worker(args, family: str, fps: dict, extra: dict) -> int:
    from repro_torch.obs import fingerprint as obs_fp
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    obs_fp.write_fingerprints(
        os.path.join(args.out, f"fp_{family}_{args.tag}.json"), fps,
        manifest=obs_fp.run_manifest(extra={
            "tag": args.tag, "n": args.n, "G": GROUPBY_G,
            "audit_device": args.device, **extra}))
    obs_metrics.dump()
    obs_trace.flush()
    return 0


def _worker_groupby(args) -> int:
    values, keys = _groupby_dataset(args.n, args.permute)
    fps = groupby_fingerprints(values, keys, args.device, args.method,
                               args.chunk)
    return _finish_worker(args, "groupby", fps, {
        "method": args.method, "chunk": args.chunk,
        "permuted": bool(args.permute)})


def _worker_stream(args) -> int:
    values, keys = _groupby_dataset(args.n, args.permute)
    fps = stream_fingerprints(
        values, keys, args.device, args.batches, args.permute_batches,
        args.restart_after,
        os.path.join(args.out, f"ckpt_stream_{args.tag}"))
    return _finish_worker(args, "stream", fps, {
        "batches": args.batches,
        "permute_batches": bool(args.permute_batches),
        "restart_after": args.restart_after})


def train_run(device: str, steps: int, embed_chunk: int, path: str) -> None:
    """The train family's run in this process (its process group, if any,
    is the data-parallel axis): rank 0 writes the fingerprints to
    ``path``."""
    import torch

    from repro_torch import configs as registry
    from repro_torch.launch.train import train_loop
    from repro_torch.launch.train_step import TrainConfig
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import AdamWConfig

    if device == "cpu":
        torch.set_num_threads(1)
    cfg = registry.get_config("smollm-135m").reduced()
    shape = ShapeConfig("audit", seq_len=32, global_batch=4, kind="train")
    tc = TrainConfig(grad_mode="repro", mb_size=1, repro_embed=True,
                     embed_chunk=embed_chunk,
                     adamw=AdamWConfig(lr=1e-3, total_steps=steps,
                                       warmup_steps=1))
    train_loop(cfg, shape, tc, steps=steps, seed=0, log_every=10 ** 9,
               fingerprint_path=path, device=device)


def _train_rank(rank: int, world: int, store: str, device: str, steps: int,
                embed_chunk: int, path: str) -> None:
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        train_run(device, steps, embed_chunk, path)
    finally:
        dist.destroy_process_group()


def _worker_train(args) -> int:
    path = os.path.join(args.out, f"fp_train_{args.tag}.json")
    if args.dp == 1:
        train_run(args.device, args.steps, args.embed_chunk, path)
        return 0
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.obs import audit as this      # picklable by name
    with tempfile.TemporaryDirectory(dir=args.out) as tmp:
        mp.spawn(this._train_rank, nprocs=args.dp, join=True, args=(
            args.dp, os.path.join(tmp, "store"), args.device, args.steps,
            args.embed_chunk, path))
    return 0


# ---------------------------------------------------------------------------
# parent: spawn, collect, diff

def _worker_env(out: str, tag: str) -> dict:
    env = dict(os.environ)
    env["REPRO_TRACE"] = os.path.join(out, f"trace_{tag}.jsonl")
    env["REPRO_METRICS"] = os.path.join(out, f"metrics_{tag}.json")
    # isolate (and share among workers) the calibration cache: plan choice
    # may differ with calibration, results must not
    env["REPRO_TORCH_CALIBRATION_CACHE"] = os.path.join(out,
                                                        "calibration.json")
    env["REPRO_TORCH_AUTOTUNE"] = "0"
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    return env


def _spawn(worker: str, out: str, tag: str, extra_args: list,
           device: str) -> "subprocess.Popen":
    cmd = [sys.executable, "-m", "repro_torch.obs.audit", "--worker", worker,
           "--out", out, "--tag", tag, "--device", device] + extra_args
    return subprocess.Popen(cmd, env=_worker_env(out, f"{worker}_{tag}"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _run_family(family: str, jobs: list, serial: bool,
                timeout: float) -> list:
    """jobs: (tag, popen-factory).  Returns failed tags; a worker still
    running at ``timeout`` seconds is killed and counts as failed."""
    failed, procs = [], []
    deadline = time.monotonic() + timeout
    for tag, factory in jobs:
        p = factory()
        procs.append((tag, p))
        if serial:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
    for tag, p in procs:
        try:
            output = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))[0]
        except subprocess.TimeoutExpired:
            p.kill()
            output = p.communicate()[0]
            output = (output or "") + f"\n<killed after {timeout} s>"
        if p.returncode != 0:
            print(f"[{family}] worker {tag} FAILED (exit {p.returncode}):")
            print(output[-4000:] if output else "  <no output>")
            failed.append(tag)
        else:
            print(f"[{family}] worker {tag} ok")
    return failed


def _diff_family(family: str, out: str, tags: list) -> list:
    from repro_torch.obs.fingerprint import (MANIFEST_KEY, diff_fingerprints,
                                             read_fingerprints)
    base_tag = tags[0]
    base = read_fingerprints(os.path.join(out, f"fp_{family}_{base_tag}.json"))
    man = base.get(MANIFEST_KEY, {})
    print(f"[{family}] base={base_tag} device={man.get('device')} "
          f"torch={man.get('torch_version')} cuda={man.get('cuda_version')}")
    for name, digest in sorted(base.items()):
        if name != MANIFEST_KEY:
            print(f"[{family}]   {name} = {digest[:16]}…")
    mismatches = []
    for tag in tags[1:]:
        other = read_fingerprints(os.path.join(out, f"fp_{family}_{tag}.json"))
        bad = diff_fingerprints(base, other)
        if bad:
            print(f"[{family}] {base_tag} vs {tag}: MISMATCH on {bad}")
            for k in bad:
                print(f"[{family}]   {k}: {base.get(k)} != {other.get(k)}")
            mismatches.append((tag, bad))
        else:
            print(f"[{family}] {base_tag} vs {tag}: identical")
    return mismatches


def _family(name: str, variants: list, args_of, args, summary: dict,
            failures: list) -> None:
    jobs = [(tag, (lambda t=tag, e=args_of(ov):
                   _spawn(name, args.out, t, e, args.device)))
            for tag, ov in variants]
    failed = _run_family(name, jobs, args.serial, args.timeout)
    if failed:
        failures.append(f"{name} workers failed: {failed}")
        summary[name] = "worker_failure"
        return
    mism = _diff_family(name, args.out, [t for t, _ in variants])
    summary[name] = "mismatch" if mism else "identical"
    if mism:
        failures.append(f"{name} fingerprints diverged: {mism}")


def _audit(args) -> int:
    os.makedirs(args.out, exist_ok=True)
    n = 4001 if args.quick else 20001
    t0 = time.time()
    summary = {"device": args.device, "groupby": None, "stream": None,
               "train": None}
    failures = []

    def groupby_args(ov):
        extra = ["--n", str(n), "--method", ov.get("method", "auto")]
        if ov.get("chunk"):
            extra += ["--chunk", str(ov["chunk"])]
        if ov.get("permute"):
            extra += ["--permute"]
        return extra

    def stream_args(ov):
        extra = ["--n", str(n), "--batches", str(ov.get("batches", 0))]
        if ov.get("permute_batches"):
            extra += ["--permute-batches"]
        if ov.get("restart_after"):
            extra += ["--restart-after", str(ov["restart_after"])]
        return extra

    if not args.skip_groupby:
        variants = GROUPBY_VARIANTS + (
            CARD_VARIANTS if args.device == "cuda" else [])
        _family("groupby", variants, groupby_args, args, summary, failures)
    if not args.skip_stream:
        _family("stream", STREAM_VARIANTS, stream_args, args, summary,
                failures)
    if not args.skip_train:
        def train_args(ov):
            return ["--steps", str(TRAIN_STEPS), "--dp", str(ov["dp"]),
                    "--embed-chunk", str(ov["embed_chunk"])]

        # each train worker builds a model: one at a time bounds memory
        _family("train", TRAIN_VARIANTS, train_args,
                argparse.Namespace(**{**vars(args), "serial": True}),
                summary, failures)

    summary["elapsed_s"] = round(time.time() - t0, 1)
    summary["status"] = "fail" if failures else "pass"
    summary["failures"] = failures
    with open(os.path.join(args.out, "audit_summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"determinism audit: {summary['status'].upper()} "
          f"in {summary['elapsed_s']}s on {args.device} "
          f"(groupby={summary['groupby']}, stream={summary['stream']}, "
          f"train={summary['train']})")
    for f in failures:
        print(f"  {f}")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs.audit")
    ap.add_argument("--out", required=True)
    ap.add_argument("--quick", action="store_true",
                    help="smaller workload")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every worker runs (default: the card)")
    ap.add_argument("--skip-groupby", action="store_true")
    ap.add_argument("--skip-stream", action="store_true")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--serial", action="store_true",
                    help="run the workers of a family one at a time")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a family's workers may take in all")
    # worker mode (internal)
    ap.add_argument("--worker", choices=["groupby", "stream", "train"])
    ap.add_argument("--tag", default="base")
    ap.add_argument("--n", type=int, default=20001)
    ap.add_argument("--method", default="auto")
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--permute", action="store_true")
    ap.add_argument("--batches", type=int, default=0,
                    help="stream worker: micro-batch count (0 = one-shot)")
    ap.add_argument("--permute-batches", action="store_true")
    ap.add_argument("--restart-after", type=int, default=0,
                    help="stream worker: snapshot+restore after this many "
                         "ingested batches")
    ap.add_argument("--steps", type=int, default=TRAIN_STEPS)
    ap.add_argument("--dp", type=int, default=1,
                    help="train worker: data-parallel width (gloo ranks)")
    ap.add_argument("--embed-chunk", type=int, default=4096)
    args = ap.parse_args(argv)
    if args.worker == "groupby":
        return _worker_groupby(args)
    if args.worker == "stream":
        return _worker_stream(args)
    if args.worker == "train":
        return _worker_train(args)
    return _audit(args)


if __name__ == "__main__":
    raise SystemExit(main())
