"""Atomic, verifiable checkpoints of tensor trees.

The JAX package's on-disk layout, unchanged, so a snapshot written by
either package restores in the other:

  <dir>/step_<n>/manifest.json
  <dir>/step_<n>/arrays.npz

The manifest carries the npz's ``sha256`` (storage integrity), the
``tree_fingerprint`` of the flattened tree under the byte-layout contract
of :mod:`repro_torch.obs.fingerprint` (value identity, the same digest the
JAX package computes), the run manifest (``env``), each array's shape and
dtype, and the caller's ``extra``.  Leaves are copied to host memory once
to be written; :func:`restore` places them on ``device`` (the card unless
the caller asks for the CPU).

Atomicity: written into ``.tmp-step_<n>``, fsynced (files and directory),
then renamed; readers only ever see complete checkpoints.  The fault sites
``ckpt.save`` (before the publishing rename) and ``ckpt.saved`` (after it)
let the chaos tests crash or corrupt a snapshot.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import fingerprint as obs_fp
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import faultinject

__all__ = ["AsyncCheckpointer", "checkpoint_fingerprint", "latest_step",
           "read_manifest", "restore", "save", "verify_value"]

SEP = "/"


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                  # platform without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256(f) -> str:
    """sha256 hex digest of an open binary file, read in 16 MiB pieces."""
    h = hashlib.sha256()
    for piece in iter(lambda: f.read(1 << 24), b""):
        h.update(piece)
    return h.hexdigest()


def _host(x) -> np.ndarray:
    """A host copy of a tensor or array leaf (never a view of live data)."""
    if isinstance(x, torch.Tensor):
        return np.array(x.detach().cpu().numpy())
    return np.array(x)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix.rstrip(SEP)] = tree
    return out


def _unflatten(flat: dict, skeleton):
    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(tree[k], f"{prefix}{k}{SEP}") for k in tree}
        if isinstance(tree, (list, tuple)):
            vals = [build(v, f"{prefix}{i}{SEP}") for i, v in enumerate(tree)]
            return type(tree)(vals) if not hasattr(tree, "_fields") \
                else type(tree)(*vals)
        return flat[prefix.rstrip(SEP)]
    return build(skeleton)


def _step_dir(directory: str, step: Optional[int]) -> tuple[int, str]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return step, os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Synchronous atomic save of a nested dict/list/tuple of tensors or
    arrays; ``extra`` is JSON-serializable metadata.  Returns the
    checkpoint's directory."""
    directory = os.fspath(directory)
    with obs_trace.span("ckpt.save", step=step) as sp:
        flat = {k: _host(v) for k, v in _flatten(tree).items()}
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = os.path.join(directory, f".tmp-step_{step:08d}")
        old = os.path.join(directory, f".old-step_{step:08d}")
        # leftovers from a crashed earlier save must not leak stale files
        # into this snapshot (or shadow it)
        for stale in (tmp, old):
            if os.path.exists(stale):
                shutil.rmtree(stale)
        os.makedirs(tmp)
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **flat)
        with open(npz_path, "rb") as f:
            digest = _sha256(f)
        tree_fp = obs_fp.fingerprint_pytree(flat)
        manifest = {
            "step": step,
            "sha256": digest,
            "tree_fingerprint": tree_fp,
            "env": obs_fp.run_manifest(),
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_file(npz_path)
        _fsync_dir(tmp)
        faultinject.fire("ckpt.save", path=npz_path)   # crash-mid-snapshot
        # publish: never a window where neither the old nor the new
        # complete checkpoint exists under the final name
        if os.path.exists(final):
            os.rename(final, old)
        os.rename(tmp, final)
        _fsync_dir(directory)
        if os.path.exists(old):
            shutil.rmtree(old)
        faultinject.fire("ckpt.saved",
                         path=os.path.join(final, "arrays.npz"))
        _gc(directory, keep)
        nbytes = os.path.getsize(os.path.join(final, "arrays.npz"))
        sp.set(bytes=nbytes, fingerprint=tree_fp)
        obs_metrics.counter("ckpt_saves_total").inc()
        obs_metrics.gauge("ckpt_last_bytes").set(nbytes)
    return final


def checkpoint_fingerprint(directory: str,
                           step: Optional[int] = None) -> dict:
    """The stored digests of a checkpoint, without loading its arrays:
    {step, sha256 (npz file), tree_fingerprint (byte-layout contract)}."""
    manifest = read_manifest(directory, step)
    return {"step": manifest["step"], "sha256": manifest["sha256"],
            "tree_fingerprint": manifest.get("tree_fingerprint")}


def read_manifest(directory: str, step: Optional[int] = None) -> dict:
    """The full manifest of a checkpoint (latest step by default), without
    loading its arrays."""
    _, path = _step_dir(os.fspath(directory), step)
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def verify_value(tree, directory: str, step: Optional[int] = None) -> str:
    """Value-identity check: the byte-layout fingerprint of a live
    (restored) tree must equal the manifest's ``tree_fingerprint``.  Guards
    the restore path itself (device placement, dtypes, skeleton).  Returns
    the fingerprint; raises ``IOError`` on mismatch and ``ValueError`` for
    a checkpoint that stored none."""
    manifest = read_manifest(directory, step)
    want = manifest.get("tree_fingerprint")
    if want is None:
        raise ValueError(
            f"checkpoint step {manifest['step']} in {directory} predates "
            "tree fingerprints; cannot verify value identity")
    got = obs_fp.fingerprint_pytree(_flatten(tree))
    if got != want:
        raise IOError(
            f"restored tree does not match checkpoint step "
            f"{manifest['step']}: fingerprint {got} != manifest {want}")
    obs_trace.event("ckpt.value_verified", step=manifest["step"],
                    fingerprint=got)
    return got


def _gc(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_map_tree(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree)


class AsyncCheckpointer:
    """Background-thread checkpointing; at most one save in flight.  The
    tree is copied to host memory before :meth:`save` returns, so the
    caller may go on changing its tensors."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._inflight: Optional[Future] = None

    def save(self, step: int, tree, extra=None) -> Future:
        self.wait()
        host_tree = _map_tree(_host, tree)
        self._inflight = self._pool.submit(
            save, self.directory, step, host_tree, extra, self.keep)
        return self._inflight

    def wait(self):
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None


def latest_step(directory: str) -> Optional[int]:
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(directory: str, skeleton, step: Optional[int] = None,
            device=None, verify: bool = True):
    """Load a checkpoint into the structure of ``skeleton``, every leaf a
    tensor on ``device`` (the card by default).  With ``verify`` the npz's
    sha256 is checked against the manifest.  Returns (tree, manifest
    extra)."""
    dev = resolve_device(device)
    step, path = _step_dir(os.fspath(directory), step)
    with obs_trace.span("ckpt.restore", step=step):
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        npz_path = os.path.join(path, "arrays.npz")
        if verify:
            with open(npz_path, "rb") as f:
                digest = _sha256(f)
            if digest != manifest["sha256"]:
                raise IOError(f"checkpoint {path} corrupt (sha mismatch)")
        with np.load(npz_path) as data:
            flat = {k: torch.from_numpy(data[k]).to(dev) for k in data.files}
        tree = _unflatten(flat, skeleton)
        obs_metrics.counter("ckpt_restores_total").inc()
        obs_trace.event("ckpt.restored", step=step,
                        fingerprint=manifest.get("tree_fingerprint"))
    return tree, manifest["extra"]
