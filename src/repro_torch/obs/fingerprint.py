"""Canonical bitwise fingerprints.

A fingerprint is a sha256 over a *defined byte layout*, so two runs agree on
the digest iff they agree on every bit of the fingerprinted value.  The
layout is the JAX package's (``LAYOUT_VERSION`` 1), byte for byte, so a
digest computed here and one computed there compare as strings:

  digest = sha256( MAGIC
                 | kind "\\0"                       (utf-8 tag)
                 | repeated per array, in a defined order:
                 |   name "\\0" dtype-name "\\0" ndim shape...   (int64 LE)
                 |   raw little-endian C-order bytes )

Tensors are copied to host memory and converted to little-endian
contiguous numpy arrays before hashing; dtype names are numpy's
('int32', 'float32', ...).

The **run manifest** (:func:`run_manifest`) records what a digest
mismatch that is environmental rather than algorithmic would need: the
port's version and layout version, the torch and CUDA versions, the
device, Python, the machine, and a digest of the port's calibration cache.
"""
from __future__ import annotations

import hashlib
import json
import os
import platform
import sys

import numpy as np
import torch

from repro_torch.core.types import dtype_name

__all__ = [
    "LAYOUT_VERSION", "MAGIC", "MANIFEST_KEY", "fingerprint_array",
    "fingerprint_table", "fingerprint_pytree", "fingerprint_results",
    "run_manifest", "write_fingerprints", "read_fingerprints",
    "diff_fingerprints",
]

LAYOUT_VERSION = 1
MAGIC = b"repro-fp/%d\n" % LAYOUT_VERSION
MANIFEST_KEY = "_manifest"


def _host(arr) -> tuple[np.ndarray, str]:
    """A little-endian host array of the leaf and its dtype's name.  A
    bfloat16 tensor is hashed as its 16 bits under the name "bfloat16", the
    bytes and name of the JAX package's bfloat16 arrays."""
    name = None
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            t, name = t.view(torch.int16), "bfloat16"
        arr = t.numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.byteorder == ">" or (
            a.dtype.byteorder == "=" and sys.byteorder == "big"):
        a = a.astype(a.dtype.newbyteorder("<"))
    return a, name or a.dtype.name


def _update_array(h, name: str, arr) -> None:
    a, dname = _host(arr)
    h.update(name.encode() + b"\0")
    h.update(dname.encode() + b"\0")
    h.update(np.int64([a.ndim, *a.shape]).astype("<i8").tobytes())
    h.update(a)          # C-contiguous: its bytes, without a copy


def _new(kind: str):
    h = hashlib.sha256()
    h.update(MAGIC)
    h.update(kind.encode() + b"\0")
    return h


def fingerprint_array(arr, name: str = "") -> str:
    """sha256 hex digest of one array or tensor under the layout contract."""
    h = _new("array")
    _update_array(h, name, arr)
    return h.hexdigest()


def fingerprint_table(acc, spec=None) -> str:
    """Digest of a ReproAcc table: the (k, C, e1) fields in that order,
    prefixed with the accumulator format when ``spec`` is given."""
    h = _new("reproacc")
    if spec is not None:
        h.update(f"{dtype_name(spec.dtype)}/L{spec.L}/W{spec.W}".encode()
                 + b"\0")
    for name, field in (("k", acc.k), ("C", acc.C), ("e1", acc.e1)):
        _update_array(h, name, field)
    return h.hexdigest()


def fingerprint_results(results: dict) -> str:
    """Digest of a ``groupby_agg`` result dict (name -> array), keys
    sorted."""
    h = _new("results")
    for name in sorted(results):
        _update_array(h, name, results[name])
    return h.hexdigest()


def _flatten_with_paths(tree, path: str = ""):
    """``(path, leaf)`` pairs with the path strings the JAX package hashes
    (``jax.tree_util.keystr``): ``['key']`` for a dict key, ``[i]`` for a
    list or tuple index, ``.field`` for a named tuple's field; ``None`` is
    an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f, v in zip(tree._fields, tree)
                for kv in _flatten_with_paths(v, f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def fingerprint_pytree(tree) -> str:
    """Digest of a nested dict/list/tuple of arrays or tensors: every leaf
    hashed under its tree path, paths in sorted order, so the digest is a
    function of the mapping — and equal to the JAX package's for the same
    mapping."""
    h = _new("pytree")
    for path, leaf in sorted(_flatten_with_paths(tree),
                             key=lambda kv: kv[0]):
        _update_array(h, path, leaf)
    return h.hexdigest()


def _file_sha256(path: str) -> str | None:
    try:
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()
    except OSError:
        return None


def run_manifest(extra: dict | None = None) -> dict:
    """Environment provenance for a fingerprint file."""
    import repro_torch
    from repro_torch.ops import calibrate
    cache = calibrate.cache_path()
    card = torch.cuda.is_available()
    manifest = {
        "repro_torch_version": repro_torch.__version__,
        "fingerprint_layout": LAYOUT_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if card else "cpu",
        "python": platform.python_version(),
        "machine": platform.machine(),
        "calibration_cache": {"path": cache,
                              "sha256": _file_sha256(cache)},
    }
    if extra:
        manifest.update(extra)
    return manifest


def write_fingerprints(path: str, fingerprints: dict,
                       manifest: dict | None = None) -> str:
    """Persist a {name: hexdigest} mapping plus the run manifest."""
    payload = dict(fingerprints)
    payload[MANIFEST_KEY] = manifest if manifest is not None \
        else run_manifest()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
    return path


def read_fingerprints(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def diff_fingerprints(a: dict, b: dict) -> list[str]:
    """Names whose digests differ (or exist on one side only); the manifest
    entry is diagnostic context and excluded."""
    keys = (set(a) | set(b)) - {MANIFEST_KEY}
    return sorted(k for k in keys if a.get(k) != b.get(k))
