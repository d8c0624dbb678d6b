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
"""
from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from repro_torch.core.types import dtype_name

__all__ = [
    "LAYOUT_VERSION", "MAGIC", "fingerprint_array", "fingerprint_table",
    "fingerprint_results",
]

LAYOUT_VERSION = 1
MAGIC = b"repro-fp/%d\n" % LAYOUT_VERSION


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.byteorder == ">" or (
            a.dtype.byteorder == "=" and sys.byteorder == "big"):
        a = a.astype(a.dtype.newbyteorder("<"))
    return a


def _update_array(h, name: str, arr) -> None:
    a = _host(arr)
    h.update(name.encode() + b"\0")
    h.update(a.dtype.name.encode() + b"\0")
    h.update(np.int64([a.ndim, *a.shape]).astype("<i8").tobytes())
    h.update(a.tobytes())


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
