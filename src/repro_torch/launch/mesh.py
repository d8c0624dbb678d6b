"""Data-parallel process groups: the port's mesh.

The JAX package trains on a device mesh with ``data`` (and ``pod``) axes
for data parallelism and a ``model`` axis for tensor parallelism.  The
port deploys as ranks of ``torch.distributed``: the whole world is the one
``data`` axis, and the model axis has size 1 (tensor parallelism is not
ported).  A process that has no process group is a data axis of one rank,
and its collectives are no-ops.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "dp_axes", "dp_size"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``groups``: the process groups of the data axis, reduced in turn by
    :mod:`repro_torch.core.collectives` (``None`` is the default group;
    ``()`` a single process); ``size`` and ``rank`` on that axis."""
    groups: tuple
    size: int
    rank: int

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": 1}


def make_mesh() -> Mesh:
    """The world as one data axis (or a single process without a group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(groups=(), size=1, rank=0)
    return Mesh(groups=(None,), size=dist.get_world_size(),
                rank=dist.get_rank())


def dp_axes(mesh: Mesh) -> tuple:
    return mesh.groups


def dp_size(mesh: Mesh) -> int:
    return mesh.size
