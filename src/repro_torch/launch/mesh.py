"""The port's mesh: ``(pod, data, model)`` process groups.

The JAX package trains and serves on a device mesh with ``pod`` and
``data`` axes for data parallelism and a ``model`` axis for tensor
parallelism.  The port deploys as ranks of ``torch.distributed`` laid out
on the same grid, ``model`` fastest, so that a model group is contiguous
ranks: rank ``(p * data + d) * model + m``.  Data parallelism reduces over
the pod groups, then the data groups, one at a time (a single group holds
at most :func:`repro_torch.core.collectives.max_axis_size` ranks for an
exact sum, 1024 for float32); tensor parallelism runs over the model
group (:class:`repro_torch.core.collectives.TP`).

A process that has no process group is a mesh of one rank (``data=1,
model=1``), and its collectives are no-ops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from repro_torch.core.collectives import TP

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "dp_axes",
           "dp_size", "PRODUCTION_SHAPE", "MULTI_POD_SHAPE"]

# the JAX package's production meshes: (data, model) and (pod, data, model)
PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``groups``: the data-parallel process groups (the pod group, then
    the data group), reduced in turn by :mod:`repro_torch.core.collectives`
    (``None`` is the default group; ``()`` no data-parallel peer); ``size``
    and ``rank`` on the data-parallel axes (pod and data together);
    ``tp``: the model axis (``None``: size 1); ``pod``: the pod axis's size
    (0: the mesh has no pod axis)."""
    groups: tuple
    size: int
    rank: int
    tp: Optional[TP] = None
    pod: int = 0

    @property
    def model_size(self) -> int:
        return self.tp.size if self.tp is not None else 1

    @property
    def model_rank(self) -> int:
        return self.tp.rank if self.tp is not None else 0

    @property
    def shape(self) -> dict:
        """Axis sizes, as ``jax.sharding.Mesh.shape`` gives them."""
        out = {"pod": self.pod} if self.pod else {}
        out.update(data=self.size // max(self.pod, 1),
                   model=self.model_size)
        return out


def _subgroup(world: int, members_of) -> object:
    """Every rank creates every group (``new_group`` is collective); each
    keeps the one it belongs to.  ``members_of(r)``: rank ``r``'s group."""
    me = dist.get_rank()
    mine = None
    seen = []
    for r in range(world):
        ranks = members_of(r)
        if ranks in seen:
            continue
        seen.append(ranks)
        g = dist.new_group(ranks)
        if me in ranks:
            mine = g
    return mine


def make_mesh(data: Optional[int] = None, model: int = 1,
              pod: int = 0) -> Mesh:
    """The world as a ``(pod, data, model)`` grid (``data=None``: what the
    world leaves; ``pod=0``: no pod axis).  Without a process group the
    mesh is one rank and asks for nothing larger."""
    pods = max(pod, 1)
    if not (dist.is_available() and dist.is_initialized()):
        if (data or 1) * model * pods != 1:
            raise ValueError(
                f"a mesh of data={data} model={model} pod={pod} needs a "
                "process group of that many ranks; none is initialised")
        return Mesh(groups=(), size=1, rank=0)
    world, me = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // (model * pods)
    if pods * data * model != world:
        raise ValueError(f"a mesh of pod={pods} x data={data} x "
                         f"model={model} does not cover {world} ranks")
    if model == 1 and not pod:
        return Mesh(groups=(None,), size=world, rank=me)

    def coords(r):
        return r // (data * model), (r // model) % data, r % model

    def at(p, d, m):
        return (p * data + d) * model + m

    p0, d0, m0 = coords(me)
    tp_group = _subgroup(world, lambda r: [
        at(*coords(r)[:2], m) for m in range(model)])
    data_group = _subgroup(world, lambda r: [
        at(coords(r)[0], d, coords(r)[2]) for d in range(data)])
    pod_group = _subgroup(world, lambda r: [
        at(p, *coords(r)[1:]) for p in range(pods)]) if pod else None
    groups = tuple(g for g, n in ((pod_group, pods), (data_group, data))
                   if n > 1)
    return Mesh(groups=groups, size=pods * data, rank=p0 * data + d0,
                tp=TP(tp_group, model, m0) if model > 1 else None, pod=pod)


def make_production_mesh(multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh: ``(data=16, model=16)``, or
    ``(pod=2, data=16, model=16)``; the world must have that many
    ranks."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the world has {world}")
    if multi_pod:
        return make_mesh(data=shape[1], model=shape[2], pod=shape[0])
    return make_mesh(data=shape[0], model=shape[1])


def dp_axes(mesh: Mesh) -> tuple:
    return mesh.groups


def dp_size(mesh: Mesh) -> int:
    return mesh.size
