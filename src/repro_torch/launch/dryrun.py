"""Dry run of the production meshes: one rank of every (arch x shape x
mesh) cell, traced on fake tensors over a fake process group.

The JAX package lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's memory and cost analyses.  The port runs the same
step it would run for real (:class:`~repro_torch.launch.train_step.
TrainStep`, :func:`~repro_torch.models.lm.prefill_step`,
:func:`~repro_torch.models.lm.decode_step`) for one rank of a ``fake``
process group of that many ranks, on fake tensors at that rank's local
shapes (:mod:`repro_torch.launch.specs`), and counts what it dispatches
with one :class:`Counter`.  No byte is allocated and no card is needed:
``device="cuda"`` traces on fake CUDA tensors (it needs PyTorch built for
CUDA), ``device="cpu"`` on fake CPU tensors, where the kernels' plain
versions run, as in a CPU run.  Each record keeps the JAX package's keys:

* ``flops_total``: what :class:`torch.utils.flop_counter.FlopCounterMode`
  counts for the rank;
* ``bytes_total``: the input and output bytes of every dispatched aten
  op, views, allocations and metadata ops left out: eager PyTorch's
  unfused traffic, not XLA's fused ``bytes accessed``;
* ``collective_bytes``: the operand bytes this rank hands to collectives,
  by kind (``all-gather``, ``reduce-scatter``, ``all-reduce``,
  ``broadcast``, ``all-to-all``); ``collective_counts`` their numbers and
  ``model_collectives`` the model axis's float collectives, those that
  :data:`repro_torch.core.collectives.MODEL_COLLECTIVES` counts;
* ``memory``: ``argument_bytes``, the storages live on entry (the specs'
  :func:`~repro_torch.launch.specs.local_bytes`); ``output_bytes``;
  ``temp_bytes``, the peak of live storages during the step less the
  arguments; ``generated_code_bytes`` ``None`` (nothing is compiled);
* ``kernel_launches``: launches of the port's kernels (the operators
  ``repro_torch::rsum_levels`` and ``repro_torch::segment_levels``);
* ``corrected``: the loops traced once for many identical iterations
  (:mod:`repro_torch.obs.repeat`) and their trip counts;
* ``lower_s``: the trace's seconds; ``compile_s`` 0.0.

The same :class:`Counter` counts a real step (:func:`count_call` without
``repeats``): the tests hold the dry run to real gloo ranks on the CPU and
``chip_smoke.py`` to a real step on the card.

Usage::

  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k \\
      [--multi-pod] [--device cpu] [--out results.json]
  python -m repro_torch.launch.dryrun --all [--device cpu] [--jobs 6]
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch._C._distributed_c10d import Work
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import configs as registry
from repro_torch import tree as tree_mod
from repro_torch.core import collectives
from repro_torch.kernels.segment_rsum import ops as seg_ops
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import (MULTI_POD_SHAPE, PRODUCTION_SHAPE,
                                     Mesh, make_mesh, make_production_mesh)
from repro_torch.launch.train_step import TrainConfig, make_train_step
from repro_torch.models import lm, transformer
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.obs import repeat
from repro_torch.optim import adamw as adamw_mod

__all__ = ["Counter", "count_call", "cell_step", "fake_inputs",
           "real_inputs", "trace",
           "lower_cell", "cells", "main", "SKIP_LONG"]

SKIP_LONG = "long_500k requires sub-quadratic decode (DESIGN.md §6)"

_aten = torch.ops.aten
# ops that move no data besides views and ``prim`` queries: allocations,
# aliases and metadata
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.new_empty.default, _aten.empty_strided.default,
    _aten.new_empty_strided.default, _aten.detach.default,
    _aten.alias.default, _aten.lift_fresh.default,
    _aten._unsafe_view.default,
}
# c10d op -> (kind, index of the operand this rank contributes)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "broadcast_": ("broadcast", 0),
    "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
}


def _segment_launches(x, ids, num_segments, A, inv_ulp, m, flush,
                      tile=None) -> int:
    return seg_ops.launch_count(num_segments, x.shape[1], A.shape[0], tile)


# kernel operator -> (kernel, launches of one call given its arguments)
_KERNELS = {"rsum_levels": ("rsum", lambda *args: 1),
            "segment_levels": ("segment_rsum", _segment_launches)}


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class Counter(TorchDispatchMode):
    """Counts what one rank's step dispatches: bytes, collectives, kernel
    launches and live storages here, flops through a
    :class:`~torch.utils.flop_counter.FlopCounterMode` beneath.  With
    ``repeats`` (a :class:`repro_torch.obs.repeat.Repeats`) every count is
    multiplied by the factor it gives the op; memory never is."""

    def __init__(self, repeats: Optional[repeat.Repeats] = None):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode, flop_registry
        self.flop_mode = FlopCounterMode(display=False)
        self._flop_ops = flop_registry
        self.repeats = repeats
        self._model_seen = collectives.MODEL_COLLECTIVES
        self.extra_flops = 0
        self.bytes = 0
        self.coll_bytes: dict[str, int] = {}
        self.coll_counts: dict[str, int] = {}
        self.model_collectives = 0
        self.launches = {name: 0 for name, _ in _KERNELS.values()}
        self._copies = None       # the last collective's, by storage
        self._live: dict[int, weakref.ref] = {}
        self.live = 0
        self.peak = 0

    # -- memory ------------------------------------------------------------

    def _gone(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live -= nbytes

    def track(self, x) -> int:
        """Register every storage under ``x`` not yet live; returns the
        bytes of ``x``'s distinct storages."""
        seen, total = set(), 0
        for t in _tensors(x):
            s = t.untyped_storage()
            key, nb = id(s), s.nbytes()
            if key not in seen:
                seen.add(key)
                total += nb
            if key not in self._live:
                self._live[key] = weakref.ref(
                    s, lambda _, k=key, n=nb: self._gone(k, n))
                self.live += nb
        self.peak = max(self.peak, self.live)
        return total

    # -- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        if ns == "prim":             # metadata queries (a fake tensor's device)
            return func(*args, **kwargs)
        if self._copies and not func.is_view:
            if func is _aten.copy_.default and \
                    id(args[0].untyped_storage()) in self._copies:
                # a backend finishing a collective on the caller's thread
                # (gloo's reduce-scatter copies its slice out): part of it
                return func(*args, **kwargs)
            self.settle()
        f = self.repeats.factor() if self.repeats is not None else 1
        flop = f != 1 and func._overloadpacket in self._flop_ops
        if flop:
            before = self.flop_mode.get_total_flops()
        if ns == "c10d":
            cpu = any(t.device.type == "cpu" for t in _tensors(args))
            out = self._on_copies(func, args, kwargs) if cpu \
                else func(*args, **kwargs)
            self._collective(func, args, f)
        else:
            out = func(*args, **kwargs)
        if flop:
            self.extra_flops += (f - 1) * (self.flop_mode.get_total_flops()
                                           - before)
        if ns == "repro_torch" and func._opname in _KERNELS:
            name, per = _KERNELS[func._opname]
            self.launches[name] += per(*args, **kwargs) * f
        if ns != "c10d" and not func.is_view \
                and func not in _NO_TRAFFIC:
            self.bytes += f * (_nbytes((args, kwargs)) + _nbytes(out))
        self.track(out)
        return out

    def _on_copies(self, func, args, kwargs):
        """Run a collective of CPU tensors on copies of them; :meth:`settle`
        copies the results back before the next op that reads data.  gloo
        keeps a collective's tensors until its own thread lets go of them,
        at a time of its choosing, and the caller's storages would then die
        late; it keeps the copies instead, which are made here, where the
        counter sees nothing.  (On the card no count depends on when a
        storage dies, and the copies would add to the memory measured.)"""
        pairs = []

        def copy(x):
            if isinstance(x, torch.Tensor):
                pairs.append((x, x.clone()))
                return pairs[-1][1]
            return x
        out = func(*tree_map(copy, args), **tree_map(copy, kwargs))
        Work.unbox(out[-1]).wait()
        self._copies = {id(c.untyped_storage()): (x, c) for x, c in pairs}
        back = {id(c): x for x, c in pairs}
        return tree_map(lambda t: back.get(id(t), t)
                        if isinstance(t, torch.Tensor) else t, out)

    def settle(self) -> None:
        """Copy the last collective's results back to the caller's
        tensors (unseen), if a collective is pending."""
        copies, self._copies = self._copies, None
        if not copies:
            return
        with _disable_current_modes():
            for x, c in copies.values():
                x.copy_(c)

    def _collective(self, func, args, f: int) -> None:
        name = func._opname
        kind, at = _COLLECTIVES.get(name, (name, 0))
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) \
            + f * _nbytes(args[at])
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + f
        # collectives.model_stack counts each gather just before it runs
        new = collectives.MODEL_COLLECTIVES - self._model_seen
        self._model_seen = collectives.MODEL_COLLECTIVES
        self.model_collectives += f * new

    # -- modes -------------------------------------------------------------

    def __enter__(self):
        self.flop_mode.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.flop_mode.__exit__(*exc)

    @property
    def flops(self) -> int:
        return self.flop_mode.get_total_flops() + self.extra_flops


def count_call(fn, args: tuple, *, repeats: bool = False) -> tuple:
    """``fn(*args)`` under a :class:`Counter`: ``(output, counts)``, with
    the record's count keys.  ``repeats``: loops of identical iterations
    run three (fake tensors only: a real run must run them all)."""
    reps = repeat.Repeats() if repeats else None
    counter = Counter(reps)
    arg_bytes = counter.track(args)
    t0 = time.perf_counter()
    with counter:
        if reps is not None:
            with repeat.honoured(reps):
                out = fn(*args)
        else:
            out = fn(*args)
        counter.settle()
    seconds = time.perf_counter() - t0
    counts = {
        "flops_total": counter.flops,
        "bytes_total": counter.bytes,
        "collective_bytes": counter.coll_bytes,
        "collective_counts": counter.coll_counts,
        "model_collectives": counter.model_collectives,
        "kernel_launches": counter.launches,
        "corrected": reps.corrected() if reps is not None else {},
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _storage_bytes(out),
            "temp_bytes": counter.peak - arg_bytes,
            "generated_code_bytes": None,
        },
        "seconds": seconds,
    }
    return out, counts


def _storage_bytes(x) -> int:
    seen = {}
    for t in _tensors(x):
        s = t.untyped_storage()
        seen[id(s)] = s.nbytes()
    return sum(seen.values())


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
              grad_mode: str = "repro_zero2", remat: str = "dots",
              device=None):
    """The step one rank of ``mesh`` runs for the cell, and the specs of
    its arguments: ``(fn, specs)``, ``fn(*args)`` with ``args`` shaped as
    ``specs`` (a tuple of :class:`~repro_torch.launch.specs.TensorSpec`
    trees; the optimizer state's an ``AdamWState``)."""
    sizes = dict(mesh.shape)
    p_specs = specs_mod.param_specs(cfg, sizes)
    if shape.kind == "train":
        tc = TrainConfig(grad_mode=grad_mode, remat=remat)
        step = make_train_step(cfg, tc, mesh, shape, device=device)
        zero = tc.grad_mode == "repro_zero2"
        return step, (p_specs, specs_mod.opt_specs(cfg, sizes, zero=zero),
                      specs_mod.train_batch_specs(cfg, shape, tc, sizes))
    tp = mesh.tp
    if shape.kind == "prefill":
        def prefill(params, batch):
            with torch.inference_mode():
                return lm.prefill_step(params, batch, cfg, shape.seq_len,
                                       tp=tp)
        return prefill, (p_specs,
                         specs_mod.prefill_batch_specs(cfg, shape, sizes))

    kinds = {k: type(c) for k, c in transformer.stack_cache_init(
        1, 1, cfg, device="meta").items()}

    def decode(params, caches, batch):
        """``caches``: per kind, the cache tuple's fields as a dict (the
        specs' tree; ``c._asdict()`` of the model's caches)."""
        caches = {k: kinds[k](**v) for k, v in caches.items()}
        with torch.inference_mode():
            return lm.decode_step(params, caches, batch, cfg, tp=tp)
    return decode, (p_specs, specs_mod.decode_cache_specs(cfg, shape, sizes),
                    specs_mod.decode_batch_specs(cfg, shape, sizes))


def fake_inputs(specs: tuple, device) -> tuple:
    """Uninitialised tensors at the specs' local shapes (under a
    ``FakeTensorMode``: fake ones), one storage each."""
    def one(s):
        return torch.empty(s.local_shape, dtype=s.dtype, device=device)

    def tree(t):
        if isinstance(t, adamw_mod.AdamWState):
            return adamw_mod.AdamWState(*(tree(x) for x in t))
        if isinstance(t, specs_mod.TensorSpec):
            return one(t)
        return tree_mod.tree_map(one, t)
    return tuple(tree(t) for t in specs)


def real_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, fn,
                specs: tuple, device, seed: int = 0) -> tuple:
    """Real arguments for :func:`cell_step`'s ``fn`` at the specs' local
    shapes, one storage each: this rank's shard of parameters drawn from
    ``seed``, the step's fresh optimizer state, and batches (and decode
    caches) of small random integers and normal floats: what a real step
    of the cell is counted on."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tree_mod.tree_map(lambda t: t.clone(), sh.shard_params(
        lm.init_params(gen, cfg, dev), mesh, cfg))
    high = min(cfg.vocab, shape.seq_len)

    def draw(s):
        if s.dtype.is_floating_point:
            return torch.randn(s.local_shape, generator=gen, device=dev,
                               dtype=torch.float32).to(s.dtype)
        return torch.randint(0, high, s.local_shape, generator=gen,
                             device=dev, dtype=s.dtype)
    rest = [fn.init_opt(params) if isinstance(t, adamw_mod.AdamWState)
            else tree_mod.tree_map(draw, t) for t in specs[1:]]
    return (params, *rest)


def _fake_world(world: int, rank: int) -> None:
    """Join a ``fake`` process group of ``world`` ranks as ``rank``
    (re-joining when the process is in another fake one).  A real group
    is never replaced, and a missing fake backend raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a dry run needs a fake process group; this "
                               "process is in a real one")
        if dist.get_world_size() == world and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs PyTorch's fake process-group "
                           "backend (torch.testing._internal.distributed."
                           "fake_pg)") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and torch.version.cuda is None:
        raise RuntimeError("tracing on fake CUDA tensors needs PyTorch built "
                           "for CUDA; pass device='cpu' to trace the CPU "
                           "path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def trace(cfg: ModelConfig, shape: ShapeConfig, sizes: Optional[dict] = None,
          *, grad_mode: str = "repro_zero2", remat: str = "dots",
          device="cuda", rank: int = 0, repeats: bool = True) -> dict:
    """One rank's counts for a cell on fake tensors.  ``sizes``: the mesh's
    axis sizes (``{"data": d, "model": m}``, ``"pod"`` for a multi-pod
    mesh); ``None`` is the production mesh (16 x 16).  ``repeats=False``
    traces every iteration of every loop (slow; the tests compare)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = _check_device(device)
    sizes = dict(sizes or {"data": PRODUCTION_SHAPE[0],
                           "model": PRODUCTION_SHAPE[1]})
    _fake_world(math.prod(sizes.values()), rank)
    if sizes in ({"data": PRODUCTION_SHAPE[0], "model": PRODUCTION_SHAPE[1]},
                 dict(zip(("pod", "data", "model"), MULTI_POD_SHAPE))):
        mesh = make_production_mesh(multi_pod="pod" in sizes)
    else:
        mesh = make_mesh(sizes["data"], sizes.get("model", 1),
                         sizes.get("pod", 0))
    fn, specs = cell_step(cfg, shape, mesh, grad_mode, remat, dev)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = fake_inputs(specs, dev)
        _, counts = count_call(fn, args, repeats=repeats)
    arg_specs = sum(specs_mod.local_bytes(s) for s in specs)
    if counts["memory"]["argument_bytes"] != arg_specs:
        raise RuntimeError(
            f"arguments hold {counts['memory']['argument_bytes']} bytes, "
            f"the specs {arg_specs}")
    counts["n_devices"] = math.prod(sizes.values())
    counts["rank"] = rank
    counts["device"] = dev.type
    return counts


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               grad_mode: str = "repro_zero2", remat: str = "dots", *,
               device="cuda", mesh: Optional[dict] = None,
               rank: int = 0) -> dict:
    """The JAX package's record for one cell, traced on fake tensors.
    ``mesh=None``: the production mesh (``multi_pod``: 2 x 16 x 16); an
    explicit ``{"data": d, "model": m}`` traces that mesh instead."""
    cfg = registry.get_config(arch)
    if shape_name not in registry.applicable_shapes(cfg):
        return {"arch": arch, "shape": shape_name, "skipped": SKIP_LONG}
    shape = SHAPES[shape_name]
    if mesh is None:
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        mesh = dict(zip(names, MULTI_POD_SHAPE if multi_pod
                        else PRODUCTION_SHAPE))
        label = "2x16x16" if multi_pod else "16x16"
    else:
        label = "x".join(str(mesh[a]) for a in ("pod", "data", "model")
                         if a in mesh)
    counts = trace(cfg, shape, mesh, grad_mode=grad_mode, remat=remat,
                   device=device, rank=rank)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": label,
        "n_devices": counts["n_devices"],
        "grad_mode": grad_mode if shape.kind == "train" else None,
        "lower_s": round(counts["seconds"], 1),
        "compile_s": 0.0,
        "flops_total": float(counts["flops_total"]),
        "bytes_total": float(counts["bytes_total"]),
        "collective_bytes": counts["collective_bytes"],
        "collective_counts": counts["collective_counts"],
        "model_collectives": counts["model_collectives"],
        "kernel_launches": counts["kernel_launches"],
        "corrected": counts["corrected"],
        "memory": counts["memory"],
        "rank": rank,
        "device": counts["device"],
    }


def cells(arch: Optional[str] = None) -> list:
    """``--all``'s cells, in the JAX package's order: every arch (or
    ``arch``) x every shape x (16x16, 2x16x16); shapes an arch does not
    take come back skipped."""
    archs = [arch] if arch else registry.list_archs()
    return [(a, s, mp) for a in archs for s in SHAPES for mp in (False, True)]


def _cell_record(cell, args) -> dict:
    """One cell's record: traced here, or with ``args.jobs`` > 1 in a
    process of its own (each cell joins its own fake world)."""
    arch, shape_name, mp = cell
    if args.jobs <= 1 or shape_name not in registry.applicable_shapes(
            registry.get_config(arch)):
        return lower_cell(arch, shape_name, mp, grad_mode=args.grad_mode,
                          remat=args.remat, device=args.device)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp, "cell.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape_name, "--grad-mode", args.grad_mode,
               "--remat", args.remat, "--device", args.device, "--out",
               str(out)] + (["--multi-pod"] if mp else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0 or not out.exists():
            raise RuntimeError(f"the cell's process exited "
                               f"{proc.returncode}: {proc.stderr[-2000:]}")
        (rec,) = json.loads(out.read_text())
        return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Trace one rank of production-mesh cells on fake "
                    "tensors: memory, flops, bytes and collectives.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--grad-mode", default="repro_zero2",
                    choices=["repro_zero2", "repro", "baseline"])
    ap.add_argument("--remat", default="dots",
                    choices=list(transformer.REMAT_POLICIES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (fake CUDA tensors; PyTorch built for CUDA) "
                         "or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (a trace runs on one core)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.all:
        todo = cells(args.arch)
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape, args.multi_pod)]
    else:
        ap.error("--arch and --shape, or --all")

    def one(cell):
        arch, shape_name, mp = cell
        tag = f"{arch} x {shape_name} x {'2x16x16' if mp else '16x16'}"
        try:
            rec = _cell_record(cell, args)
            status = "SKIP" if "skipped" in rec else "OK"
            print(f"[{status}] {tag}: "
                  f"{json.dumps(rec.get('memory', {}))}", flush=True)
        except Exception as e:     # a failed cell is reported, not fatal
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape_name,
                   "mesh": "2x16x16" if mp else "16x16",
                   "error": repr(e)}
            print(f"[FAIL] {tag}: {e!r}", flush=True)
        return rec

    try:
        if args.jobs <= 1:
            results = [one(cell) for cell in todo]
        else:           # threads that wait on one process per cell
            with ThreadPoolExecutor(args.jobs) as pool:
                results = list(pool.map(one, todo))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    failed = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(failed)}/{len(results)} cells OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
