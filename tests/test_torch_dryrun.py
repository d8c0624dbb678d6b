"""The port's dry run (``repro_torch.launch.dryrun``), on the CPU.

The JAX package's own dry run cannot be the oracle: on this jax version it
fails on the LM cells (``ShardingTypeError`` in ``jnp.take``).  The port's
dry run is held to real runs of the port, counted by the same
``Counter``:

* fake equals real: reduced llama3.2-3b and hymba-1.5b (two layers), a
  ``repro_zero2`` training step and a decode step, on four gloo ranks at
  ``(data, model) = (2, 2)`` and on a fake world of 4: per rank, flops,
  bytes, collective counts and bytes by kind, model-axis collectives
  (against ``MODEL_COLLECTIVES``), ``temp_bytes`` and kernel launches are
  equal, and the arguments hold the specs' ``local_bytes``;
* the loops traced once for many iterations (``repro_torch.obs.repeat``)
  count what the whole loops count: one hybrid layer, four quanta per
  rank and four scan chunks (of 4 steps instead of 64, to keep the test
  short), scaled and unscaled traces give equal counts and
  ``temp_bytes``;
* the CLI at production scale (smollm-135m x decode_32k at 16x16 and
  2x16x16) prints ``[OK]`` and records with the JAX package's keys;
* ``--all`` lists the JAX package's cells;
* the kernel operators' fake implementations give the plain versions'
  shapes and dtypes on fake CUDA tensors;
* qwen2-vl's M-RoPE traces on fake tensors with its bits unchanged.

Every process group lives in a subprocess (``tests/_torch_dist.py``); this
file is also its script: ``python tests/test_torch_dryrun.py <world>
<out_dir> real|fake|scaled``.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

SCRIPT = str(Path(__file__).resolve())
MESH = {"data": 2, "model": 2}
JOBS = [("llama3.2-3b", "train"), ("llama3.2-3b", "decode"),
        ("hymba-1.5b", "train"), ("hymba-1.5b", "decode")]
SHAPES = {"train": ShapeConfig("t", 8, 2, "train"),
          "decode": ShapeConfig("d", 16, 4, "decode")}
# scaled vs unscaled: 4 quanta, 4 chunks of SCAN_CHUNK steps
SCALED_SHAPE = ShapeConfig("t", 16, 4, "train")
SCAN_CHUNK = 4
KEYS = ("flops_total", "bytes_total", "collective_bytes", "collective_counts",
        "model_collectives", "kernel_launches")
REFERENCE_KEYS = {"arch", "shape", "mesh", "n_devices", "grad_mode",
                  "lower_s", "compile_s", "flops_total", "bytes_total",
                  "collective_bytes", "corrected", "memory"}


def _cfg(arch):
    return dataclasses.replace(configs.get_config(arch).reduced(), n_layers=2)


def _compare(c: dict) -> dict:
    out = {k: c[k] for k in KEYS}
    out["temp_bytes"] = c["memory"]["temp_bytes"]
    out["argument_bytes"] = c["memory"]["argument_bytes"]
    return out


# ---------------------------------------------------------------------------
# the rank scripts
# ---------------------------------------------------------------------------

def _real_rank(rank, world):
    from repro_torch.core import collectives
    from repro_torch.launch import specs as specs_mod
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(MESH["data"], MESH["model"])
    out = {}
    for arch, kind in JOBS:
        cfg, shape = _cfg(arch), SHAPES[kind]
        fn, specs = dryrun.cell_step(cfg, shape, mesh, device="cpu")
        args = dryrun.real_inputs(cfg, shape, mesh, fn, specs, "cpu",
                                  seed=rank)
        before = collectives.MODEL_COLLECTIVES
        _, counts = dryrun.count_call(fn, args)
        rec = _compare(counts)
        rec["MODEL_COLLECTIVES"] = collectives.MODEL_COLLECTIVES - before
        rec["spec_bytes"] = sum(specs_mod.local_bytes(s) for s in specs)
        out[f"{arch}/{kind}"] = rec
    return out


def _fake_ranks(ranks, out_dir):
    for rank in ranks:
        out = {}
        for arch, kind in JOBS:
            counts = dryrun.trace(_cfg(arch), SHAPES[kind], MESH,
                                  device="cpu", rank=rank)
            out[f"{arch}/{kind}"] = _compare(counts)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def _scaled(repeats, out_dir):
    from repro_torch.models import recurrence
    recurrence.chunked_time_scan.__defaults__ = (SCAN_CHUNK,)
    cfg = dataclasses.replace(_cfg("hymba-1.5b"), n_layers=1)
    counts = dryrun.trace(cfg, SCALED_SHAPE,
                          {"data": 1, "model": 1}, device="cpu",
                          repeats=repeats)
    rec = _compare(counts)
    rec["corrected"] = counts["corrected"]
    Path(out_dir, f"rank{int(repeats)}.json").write_text(json.dumps(rec))


def _start(args, out_dir):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(_torch_dist.SRC), os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, *args], env=env,
                            cwd=str(out_dir), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _wait(procs):
    """Wait for every process (each killed with its session after the
    rank launcher's limit); returns their (returncode, stdout, stderr)."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=_torch_dist.TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        _kill(procs)
    return outs


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of this file, started together (each runs one
    thread): the real gloo ranks, the fake ranks, the scaled and unscaled
    traces and the two CLI runs; a test waits for its own."""
    root = tmp_path_factory.mktemp("dryrun")
    dirs = {k: root / k for k in ("real", "fake", "scaled", "cli")}
    for d in dirs.values():
        d.mkdir()
    procs = {
        "real": [_start([SCRIPT, "4", str(dirs["real"]), "real"],
                        dirs["real"])],
        "fake": [_start([SCRIPT, "4", str(dirs["fake"]), "fake", ranks],
                        dirs["fake"]) for ranks in ("0,1", "2,3")],
        "scaled": [_start([SCRIPT, "1", str(dirs["scaled"]), "scaled",
                           str(rep)], dirs["scaled"]) for rep in (1, 0)],
        "cli": [_start(["-m", "repro_torch.launch.dryrun", "--arch",
                        "smollm-135m", "--shape", "decode_32k", "--device",
                        "cpu", "--out", f"cell{i}.json", *flags],
                       dirs["cli"])
                for i, flags in enumerate(((), ("--multi-pod",)))],
    }
    yield dirs, procs
    _kill([p for ps in procs.values() for p in ps])


def test_fake_trace_equals_real_gloo_ranks(runs):
    dirs, procs = runs
    for rc, _, err in _wait(procs["real"] + procs["fake"]):
        assert rc == 0, err[-3000:]
    for rank in range(4):
        real = json.loads((dirs["real"] / f"rank{rank}.json").read_text())
        fake = json.loads((dirs["fake"] / f"rank{rank}.json").read_text())
        for job, r in real.items():
            f = fake[job]
            assert r.pop("MODEL_COLLECTIVES") == r["model_collectives"], job
            assert r.pop("spec_bytes") == r["argument_bytes"], job
            assert f == r, (rank, job)
            assert r["collective_counts"] and r["model_collectives"] > 0


def test_scaled_trace_equals_unscaled(runs):
    dirs, procs = runs
    for rc, _, err in _wait(procs["scaled"]):
        assert rc == 0, err[-3000:]
    scaled = json.loads((dirs["scaled"] / "rank1.json").read_text())
    unscaled = json.loads((dirs["scaled"] / "rank0.json").read_text())
    assert scaled.pop("corrected") == {
        "recurrence.chunks": {"4": 3}, "train.quanta": {"4": 1}}
    assert unscaled.pop("corrected") == {}
    assert scaled == unscaled


def test_cli_at_the_production_meshes(runs):
    dirs, procs = runs
    for i, (rc, out, err) in enumerate(_wait(procs["cli"])):
        assert rc == 0, err[-3000:]
        mesh = ("16x16", "2x16x16")[i]
        assert f"[OK] smollm-135m x decode_32k x {mesh}:" in out
        assert "1/1 cells OK" in out
        (rec,) = json.loads((dirs["cli"] / f"cell{i}.json").read_text())
        assert REFERENCE_KEYS <= set(rec)
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "generated_code_bytes"}
        assert rec["n_devices"] == (256, 512)[i]
        assert rec["mesh"] == mesh and rec["compile_s"] == 0.0
        assert rec["flops_total"] > 0 and rec["bytes_total"] > 0
        assert rec["memory"]["temp_bytes"] > 0
        # the KV caches of 8 (16x16) or 4 (2x16x16) sequences per rank
        assert rec["memory"]["argument_bytes"] > (6e9, 3e9)[i]
        assert rec["collective_bytes"]["all-gather"] > 0


def test_all_lists_the_reference_cells():
    from repro import configs as ref_configs
    from repro.models.config import SHAPES as REF_SHAPES
    ref = [(a, s, mp) for a in ref_configs.list_archs() for s in REF_SHAPES
           for mp in (False, True)]
    assert dryrun.cells() == ref
    ref_skips = {(a, s) for a in ref_configs.list_archs() for s in REF_SHAPES
                 if s not in ref_configs.applicable_shapes(
                     ref_configs.get_config(a))}
    skips = {(a, s) for a, s, _ in dryrun.cells()
             if s not in configs.applicable_shapes(configs.get_config(a))}
    assert skips == ref_skips and skips
    assert {s for _, s in skips} == {"long_500k"}
    for a, s in skips:           # skipped before any process group
        assert dryrun.lower_cell(a, s, False) == {
            "arch": a, "shape": s, "skipped": dryrun.SKIP_LONG}


def test_kernel_fakes_give_the_plain_versions_shapes():
    """On fake CUDA tensors each kernel wrapper reaches its operator's fake
    implementation, which gives the plain version's shapes and dtypes
    (no autograd runs: a CPU-only build aborts on fake CUDA gradients);
    nothing is launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.types import ReproSpec
    from repro_torch.kernels.rsum import ops as rsum_ops
    from repro_torch.kernels.segment_rsum import ops as seg_ops

    spec = ReproSpec()
    launches = (rsum_ops.LAUNCHES, seg_ops.LAUNCHES)
    got = {}
    for dev in ("cpu", "cuda"):
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty((1000, 3), device=dev)
            A = torch.empty((2, 3), device=dev)
            ids = torch.empty((1000,), dtype=torch.int32, device=dev)
            if dev == "cpu":
                outs = (rsum_ops.rsum_levels_plain(x, A, A, spec)
                        + seg_ops.segment_levels_plain(x, ids, 7, A, A, spec))
            else:
                outs = (rsum_ops.rsum_levels_kernel(x, A, A, spec)
                        + seg_ops.segment_levels_kernel(x, ids, 7, A, A,
                                                        spec))
            got[dev] = [(tuple(t.shape), t.dtype, t.device.type)
                        for t in outs]
    assert [s[:2] for s in got["cuda"]] == [s[:2] for s in got["cpu"]]
    assert got["cpu"] == [((2, 3), torch.int32, "cpu")] * 2 \
        + [((7, 3, 2), torch.int32, "cpu")] * 2
    assert {s[2] for s in got["cuda"]} == {"cuda"}
    assert (rsum_ops.LAUNCHES, seg_ops.LAUNCHES) == launches


def test_mrope_traces_on_fake_tensors_with_unchanged_bits():
    """qwen2-vl's M-RoPE builds its per-pair component index from the
    config on the host: the same index as the ``repeat_interleave`` over
    tensor counts it replaces (whose data-dependent shape no fake trace can
    follow), so the same bits, and it traces on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import common

    sections, hd = (16, 24, 24), 128
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 4, hd), generator=gen)
    pos = torch.randint(0, 99, (2, 3, 5), generator=gen)
    comp = torch.repeat_interleave(torch.arange(3),
                                   torch.tensor(sections))[: hd // 2]
    ang = torch.einsum("bfs,f->bsf", pos.to(torch.float32)[:, comp, :],
                       common._rope_freqs(hd, 1e6, x.device))
    assert torch.equal(common.apply_mrope(x, pos, 1e6, sections),
                       common._rotate(x, ang))
    with FakeTensorMode():
        out = common.apply_mrope(torch.empty((2, 5, 4, hd)),
                                 torch.empty((2, 3, 5), dtype=torch.int64),
                                 1e6, sections)
    assert out.shape == x.shape


if __name__ == "__main__":
    world, out_dir, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    if mode == "real":
        _torch_dist.spawn(_real_rank, world, out_dir)
    elif mode == "fake":
        _fake_ranks([int(r) for r in sys.argv[4].split(",")], out_dir)
    else:
        _scaled(sys.argv[4] == "1", out_dir)
