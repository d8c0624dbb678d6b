"""Rank launcher for the port's ``torch.distributed`` tests on the CPU.

A test calls :func:`run_ranks`, which starts ``python <test file> <world>
<out_dir>`` as a fresh subprocess in a session of its own: no process group
is ever initialised in the pytest process, and nothing is forked from it.
The test file's ``__main__`` block calls :func:`spawn`, which starts the
ranks with ``torch.multiprocessing.spawn``; each rank joins a gloo group
through a ``file://`` store in ``out_dir`` (no TCP rendezvous port) with a
collective timeout, runs one thread, and writes ``rank<r>.json`` there.  On
a timeout the whole session — launcher and ranks — is killed.
"""
import datetime
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT_S = 120


def run_ranks(script: str, world: int, out_dir: Path,
              extra: tuple = ()) -> list:
    """Run ``world`` ranks of ``script`` and return each rank's JSON;
    ``extra`` arguments follow ``<world> <out_dir>`` on its command line."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, script, str(world), str(out_dir), *extra], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(world)]


def spawn(fn, world: int, out_dir: str) -> None:
    """Start ``fn(rank, world, out_dir)`` on ``world`` spawned ranks."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(fn, world, out_dir), nprocs=world,
             join=True)


def _rank_main(rank: int, fn, world: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        out = fn(rank, world)
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def main(fn) -> None:
    """The ``__main__`` block of a test file: ``<world> <out_dir>``."""
    spawn(fn, int(sys.argv[1]), sys.argv[2])
