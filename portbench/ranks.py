#!/usr/bin/env python3
"""A cell across several cards: one rank process to a card, in lockstep.

:func:`launch` (called by ``run.py`` where a cell's ``chips`` is above 1)
starts ``world`` rank processes of this file, each in a session of its
own, and waits for them.  Rank r binds ``cuda:r`` (the CPU in tests),
joins one process group through a ``file://`` store in a fresh directory
under ``TMPDIR`` (NCCL on the card, gloo on the CPU; no TCP port is fixed)
and a second, gloo group on the host for the ranks' agreement, both with a
collective timeout.  Every rank pins the environment (``run.py``), runs one
CPU thread, draws its own partition of the table (``harness.draw_rows``)
and checks at its end that no forbidden module is loaded (exit 3).

Rank 0 is the coordinator and runs ``harness.run_cell``: one closed-loop
session, as a coordinator drives every partition.  Before each of its calls
of the program entry, and outside the stamped interval, it broadcasts a
command on the host group (:class:`Team`); the other ranks
(:func:`follow`) make the same call on their own rows, so every rank calls
the entry the same number of times, and the collectives inside the call
make rank 0 wait for the slowest card.  Rank 0 alone decides when the
window ends and which answers are kept, profiles, prints information lines
and writes the result, which :func:`launch` returns.

If any rank fails or exits early, or the ranks outlive their deadline,
:func:`launch` kills every rank's session and raises :class:`RanksFailed`
(``run.py``: exit 5, no result).  A rank that hangs makes the others time
out: each command arms a timer on every rank (``SIGALRM`` in its default
action, which ends the process wherever it waits, on the card as in a
collective: NCCL's own timeout does not free a thread blocked on the
card), and the gloo waits have their own timeout.  A rank whose launcher
dies is killed by the kernel (``PR_SET_PDEATHSIG``).
"""
from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120.0     # a collective, or from one command to the next: above
                      # any rank's lag (a checkout's first kernel build)
DEADLINE_S = 300.0    # the ranks' life beyond the window, whatever happens
QUERY, KEEP, MEMORY, PERMUTED, DONE = range(1, 6)


class RanksFailed(RuntimeError):
    """A rank failed, exited early or hung: every rank was killed, and the
    run has no result.  ``code`` is the run's exit code."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


class Team:
    """One rank's place in the run: its rank, the world, the process group
    of the program's collectives and the host group of the ranks'
    agreement.  Rank 0 sends commands (:meth:`turn`, :meth:`query`,
    :meth:`memory`, :meth:`permuted`, :meth:`done`); the others receive
    them (:meth:`command`)."""

    def __init__(self, rank: int, world: int, group, host,
                 timeout_s: float = TIMEOUT_S):
        self.rank, self.world, self.group, self.host = rank, world, group, host
        self.timeout_s = timeout_s

    def _arm(self) -> None:
        """Until the next command, at most ``timeout_s``; past it the
        process ends (``SIGALRM``, default action)."""
        signal.setitimer(signal.ITIMER_REAL, self.timeout_s)

    def _go(self, op: int) -> None:
        import torch
        import torch.distributed as dist
        self._arm()
        dist.broadcast(torch.tensor([op]), 0, group=self.host)

    def command(self) -> int:
        import torch
        import torch.distributed as dist
        op = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(op, 0, group=self.host)
        self._arm()
        return int(op)

    def gather(self, obj) -> list:
        """``obj`` of every rank, by rank."""
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host)
        return out

    def turn(self, i: int) -> None:
        """Before the window's query ``i``: the first is kept by every
        rank, and the ranks' peak memory counts from it."""
        self._go(KEEP if i == 0 else QUERY)

    def query(self) -> None:
        self._go(QUERY)

    def memory(self, peak: int, resident: int) -> list:
        """``(peak, resident)`` bytes of every rank after the window."""
        self._go(MEMORY)
        return self.gather((peak, resident))

    def permuted(self) -> None:
        self._go(PERMUTED)

    def done(self, first: dict) -> list:
        """The end of the ranks' calls: every rank's first answer."""
        self._go(DONE)
        return self.gather(first)


def follow(cell, seed: int, dev, team: Team) -> None:
    """A rank other than 0: draw this rank's rows, then make each call
    rank 0 commands, until it says the calls are done."""
    import torch

    from portbench import harness

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config = cell.config
    values, keys, groups = harness.draw_rows(cell, config, seed, dev,
                                             team.rank, team.world)
    sync()
    team.gather(int(keys.shape[0]))
    aggs = [tuple(a) for a in config["aggregates"]]
    resident = values.numel() * values.element_size() \
        + keys.numel() * keys.element_size()
    entry = harness.entry_for(cell.bench, config, dev, team.group)
    first = None
    while True:
        op = team.command()
        if op in (QUERY, KEEP):
            if op == KEEP and cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            out = entry(values, keys, groups, aggs)
            sync()
            if op == KEEP:
                first = harness.to_host(out)
            out = None
        elif op == MEMORY:
            peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            team.gather((peak, resident))
        elif op == PERMUTED:
            every_v, every_k = harness.all_rows(cell, config, seed, dev,
                                                team.rank, team.world,
                                                values, keys)
            pv, pk = harness.permuted_share(every_v, every_k, seed,
                                            team.rank, team.world)
            del every_v, every_k
            entry(pv, pk, groups, aggs)
            sync()
            del pv, pk
        elif op == DONE:
            team.gather(first)
            return
        else:
            raise RuntimeError(f"rank {team.rank}: unknown command {op}")


def _kill(procs: list) -> None:
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)     # the rank and its children
        except ProcessLookupError:
            pass
    for p in procs:
        p.wait()


def launch(cell, seed: int, seconds: float, trace: bool, *,
           world: int | None = None, device: str = "cuda",
           timeout_s: float = TIMEOUT_S, t0: float | None = None,
           say=print) -> dict:
    """Run ``cell`` as ``world`` ranks (default: its ``chips``), one to a
    card; returns rank 0's result line as a dict.  ``t0``: the run's start
    on ``time.perf_counter``'s clock (CLOCK_MONOTONIC, one for every
    process of the machine), from which rank 0 counts ``setup_s``."""
    from portbench import harness

    world = cell.chips if world is None else world
    t0 = time.perf_counter() if t0 is None else t0
    harness.check_kernels(cell.bench.hand_kernels(), harness.program_dir())
    tmp = Path(tempfile.mkdtemp(prefix="portbench-ranks-"))
    paths = [str(harness.program_dir().parent), str(ROOT),
             os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in paths if p))
    say(f"portbench: {world} rank processes, one to a card "
        f"({'NCCL' if device == 'cuda' else 'gloo'}, collective timeout "
        f"{timeout_s:g} s)")
    sys.stdout.flush()
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--rank", str(rank), "--world", str(world),
                 "--root", str(cell.bench.root), "--workload", cell.name,
                 "--seed", str(seed), "--seconds", repr(seconds),
                 "--trace", str(int(trace)), "--device", device,
                 "--dir", str(tmp), "--timeout", repr(timeout_s),
                 "--t0", repr(t0), "--parent", str(os.getpid())],
                env=env, start_new_session=True,
                stdout=None if rank == 0 else subprocess.DEVNULL))
        deadline = time.monotonic() + seconds + DEADLINE_S
        while True:
            codes = [p.poll() for p in procs]
            for rank, code in enumerate(codes):
                if code == -signal.SIGALRM:
                    raise RanksFailed(5, f"rank {rank} waited past its "
                                      f"{timeout_s:g} s timer; every rank "
                                      "killed")
                if code not in (None, 0):
                    raise RanksFailed(
                        code if code in (3, 4) else 5,
                        f"rank {rank} exited with {code}; every rank killed")
            if all(code == 0 for code in codes):
                break
            if time.monotonic() > deadline:
                raise RanksFailed(5, f"ranks still running {DEADLINE_S:g} s "
                                  "after the window; every rank killed")
            time.sleep(0.05)
        return json.loads((tmp / "result.json").read_text())
    finally:
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _die_with(parent: int) -> None:
    """Have the kernel kill this rank when its launcher dies."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)      # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(5)


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a run")
    for name, kind in (("rank", int), ("world", int), ("root", str),
                       ("workload", str), ("seed", int), ("seconds", float),
                       ("trace", int), ("device", str), ("dir", str),
                       ("timeout", float), ("t0", float), ("parent", int)):
        ap.add_argument(f"--{name}", type=kind, required=True)
    args = ap.parse_args(argv)
    _die_with(args.parent)
    signal.signal(signal.SIGALRM, signal.SIG_DFL)     # Team._arm's timer
    from portbench.run import pin_environment
    pin_environment()
    os.environ["NCCL_SOCKET_IFNAME"] = "lo"     # one host: bootstrap on it

    import torch
    import torch.distributed as dist

    from portbench import catalog, harness

    torch.set_num_threads(1)
    cell = catalog.Benchmark(Path(args.root)).cell(args.workload)
    cuda = args.device == "cuda"
    dev = torch.device("cuda", args.rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=args.timeout)
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"file://{args.dir}/store",
        rank=args.rank, world_size=args.world, timeout=timeout,
        device_id=dev if cuda else None)
    try:
        team = Team(args.rank, args.world, dist.group.WORLD,
                    dist.new_group(backend="gloo", timeout=timeout),
                    args.timeout)
        if args.rank == 0:
            result = harness.run_cell(
                cell, args.seed, args.seconds, bool(args.trace),
                device=str(dev), t0=args.t0, team=team,
                say=lambda s: print(s, flush=True))
        else:
            follow(cell, args.seed, dev, team)
    except harness.UnlistedKernels as exc:
        print(f"portbench: rank {args.rank}: {exc}", file=sys.stderr,
              flush=True)
        os._exit(4)
    except BaseException:
        # the other ranks may be gone: no teardown, which could wait on them
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: rank {args.rank} loaded {bad}: the benchmark "
              "runs the port alone", file=sys.stderr, flush=True)
        return 3
    if args.rank == 0:
        part = Path(args.dir, "result.json.part")
        part.write_text(json.dumps(result))
        part.replace(Path(args.dir, "result.json"))
    return 0


if __name__ == "__main__":
    # bytecode of every module a rank imports, in the checkout (run.py)
    sys.pycache_prefix = str(ROOT / ".portbench_cache" / "pycache")
    sys.dont_write_bytecode = False
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    sys.exit(rank_main())
