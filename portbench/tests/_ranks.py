"""Shared helpers of the rank path's tests: a copy of the benchmark with a
tiny Q1 configuration whose program entry is named, cells at several
worlds, and a run of such a cell through ``ranks.launch`` in a subprocess
in a session of its own, killed as a whole at its time limit.

Run as a script, this file is that subprocess:
``python _ranks.py <root> <cell> <seed> <seconds> <trace> <device>
<timeout>`` prints the result line last, or exits with the run's code.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 41
LIMIT_S = 240            # one run of the rank path, as a whole

# Test entries, written into the copy's ``entries/``.  Each wraps the real
# ``entries/sharded_groupby_agg.py``; ``{out}`` is the test's directory.
_WRAP = '''
import json, os
import torch
import torch.distributed as dist
from portbench import catalog

def _real(device, group):
    bench = catalog.Benchmark({root!r})
    return bench.module("entries", "sharded_groupby_agg").build(device, group)

def _hex(out):
    return json.dumps({{k: v.cpu().numpy().tobytes().hex()
                       for k, v in sorted(out.items())}})
'''
ENTRIES = {
    # every distinct answer a rank returns, and the rank's pid
    "recording": '''
def build(device, group=None):
    real, rank = _real(device, group), dist.get_rank(group)
    seen = set()
    open(os.path.join({out!r}, f"pid-{{rank}}"), "w").write(str(os.getpid()))
    def entry(values, keys, groups, aggs):
        out = real(values, keys, groups, aggs)
        seen.add(_hex(out))
        with open(os.path.join({out!r}, f"answers-{{rank}}.json"), "w") as f:
            json.dump(sorted(seen), f)
        return out
    return entry
''',
    # the last rank drops its last row
    "drop_last_row": '''
def build(device, group=None):
    real = _real(device, group)
    last = dist.get_rank(group) == dist.get_world_size(group) - 1
    def entry(values, keys, groups, aggs):
        if last:
            values, keys = values[:-1], keys[:-1]
        return real(values, keys, groups, aggs)
    return entry
''',
    # rank 1's answer with the lowest bit of one value flipped
    "one_bit": '''
def build(device, group=None):
    real, rank = _real(device, group), dist.get_rank(group)
    def entry(values, keys, groups, aggs):
        out = real(values, keys, groups, aggs)
        if rank == 1:
            name = sorted(out)[0]
            bits = out[name].clone().view(torch.int32)
            bits[0] ^= 1
            out[name] = bits.view(torch.float32)
        return out
    return entry
''',
    # the ranks' float32 results added in rank order, not repro_psum
    "float_merge": '''
def build(device, group=None):
    from repro_torch.ops import groupby_agg
    world = dist.get_world_size(group)
    def entry(values, keys, groups, aggs):
        cols = sorted({{a[1] for a in aggs if a[0] != "count"}})
        local = groupby_agg(values, keys, groups,
                            [("sum", c) for c in cols] + [("count",)],
                            device=device)
        merged = {{}}
        for name, t in sorted(local.items()):
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t.contiguous(), group=group)
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            merged[name] = acc
        out = {{}}
        for a in aggs:
            if a[0] == "count":
                out["count(*)"] = merged["count(*)"]
            elif a[0] == "sum":
                out[f"sum({{a[1]}})"] = merged[f"sum({{a[1]}})"]
            else:
                out[f"mean({{a[1]}})"] = (merged[f"sum({{a[1]}})"]
                                        / merged["count(*)"])
        return out
    return entry
''',
    # rank 1 sleeps in its first call, past any collective timeout
    "sleepy": '''
def build(device, group=None):
    import time
    real, rank = _real(device, group), dist.get_rank(group)
    open(os.path.join({out!r}, f"pid-{{rank}}"), "w").write(str(os.getpid()))
    def entry(values, keys, groups, aggs):
        if rank == 1:
            time.sleep(600)
        return real(values, keys, groups, aggs)
    return entry
''',
}


def bench_copy(tmp: Path, cells: dict, orders: int = 2000) -> Path:
    """A copy of the benchmark under ``tmp`` with the test entries and one
    tiny Q1 configuration per entry (``tiny_q1_<entry>``), and ``cells``
    ``{name: (entry, chips)}`` on them.  Returns the copy's root."""
    root = tmp / "bench"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = tmp / "out"
    out.mkdir()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((ROOT / "portbench/configs/tpch_sf10_q1.json")
                      .read_text())
    head = _WRAP.format(root=str(root))
    for entry in sorted({e for e, _ in cells.values()}):
        body = ENTRIES.get(entry)
        if body is not None:
            (root / "portbench/entries" / f"{entry}.py").write_text(
                head + body.format(out=str(out)))
        name = f"tiny_q1_{entry}"
        (root / "portbench/configs" / f"{name}.json").write_text(json.dumps(
            dict(base, name=name, orders=orders, entry=entry)))
        spec["configs"].append({"name": name, "source": "TPC-H",
                                "file": f"portbench/configs/{name}.json",
                                "reduced": ["orders"], "why": "a test"})
    for cell, (entry, chips) in cells.items():
        spec["workloads"].append({"name": cell, "config": f"tiny_q1_{entry}",
                                  "traffic": "dbgen_order", "chips": chips,
                                  "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run(root: Path, cell: str, seed: int = SEED, seconds: float = 0.5,
        trace: bool = False, device: str = "cpu",
        timeout_s: float = 60.0) -> subprocess.CompletedProcess:
    """One run of ``cell`` through the rank path, in a fresh session; the
    session is killed at :data:`LIMIT_S` (``TimeoutExpired`` is raised)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, __file__, str(root), cell, str(seed), repr(seconds),
         str(int(trace)), device, repr(timeout_s)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def result(done: subprocess.CompletedProcess) -> dict:
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    root, cell, seed, seconds, trace, device, timeout_s = argv
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import catalog, ranks
    try:
        res = ranks.launch(catalog.Benchmark(Path(root)).cell(cell),
                           int(seed), float(seconds), bool(int(trace)),
                           device=device, timeout_s=float(timeout_s),
                           say=lambda s: print(s, flush=True))
    except ranks.RanksFailed as exc:
        print(f"portbench: {exc} -- no result", file=sys.stderr)
        return exc.code
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
