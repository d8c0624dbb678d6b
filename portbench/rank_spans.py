"""The sharded path's own spans and collectives counter, read once per
traced run for the collectives layer's metrics of a cell that runs as
several ranks.

After the window, while the table is still resident, rank 0 reruns the
query in ``spans.py``'s two passes (every rank makes each call, in
lockstep):

* pass A (``spans._pass_a``), the program's trace buffer on: the delta of
  the ``repro_collectives_total`` counter, a query;
* pass B (``spans._pass_b``), the CPU and CUDA profiler: each device
  operation goes, by its launch's ``correlation``, to the innermost of
  :data:`SPANS` that holds the launch -- ``spans.py``'s stages, and the
  sharded path's ``groupby.lattice`` (the lattice's all-reduce MAX, inside
  ``groupby.prescan``) and ``groupby.merge`` (``repro_psum`` of the table,
  MIN/MAX, the row count).  An NCCL kernel's device time includes its wait
  for the slowest card.

A program without these spans or this counter gives no reading there, and
the metrics that read it report nothing.
"""
from __future__ import annotations

import dataclasses

from portbench import devtrace, spans

LATTICE, MERGE = "groupby.lattice", "groupby.merge"
SPANS = spans.SPANS + (LATTICE, MERGE)
COLLECTIVES = "repro_collectives_total"     # by name: older programs lack it
_CACHE = "_portbench_rank_spans"


@dataclasses.dataclass
class Reading:
    """Both passes of one run, per query."""

    passes: int                 # queries in each pass
    collectives: float | None   # counter delta (pass A)
    queries: int                # root spans (pass B)
    seen: frozenset             # spans that appeared (pass B)
    device_ms: dict             # span -> device ms of every operation
    device_ops: int


def attribute(events: list) -> tuple:
    """Chrome-trace events -> (root spans, spans seen, device ms by
    innermost span over the whole trace, device operations)."""
    found, launches, dev = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]), float(e.get("dur", 0))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e["name"] in SPANS:
            found.append((s, s + d, e["name"]))
        elif cat in spans.LAUNCH_CATS and corr is not None:
            launches[corr] = s
        elif cat in devtrace.DEVICE_CATS:
            dev.append((d, corr))
    found.sort()
    starts = [s for s, _, _ in found]
    ms: dict[str, float] = {}
    for d, corr in dev:
        at = launches.get(corr)
        owner = None if at is None else spans._innermost(found, starts, at)
        if owner is not None:
            ms[owner[2]] = ms.get(owner[2], 0.0) + d / 1e3
    roots = sum(1 for *_, name in found if name == spans.ROOT_SPAN)
    return roots, frozenset(n for *_, n in found), ms, len(dev)


def _collectives() -> float | None:
    from repro_torch.obs import metrics
    rows = metrics.to_dict().get(COLLECTIVES)
    return None if rows is None else sum(r["value"] for r in rows)


def reading(run) -> Reading | None:
    """Both passes over the run's resident table, once per run (cached on
    the run); None without a traced stretch or a resident table."""
    if getattr(run, _CACHE, None) is not None:
        return getattr(run, _CACHE)
    if run.stretch is None or run.query is None:
        return None
    before = _collectives()
    n, _, _ = spans._pass_a(run.query)
    after = _collectives()
    roots, seen, ms, ops = attribute(spans._pass_b(run.query, n,
                                                   run.device))
    res = Reading(
        passes=n,
        collectives=None if after is None else (after - (before or 0.0)) / n,
        queries=roots, seen=seen,
        device_ms={k: v / roots for k, v in ms.items()} if roots else {},
        device_ops=ops)
    setattr(run, _CACHE, res)
    print(f"portbench: rank 0 over {n} queries a pass: collectives a query "
          f"{res.collectives} (pass A); device ms a query by span "
          f"{ {k: round(v, 4) for k, v in sorted(res.device_ms.items())} } "
          f"(pass B, {roots} root spans)", flush=True)
    return res


def device_ms(run, span: str) -> float | None:
    """Device ms a query of every operation launched inside ``span`` (and
    in none of its inner spans); None where the pass saw no device
    operation or the program has no such span."""
    res = reading(run)
    if res is None or not res.device_ops or span not in res.seen \
            or not res.queries:
        return None
    return res.device_ms.get(span, 0.0)
