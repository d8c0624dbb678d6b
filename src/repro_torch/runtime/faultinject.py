"""Deterministic fault injection: seeded, scheduled, reproducible chaos.

A chaos test is only debuggable if the chaos itself is reproducible.
Durable code paths (the stream WAL, the checkpointer, the store commit
path) declare named **fault sites** by calling :func:`fire`, which is a
module-lookup no-op unless a test has installed a :class:`FaultInjector`.
An injector carries a *schedule* — exact ``(site, hit_index, action)``
triples, either hand-written or drawn from a seeded RNG — so every run of
a chaos scenario fires the same faults at the same operations and cuts
torn records at the same byte offsets.  Site names, actions and seeded
schedules are the JAX package's (``repro.runtime.faultinject``).

Actions:

* ``"crash"`` — raise :class:`InjectedCrash` (a ``SimulatedFailure``):
  the process "dies" at the site; the test discards live state and drives
  recovery from durable data only.
* ``"torn_tail"`` — physically truncate the file named by the site's
  ``path`` context inside the span named by ``record_span``, then crash:
  a write torn mid-record, exactly what a power cut leaves behind.
* ``"corrupt"`` — flip one byte of ``path`` at a seeded offset and
  *continue*: silent storage corruption, to be caught later by sha256 /
  ``verify_value`` gates.
* ``"unavailable"`` — raise :class:`InjectedUnavailable` (an ``OSError``):
  the backing storage went away; callers degrade to read-only serving.

The catalog of sites instrumented in the tree is in DESIGN.md §16.5.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.runtime.failures import SimulatedFailure

__all__ = [
    "ACTIONS", "FaultPoint", "FaultInjector", "InjectedCrash",
    "InjectedUnavailable", "active", "fire", "random_schedule",
]

ACTIONS = ("crash", "torn_tail", "corrupt", "unavailable")


class InjectedCrash(SimulatedFailure):
    """The injected process death: live state is gone, durable state is
    whatever the faulted operation left behind."""


class InjectedUnavailable(OSError):
    """Injected storage unavailability (``OSError`` so WAL/ckpt callers
    handle real and injected IO failures through one code path)."""


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    """One scheduled fault: fire ``action`` on the ``hit``-th call
    (0-based, counted per site) of fault site ``site``."""

    site: str
    hit: int = 0
    action: str = "crash"

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r}; want {ACTIONS}")


def _flip_byte(path: str, rng: np.random.Generator) -> int:
    """Deterministically corrupt one byte of ``path``; returns the offset."""
    size = os.path.getsize(path)
    off = int(rng.integers(0, max(size, 1)))
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
    return off


def _tear(path: str, span, rng: np.random.Generator) -> int:
    """Truncate ``path`` to a seeded offset strictly inside ``span`` —
    the record's bytes end mid-frame, as a torn write would leave them."""
    start, end = int(span[0]), int(span[1])
    cut = start + 1 + int(rng.integers(0, max(end - start - 1, 1)))
    with open(path, "r+b") as f:
        f.truncate(cut)
    return cut


class FaultInjector:
    """A deterministic fault schedule plus the per-site hit counters.

    Args:
      points: iterable of :class:`FaultPoint` (or ``(site, hit, action)``
        tuples).  At most one fault per (site, hit) pair.
      seed: seeds the RNG that picks torn-tail cut offsets and corrupt
        byte offsets — the *whole* chaos run is a function of (schedule,
        seed, workload), so a failing run replays exactly.

    ``fired`` records every fault that actually fired, as
    ``(site, hit, action, detail)`` — tests assert on it to prove the
    scheduled chaos actually happened (a chaos test whose faults silently
    stopped firing is a green light lying).
    """

    def __init__(self, points: Iterable, seed: int = 0):
        self._points = {}
        for p in points:
            if not isinstance(p, FaultPoint):
                p = FaultPoint(*p)
            key = (p.site, p.hit)
            if key in self._points:
                raise ValueError(f"duplicate fault point for {key}")
            self._points[key] = p
        self._rng = np.random.default_rng(seed)
        self._counts: dict = {}
        self._lock = threading.Lock()
        self.fired: list = []

    def disarm(self) -> None:
        """Drop every not-yet-fired fault (recovery code reuses the same
        durable paths; a crash scheduled at hit 2 of ``wal.append`` must
        not re-fire while replaying)."""
        with self._lock:
            self._points.clear()

    def pending(self) -> list:
        """Scheduled-but-unfired faults (empty after a complete run)."""
        with self._lock:
            return sorted(self._points)

    def fire(self, site: str, **ctx) -> None:
        with self._lock:
            hit = self._counts.get(site, 0)
            self._counts[site] = hit + 1
            p = self._points.pop((site, hit), None)
            if p is None:
                return
            if p.action == "crash":
                self.fired.append((site, hit, "crash", None))
                raise InjectedCrash(f"injected crash at {site}#{hit}")
            if p.action == "torn_tail":
                cut = _tear(ctx["path"], ctx["record_span"], self._rng)
                self.fired.append((site, hit, "torn_tail", cut))
                raise InjectedCrash(
                    f"injected torn write at {site}#{hit} (cut @{cut})")
            if p.action == "corrupt":
                off = _flip_byte(ctx["path"], self._rng)
                self.fired.append((site, hit, "corrupt", off))
                return  # silent: detection is the gates' job
            # "unavailable"
            self.fired.append((site, hit, "unavailable", None))
            raise InjectedUnavailable(
                f"injected storage unavailability at {site}#{hit}")


_ACTIVE: Optional[FaultInjector] = None


def fire(site: str, **ctx) -> None:
    """Declare a fault site.  No-op (one global load + ``is None``) unless
    an injector is active — durable code paths call this unconditionally."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(site, **ctx)


@contextlib.contextmanager
def active(injector: FaultInjector):
    """Install ``injector`` as the process-wide fault schedule."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = injector
    try:
        yield injector
    finally:
        _ACTIVE = prev


def random_schedule(seed: int, catalog: Sequence, n_faults: int = 1,
                    max_hit: int = 8) -> list:
    """A seeded random fault schedule over a site/action catalog.

    ``catalog`` is a sequence of ``(site, actions)`` pairs; the returned
    list of :class:`FaultPoint` is a pure function of ``seed``, so a chaos
    sweep over seeds is reproducible run to run.
    """
    rng = np.random.default_rng(seed)
    points, used = [], set()
    while len(points) < n_faults:
        site, actions = catalog[int(rng.integers(0, len(catalog)))]
        hit = int(rng.integers(0, max_hit))
        if (site, hit) in used:
            continue
        used.add((site, hit))
        action = actions[int(rng.integers(0, len(actions)))]
        points.append(FaultPoint(site, hit, action))
    return points
