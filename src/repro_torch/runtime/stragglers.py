"""Straggler detection and mitigation policy.

At scale, slow hosts (thermal throttling, failing memory, network
congestion) stretch every synchronous step.  The monitor tracks per-host
step-time EWMAs against the fleet median and emits mitigation actions:

* ``rebalance``  — shrink the slow host's data-shard slice (work stealing);
  the repro gradient path makes re-assignment *bitwise safe*: moving quanta
  between hosts cannot change the update.
* ``evict``      — persistent stragglers are marked for replacement; the
  supervisor (runtime/failures.py) restarts them from the last checkpoint.

The policy is pure bookkeeping (host side, no tensors), so it is unit-testable
without hardware.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["StragglerConfig", "HostStats", "StragglerMonitor",
           "rebalance_quanta"]


@dataclasses.dataclass
class StragglerConfig:
    ewma_alpha: float = 0.2
    slow_factor: float = 1.5       # x median -> straggler
    evict_factor: float = 3.0      # x median -> evict candidate
    patience: int = 5              # consecutive slow steps before action
    min_quanta: int = 1            # never shrink a shard below this


@dataclasses.dataclass
class HostStats:
    ewma: Optional[float] = None
    slow_streak: int = 0


class StragglerMonitor:
    def __init__(self, hosts: List[str], cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.stats: Dict[str, HostStats] = {h: HostStats() for h in hosts}

    def record_step(self, times: Dict[str, float]) -> Dict[str, str]:
        """Feed per-host step wall-times; returns {host: action} where action
        in {'rebalance', 'evict'} for hosts needing mitigation."""
        a = self.cfg.ewma_alpha
        for h, t in times.items():
            st = self.stats[h]
            st.ewma = t if st.ewma is None else (1 - a) * st.ewma + a * t
        med = self._median([s.ewma for s in self.stats.values()
                            if s.ewma is not None])
        actions: Dict[str, str] = {}
        for h, st in self.stats.items():
            if st.ewma is None or med is None:
                continue
            if st.ewma > self.cfg.slow_factor * med:
                st.slow_streak += 1
            else:
                st.slow_streak = 0
            if st.slow_streak >= self.cfg.patience:
                if st.ewma > self.cfg.evict_factor * med:
                    actions[h] = "evict"
                else:
                    actions[h] = "rebalance"
        # publish the monitor's internal state: per-host EWMA gauges, the
        # fleet median, and one counter per mitigation decision, so a
        # dashboard can watch straggling develop instead of learning about
        # it from an eviction log line
        for h, st in self.stats.items():
            if st.ewma is not None:
                obs_metrics.gauge("straggler_step_ewma_seconds",
                                  host=h).set(st.ewma)
        if med is not None:
            obs_metrics.gauge("straggler_fleet_median_seconds").set(med)
        for h, action in actions.items():
            obs_metrics.counter("straggler_actions_total",
                                action=action).inc()
            obs_trace.event("straggler.action", host=h, action=action,
                            ewma=self.stats[h].ewma, median=med)
        return actions

    @staticmethod
    def _median(xs):
        xs = sorted(xs)
        if not xs:
            return None
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def rebalance_quanta(assignment: Dict[str, int], slow_hosts: List[str],
                     cfg: StragglerConfig = StragglerConfig()
                     ) -> Dict[str, int]:
    """Shift one quantum from each slow host to the least-loaded fast host.

    ``assignment``: host -> number of data quanta per step.  Totals are
    preserved (the global batch is invariant); with repro accumulation the
    resulting update is bit-identical to the pre-rebalance assignment.
    """
    out = dict(assignment)
    fast = [h for h in out if h not in slow_hosts]
    if not fast:
        return out
    for h in slow_hosts:
        if out.get(h, 0) > cfg.min_quanta:
            tgt = min(fast, key=lambda f: out[f])
            out[h] -= 1
            out[tgt] += 1
    return out
