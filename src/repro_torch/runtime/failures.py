"""Failure handling: a supervisor loop with checkpoint/restart semantics.

Models the production control flow: run attempts; on failure restore the
last complete checkpoint and continue.  Because the training step is
bit-deterministic (reproducible accumulation + deterministic data quanta),
a restart replays the *exact* trajectory — asserted in the tests.  The
stream engine uses the failure type its fault injector raises and the
deterministic backoff its service retries with.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

__all__ = ["SimulatedFailure", "exponential_backoff", "SupervisorConfig",
           "SupervisorReport", "run_supervised"]

log = logging.getLogger(__name__)


class SimulatedFailure(RuntimeError):
    """Raised by fault-injection hooks in tests.

    :class:`repro_torch.runtime.faultinject.InjectedCrash` subclasses it,
    so recovery loops handle scheduled and hand-raised failures alike."""


def exponential_backoff(base_s: float, attempt: int,
                        cap_s: float = 30.0, factor: float = 2.0) -> float:
    """Deterministic capped exponential backoff delay, in seconds.

    ``min(cap_s, base_s * factor**attempt)`` with ``attempt`` 0-based — a
    pure function of its arguments (no jitter), so retry schedules are part
    of the reproducible run.  ``base_s <= 0`` disables backoff.
    """
    if base_s <= 0.0:
        return 0.0
    return float(min(cap_s, base_s * factor ** max(attempt, 0)))


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 10
    backoff_s: float = 0.0         # base delay; doubles per consecutive
    backoff_cap_s: float = 30.0    # restart up to this cap


@dataclasses.dataclass
class SupervisorReport:
    restarts: int
    completed_steps: int
    failures: list


def run_supervised(make_state: Callable[[], object],
                   restore_state: Callable[[], Optional[object]],
                   step_fn: Callable[[object, int], object],
                   save_state: Callable[[object, int], None],
                   total_steps: int,
                   ckpt_every: int,
                   cfg: SupervisorConfig = SupervisorConfig()
                   ) -> SupervisorReport:
    """Generic supervised training loop.

    * make_state():            fresh state (step 0)
    * restore_state():         latest checkpointed (state) or None
    * step_fn(state, step):    one training step -> new state (may raise)
    * save_state(state, step): checkpoint
    """
    failures = []
    restarts = 0
    while True:
        restored = restore_state()
        state = restored if restored is not None else make_state()
        step = getattr(state, "step", 0)
        try:
            while step < total_steps:
                state = step_fn(state, step)
                step += 1
                if step % ckpt_every == 0 or step == total_steps:
                    save_state(state, step)
            return SupervisorReport(restarts=restarts,
                                    completed_steps=step,
                                    failures=failures)
        except SimulatedFailure as e:
            failures.append((step, repr(e)))
            restarts += 1
            log.warning("failure at step %d (%s); restart %d",
                        step, e, restarts)
            if restarts > cfg.max_restarts:
                raise
            delay = exponential_backoff(cfg.backoff_s, restarts - 1,
                                        cfg.backoff_cap_s)
            if delay:
                time.sleep(delay)
