"""Failure primitives shared by the durable code paths.

The training supervisor of the JAX package comes with the LM stack; the
stream engine needs only the failure type its fault injector raises and
the deterministic backoff its service retries with.
"""
from __future__ import annotations

__all__ = ["SimulatedFailure", "exponential_backoff"]


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
