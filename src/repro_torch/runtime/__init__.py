"""Runtime support: simulated failures and deterministic fault injection.

* :mod:`repro_torch.runtime.failures`   — ``SimulatedFailure`` and the
  deterministic ``exponential_backoff`` the stream service retries with;
* :mod:`repro_torch.runtime.faultinject` — named fault sites and seeded
  fault schedules for the durable stream stores.
"""
