"""Runtime support: simulated failures and deterministic fault injection.

* :mod:`repro_torch.runtime.failures`   — ``SimulatedFailure``, the
  deterministic ``exponential_backoff`` and the training supervisor
  ``run_supervised``;
* :mod:`repro_torch.runtime.stragglers` — straggler detection and the
  quantum rebalancing policy;
* :mod:`repro_torch.runtime.faultinject` — named fault sites and seeded
  fault schedules for the durable stream stores.
"""
