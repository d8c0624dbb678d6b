"""repro_torch.obs: spans, metrics and bitwise fingerprints.

* :mod:`repro_torch.obs.trace`       — nested spans + point events,
  env-gated via ``REPRO_TRACE``, no-op fast path when disabled;
* :mod:`repro_torch.obs.metrics`     — process-local counters/gauges/
  histograms (``REPRO_METRICS=0`` turns recording off);
* :mod:`repro_torch.obs.fingerprint` — sha256 fingerprints of tables,
  pytrees and result dicts under the JAX package's byte layout, plus the
  run manifest and fingerprint files.

``python -m repro_torch.obs.report`` summarizes a trace/metrics file;
``python -m repro_torch.obs.audit`` is the fresh-process determinism audit.
"""
from repro_torch.obs import fingerprint, metrics, trace  # noqa: F401
from repro_torch.obs.fingerprint import (  # noqa: F401
    fingerprint_array, fingerprint_pytree, fingerprint_results,
    fingerprint_table, run_manifest)
from repro_torch.obs.metrics import counter, gauge, histogram  # noqa: F401
from repro_torch.obs.trace import event, span  # noqa: F401
