"""Synthetic, deterministic training data (:mod:`repro_torch.data.pipeline`)."""
