"""Optimizer side of training: reproducible gradient sums
(:mod:`repro_torch.optim.grad`) and AdamW (:mod:`repro_torch.optim.adamw`)."""
