"""Checkpoints: atomic, verifiable snapshots in the JAX package's layout
(:mod:`repro_torch.checkpoint.ckpt`)."""
