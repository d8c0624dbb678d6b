"""Training launch: the data-parallel mesh over ``torch.distributed``
(:mod:`~repro_torch.launch.mesh`), ZeRO shard placement
(:mod:`~repro_torch.launch.shardings`), the train step
(:mod:`~repro_torch.launch.train_step`) and the trainer with its CLI
(:mod:`~repro_torch.launch.train`)."""
