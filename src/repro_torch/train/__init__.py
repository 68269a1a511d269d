"""repro_torch.train — training (port of ``repro.train``): the train step
(:mod:`repro_torch.train.trainer`) and checkpoints
(:mod:`repro_torch.train.checkpoint`)."""
