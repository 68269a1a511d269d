"""repro_torch.optim — the optimizer (port of ``repro.optim``):
:mod:`repro_torch.optim.adamw`."""
