"""repro_torch.launch — command-line entry points (port of ``repro.launch``):
:mod:`repro_torch.launch.serve`, the serving launcher, and
:mod:`repro_torch.launch.train`, the training driver."""
