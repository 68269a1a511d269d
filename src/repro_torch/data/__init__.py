"""repro_torch.data — the synthetic data pipeline (port of
``repro.data``): :mod:`repro_torch.data.pipeline`."""
