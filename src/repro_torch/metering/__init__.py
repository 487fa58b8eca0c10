from repro_torch.metering.tracker import MetricsTracker  # noqa: F401
