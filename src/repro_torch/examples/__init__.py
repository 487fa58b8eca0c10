"""Drivers of the paper's experiments on the port, each run as
``python -m repro_torch.examples.<name>``."""
