"""Test support shipped with the port (importable from tests and from
subprocess children): fault injection for the preemption-safety layer
lives in ``repro_torch.testing.faults``."""
