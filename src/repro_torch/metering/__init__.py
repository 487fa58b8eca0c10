from repro_torch.metering.memory import (MemoryMeter,  # noqa: F401
                                         algorithm_memory_report)
from repro_torch.metering.tracker import MetricsTracker  # noqa: F401
