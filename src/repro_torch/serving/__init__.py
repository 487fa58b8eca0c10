from repro_torch.serving.adapters import Fp32Adapter, TifedAdapter  # noqa: F401
from repro_torch.serving.server import (AdaptationServer,  # noqa: F401
                                        AdaptResult, offline_adapt)
