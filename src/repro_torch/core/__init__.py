"""TinyReptile and every baseline it compares to, on one federated round
engine (``engine.run_federated``); see the JAX package's ``core`` for
the full design. Ported so far: the plain single-device route with the
five fp32 strategies and the uniform, partial-participation and
straggler schedules."""
from repro_torch.core.engine import CommChannel, run_federated  # noqa: F401
from repro_torch.core.fedavg import fedavg_train, fedsgd_train  # noqa: F401
from repro_torch.core.meta import (evaluate_init,  # noqa: F401
                                   finetune_batch, finetune_online)
from repro_torch.core.pipeline import (BlockPrefetcher,  # noqa: F401
                                       ClientSchedule, PartialParticipation,
                                       SamplingPolicy, StragglerSampling,
                                       UniformSampling, plan_blocks)
from repro_torch.core.reptile import reptile_train  # noqa: F401
from repro_torch.core.strategies import (FedAvgStrategy,  # noqa: F401
                                         FedSGDStrategy, FedStrategy,
                                         ReptileStrategy, TinyReptileStrategy,
                                         TransferStrategy)
from repro_torch.core.tinyreptile import tinyreptile_train  # noqa: F401
from repro_torch.core.transfer import transfer_train  # noqa: F401
