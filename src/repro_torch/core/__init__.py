"""TinyReptile and every baseline it compares to, on one federated round
engine (``engine.run_federated``); see the JAX package's ``core`` for
the full design. Ported: the single-device route with the five fp32
strategies and TIFeD's int8 one, the uniform, partial-participation and
straggler schedules, the fp32/fp16/int8 and partial channels, and the
persistent ``ClientPool`` with FedBuff buffering and the diurnal and
Markov availability processes, and the cohort split over the ranks of a
1-D ``clients`` mesh (``client_mesh``)."""
from repro_torch.core.engine import (CommChannel,  # noqa: F401
                                     PartialCommChannel, clear_runner_cache,
                                     client_mesh, run_federated,
                                     runner_cache_stats)
from repro_torch.core.fedavg import fedavg_train, fedsgd_train  # noqa: F401
from repro_torch.core.meta import (evaluate_init,  # noqa: F401
                                   finetune_batch, finetune_online)
from repro_torch.core.pipeline import (BlockPrefetcher,  # noqa: F401
                                       ClientSchedule, PartialParticipation,
                                       SamplingPolicy, StragglerSampling,
                                       UniformSampling, plan_blocks)
from repro_torch.core.pool import (AvailabilityProcess,  # noqa: F401
                                   BufferedAggregation, ClientPool,
                                   DiurnalAvailability, MarkovAvailability,
                                   PoolState)
from repro_torch.core.reptile import reptile_train  # noqa: F401
from repro_torch.core.strategies import (FedAvgStrategy,  # noqa: F401
                                         FedSGDStrategy, FedStrategy,
                                         ReptileStrategy, TifedStrategy,
                                         TinyReptileStrategy,
                                         TransferStrategy)
from repro_torch.core.tifed import tifed_train  # noqa: F401
from repro_torch.core.tinyreptile import tinyreptile_train  # noqa: F401
from repro_torch.core.transfer import transfer_train  # noqa: F401
