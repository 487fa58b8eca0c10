from repro_torch.data.tasks import (KWSTasks, OmniglotTasks,  # noqa: F401
                                    SineTasks, TaskDistribution)
from repro_torch.data.lm import (LMClientStream,  # noqa: F401
                                 LmTaskDistribution, lm_loss)
