from repro_torch.data.tasks import (KWSTasks, OmniglotTasks,  # noqa: F401
                                    SineTasks, TaskDistribution)
