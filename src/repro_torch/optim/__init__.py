"""The port's optimizers and schedules (the JAX package's ``optim``)."""
from repro_torch.optim.optimizers import (AdamState, Optimizer,  # noqa: F401
                                          adamw, sgd)
from repro_torch.optim.schedules import (constant, cosine,  # noqa: F401
                                         linear_anneal, wsd)
