"""Schedules of the port (the JAX package's ``optim`` as far as the
ported paths need it)."""
from repro_torch.optim.schedules import linear_anneal  # noqa: F401
