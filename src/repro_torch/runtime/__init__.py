"""Step builders of the port (the JAX package's ``runtime`` as far as
the ported LM path needs it)."""
