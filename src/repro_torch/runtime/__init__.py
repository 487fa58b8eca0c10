"""The port's runtime (the JAX package's ``runtime``): step builders,
the levers, the sharding rules and process meshes, the ambient mesh,
and ranks started in one call."""
