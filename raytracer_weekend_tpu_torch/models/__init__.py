"""Scene catalog (the sphere scenes of the JAX package's catalog)."""
