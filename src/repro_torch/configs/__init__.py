"""Model configurations (copies of the JAX package's ``repro.configs``)."""
