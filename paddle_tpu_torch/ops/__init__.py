"""Plain tensor ops the model uses (the JAX package's registered ops)."""
