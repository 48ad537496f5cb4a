"""Host utilities of the PyTorch port: reading JAX trainer checkpoints."""
