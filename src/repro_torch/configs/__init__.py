"""Model configurations of the PyTorch port (the port's own copies of
the JAX package's configuration records)."""
