"""The JAX package's examples/ on the PyTorch port (repro_torch)."""
