"""Host-side modules of the port (copies of the JAX package's core/)."""
