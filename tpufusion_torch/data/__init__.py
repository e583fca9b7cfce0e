"""numpy request sources for the port (no JAX)."""
