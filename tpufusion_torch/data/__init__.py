"""numpy request sources for the port (no JAX), and the dataset on disk:
bags, the ETL, the registry."""

from tpufusion_torch.data.registry import DirSet, read_registry  # noqa: F401
