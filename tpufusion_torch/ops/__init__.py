"""Kernel wrappers and their plain PyTorch versions; exports the names of
`tpufusion/ops/__init__.py` but `nearest_wins_scatter`, the TPU-only
scatter formulation the port does not carry over (the z-buffer is
`ops/projection.py::nearest_wins_image`)."""

from tpufusion_torch.ops.components import connected_components
from tpufusion_torch.ops.scatter import scatter_count, scatter_max

__all__ = ["scatter_count", "scatter_max", "connected_components"]
