"""numpy request sources for the port (no JAX), the batch pipeline, and
the dataset on disk: bags, the ETL, the registry; exports the names of
`tpufusion/data/__init__.py`. The torch-backed ones load on first use, so
the numpy host tools that read a dataset (`tools.datadiff`) start
without torch."""

from tpufusion_torch.data.registry import DirSet, read_registry

__all__ = [
    "DirSet",
    "read_registry",
    "synthesize_dataset",
    "synthesize_points_batch",
    "BatchPipeline",
    "epoch_indices",
]


def __getattr__(name: str):
    if name in ("BatchPipeline", "epoch_indices"):
        from tpufusion_torch.data import pipeline

        return getattr(pipeline, name)
    if name in ("synthesize_dataset", "synthesize_points_batch"):
        from tpufusion_torch.data import synthetic

        return getattr(synthetic, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
