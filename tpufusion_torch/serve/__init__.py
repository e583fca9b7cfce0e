"""Serving: the single-frame server facade, the replay server, the fusion
inference loop, the tracker, the live viewer and its JPEG encoder; exports
the names of `tpufusion/serve/__init__.py`. They load on first use, so
the numpy encoder (`serve.jpeg`) imports without torch."""

__all__ = ["LidarPipeline", "ReplayHarness", "LatencyStats"]


def __getattr__(name: str):
    if name == "LidarPipeline":
        from tpufusion_torch.serve.pipeline import LidarPipeline

        return LidarPipeline
    if name in ("ReplayHarness", "LatencyStats"):
        from tpufusion_torch.serve import replay

        return getattr(replay, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
