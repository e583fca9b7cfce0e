"""Multi-frame pose tracking: the reference's own numpy module
(`tpufusion/serve/tracker.py`: `PoseTracker`, `Track`,
`track_quality_metrics`), re-exported so the port has one definition.

`import tpufusion.serve.tracker` would first run
`tpufusion/serve/__init__.py`, which imports the JAX pipeline; the file
is loaded by its path instead, without the package's `__init__`, so the
port's tracking path needs no JAX.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import tpufusion

_NAME = "tpufusion_torch.serve._reference_tracker"


def _load():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    path = os.path.join(os.path.dirname(tpufusion.__file__), "serve", "tracker.py")
    spec = importlib.util.spec_from_file_location(_NAME, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[_NAME] = module  # dataclasses look their module up here
    spec.loader.exec_module(module)
    return module


_tracker = _load()
PoseTracker = _tracker.PoseTracker
Track = _tracker.Track
track_quality_metrics = _tracker.track_quality_metrics

__all__ = ["PoseTracker", "Track", "track_quality_metrics"]
