"""Invariant-pixel mask: range-view pixels that never change across a
dataset (fixed returns from the capture vehicle itself). A copy of
`tpufusion/tools/invariant_mask.py` (numpy).

Rebuilds `modules/lidar/process/create_lidar_invariant_mask.py:44-62` as a
vectorized running logical-and of frame-to-frame equality — and fixes the
reference's transposed channel->reference mapping bug (`:33-38`, where the
distance image was compared against the intensity reference etc.; behavior
noted in SURVEY.md §2.1).
"""

from __future__ import annotations

import numpy as np


class InvariantMaskBuilder:
    def __init__(self):
        self.reference: np.ndarray | None = None  # (H, W, C) first frame
        self.mask: np.ndarray | None = None  # (H, W, C) still-invariant

    def update(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if self.reference is None:
            self.reference = frame.copy()
            self.mask = np.ones(frame.shape, bool)
        else:
            self.mask &= frame == self.reference

    def result(self) -> np.ndarray:
        assert self.mask is not None, "no frames seen"
        return self.mask


def build_invariant_mask(frames) -> np.ndarray:
    """frames: iterable of (H, W, C) arrays -> (H, W, C) bool mask."""
    b = InvariantMaskBuilder()
    for f in frames:
        b.update(f)
    return b.result()
