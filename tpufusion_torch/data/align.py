"""Multi-sensor timestamp alignment.

Replaces the O(frames x rows) python nearest-timestamp joins of
`modules/lidar/train/train_fcn.py:208-213,239-245` with vectorized
searchsorted joins: for each camera frame, the nearest lidar frame and the
nearest radar track row.

The port's copy of `tpufusion/data/align.py` (numpy only);
`tests/test_torch_imports.py` holds the two equal.
"""

from __future__ import annotations

import numpy as np


def nearest_indices(sorted_ts: np.ndarray, query_ts: np.ndarray) -> np.ndarray:
    """Index of the nearest value in sorted_ts for each query (ties -> the
    smaller timestamp, matching python's min(key=abs) scan order)."""
    sorted_ts = np.asarray(sorted_ts, np.int64)
    query_ts = np.asarray(query_ts, np.int64)
    pos = np.searchsorted(sorted_ts, query_ts)
    lo = np.clip(pos - 1, 0, len(sorted_ts) - 1)
    hi = np.clip(pos, 0, len(sorted_ts) - 1)
    pick_hi = np.abs(sorted_ts[hi] - query_ts) < np.abs(sorted_ts[lo] - query_ts)
    return np.where(pick_hi, hi, lo)


def align_camera_lidar_radar(
    camera_ts: np.ndarray,
    lidar_ts: np.ndarray,
    radar_ts: np.ndarray,
) -> dict[str, np.ndarray]:
    """For each camera frame: nearest lidar index and nearest radar index.

    Inputs must be sorted ascending (extraction order); asserts that.
    """
    lidar_ts = np.asarray(lidar_ts, np.int64)
    radar_ts = np.asarray(radar_ts, np.int64)
    assert (np.diff(lidar_ts) >= 0).all() and (np.diff(radar_ts) >= 0).all()
    return {
        "lidar_index": nearest_indices(lidar_ts, camera_ts),
        "radar_index": nearest_indices(radar_ts, camera_ts),
    }
