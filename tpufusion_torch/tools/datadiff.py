"""Dataset diff: the output-equivalence checker (a copy of
`tpufusion/tools/datadiff.py`, numpy).

Rebuilds `modules/rosdiff/rosdiff.py:11-86` without the rosbag dependency:
compares two extracted dataset directories (or two dicts of timestamp
streams) by per-stream message counts and timestamp-delta statistics,
reporting streams whose counts or cadence diverge.
"""

from __future__ import annotations

import os

import numpy as np

from tpufusion_torch.data.reference_reader import load_timestamps


def stream_summary(timestamps) -> dict:
    ts = np.asarray(sorted(timestamps), np.int64)
    if len(ts) < 2:
        return {"count": int(len(ts)), "dt_mean": 0.0, "dt_max": 0.0, "dt_min": 0.0}
    dt = np.diff(ts) / 1e9  # ns -> s
    return {
        "count": int(len(ts)),
        "dt_mean": float(dt.mean()),
        "dt_max": float(dt.max()),
        "dt_min": float(dt.min()),
    }


def summarize_dir(dirpath: str) -> dict[str, dict]:
    out = {}
    for source in ("lidar", "camera"):
        path = os.path.join(dirpath, f"{source}_timestamps.csv")
        if os.path.exists(path):
            out[source] = stream_summary(load_timestamps(dirpath, source))
    return out


def compare_summaries(a: dict[str, dict], b: dict[str, dict], rel_tol=0.05):
    """Returns list of (stream, field, a_value, b_value) divergences."""
    diffs = []
    for stream in sorted(set(a) | set(b)):
        if stream not in a or stream not in b:
            diffs.append((stream, "presence", stream in a, stream in b))
            continue
        for field in ("count", "dt_mean", "dt_max"):
            va, vb = a[stream][field], b[stream][field]
            denom = max(abs(va), abs(vb), 1e-9)
            if abs(va - vb) / denom > rel_tol:
                diffs.append((stream, field, va, vb))
    return diffs


def diff_dirs(dir_a: str, dir_b: str, rel_tol=0.05):
    return compare_summaries(summarize_dir(dir_a), summarize_dir(dir_b), rel_tol)
