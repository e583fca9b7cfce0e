"""Pose interpolation across timestamp streams.

Same semantics as `modules/lidar/common/interpolate.py:70-93`: independent
1-D linear interpolation of tx/ty/tz/rz keyed on timestamp, with linear
extrapolation beyond the ends (scipy interp1d fill_value='extrapolate').

The port's copy of `tpufusion/eval/interpolate.py` (numpy only);
`tests/test_torch_imports.py` holds the two equal.
"""

from __future__ import annotations

import csv

import numpy as np
from scipy.interpolate import interp1d


def load_timestamps_csv(path: str) -> list[int]:
    out = []
    with open(path) as f:
        for row in csv.DictReader(f):
            out.append(int(row["timestamp"]))
    return out


def interpolate_poses(
    source: list[dict], dest_timestamps: list[int]
) -> list[dict]:
    """source rows need timestamp/tx/ty/tz/rz; returns one row per dest
    timestamp with rx=ry=0 (the reference never interpolates those)."""
    ts = np.asarray([s["timestamp"] for s in source], dtype=np.float64)
    fns = {
        k: interp1d(
            ts,
            np.asarray([s[k] for s in source], dtype=np.float64),
            fill_value="extrapolate",
        )
        for k in ("tx", "ty", "tz", "rz")
    }
    out = []
    for t in dest_timestamps:
        out.append(
            {
                "timestamp": int(t),
                "tx": float(fns["tx"](t)),
                "ty": float(fns["ty"](t)),
                "tz": float(fns["tz"](t)),
                "rx": 0.0,
                "ry": 0.0,
                "rz": float(fns["rz"](t)),
            }
        )
    return out


def interpolate_from_csv(csv_file: str, timestamps: list[int] | str) -> list[dict]:
    if isinstance(timestamps, str):
        timestamps = load_timestamps_csv(timestamps)
    rows = []
    with open(csv_file) as f:
        for r in csv.DictReader(f):
            rows.append(
                {
                    "timestamp": int(r["timestamp"]),
                    "tx": float(r["tx"]),
                    "ty": float(r["ty"]),
                    "tz": float(r["tz"]),
                    "rz": float(r.get("rz", 0.0)),
                }
            )
    return interpolate_poses(rows, timestamps)
