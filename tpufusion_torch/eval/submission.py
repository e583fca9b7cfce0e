"""Submission generation: pose CSV -> camera-timestamp tracklet XML.

Mirrors `modules/lidar/train/generate_tracklet_predictions.py:11-67`:
interpolate predicted poses onto the camera timestamp stream, forward- then
back-fill NaNs (frames before the first / after the last valid prediction),
apply an optional fixed offset (the reference ships one in
`modules/lidar/data/tracklet_offset.csv`), and emit tracklet XML.

The port's copy of `tpufusion/eval/submission.py` (numpy only);
`tests/test_torch_imports.py` holds the two equal.
"""

from __future__ import annotations

import csv

import numpy as np

from tpufusion_torch.eval.interpolate import interpolate_from_csv, load_timestamps_csv
from tpufusion_torch.eval.tracklet_xml import Tracklet, TrackletCollection


def _fill_nans(values: np.ndarray) -> np.ndarray:
    """pandas-style ffill then bfill along axis 0."""
    out = values.copy()
    for col in range(out.shape[1]):
        v = out[:, col]
        mask = np.isnan(v)
        if mask.all():
            v[:] = 0.0
            continue
        idx = np.where(~mask, np.arange(len(v)), 0)
        np.maximum.accumulate(idx, out=idx)
        v[:] = v[idx]
        # leading NaNs remain (idx 0 may be NaN) -> backfill
        mask = np.isnan(v)
        if mask.any():
            first_valid = np.argmin(mask)
            v[:first_valid] = v[first_valid]
    return out


def generate_submission(
    prediction_csv: str,
    camera_timestamps: str | list[int],
    metadata: dict[str, float],
    out_xml: str,
    offset: tuple[float, float, float] | None = None,
    object_type: str = "Car",
) -> TrackletCollection:
    if isinstance(camera_timestamps, str):
        camera_timestamps = load_timestamps_csv(camera_timestamps)

    interp = interpolate_from_csv(prediction_csv, camera_timestamps)
    arr = np.asarray(
        [[p["tx"], p["ty"], p["tz"], p["rz"]] for p in interp], np.float64
    )
    arr = _fill_nans(arr)
    if offset is not None:
        arr[:, 0] += offset[0]
        arr[:, 1] += offset[1]
        arr[:, 2] += offset[2]

    t = Tracklet(
        object_type=object_type,
        l=float(metadata["l"]),
        w=float(metadata["w"]),
        h=float(metadata["h"]),
        first_frame=0,
    )
    for row in arr:
        t.poses.append(
            {
                "tx": row[0], "ty": row[1], "tz": row[2],
                "rx": 0.0, "ry": 0.0, "rz": row[3],
            }
        )
    coll = TrackletCollection(tracklets=[t])
    coll.write_xml(out_xml)
    return coll


def write_predictions_csv(poses, timestamps, path: str) -> None:
    """Pose rows -> the reference prediction CSV schema
    (`modules/lidar/train/predict.py:296-311`)."""
    with open(path, "w", newline="") as f:
        wr = csv.DictWriter(
            f, ["timestamp", "tx", "ty", "tz", "rx", "ry", "rz", "l", "w", "h"]
        )
        wr.writeheader()
        for pose, ts in zip(poses, timestamps):
            pose = list(map(float, pose))
            wr.writerow(
                {
                    "timestamp": ts,
                    "tx": pose[0], "ty": pose[1], "tz": pose[2],
                    "rx": 0.0, "ry": 0.0, "rz": pose[3] if len(pose) > 3 else 0.0,
                    "l": pose[4] if len(pose) > 4 else 0.0,
                    "w": pose[5] if len(pose) > 5 else 0.0,
                    "h": pose[6] if len(pose) > 6 else 0.0,
                }
            )


def write_metadata_csv(poses, path: str) -> None:
    """Mean detected box size (`predict.py:313-320`)."""
    arr = np.asarray(poses, np.float64)[:, 4:7]
    arr = arr[~np.all(arr == 0.0, axis=1)]
    size = arr.mean(axis=0) if len(arr) else np.zeros(3)
    with open(path, "w") as f:
        f.write("l,w,h\n")
        f.write("{:.4f},{:.4f}, {:.4f}\n".format(size[0], size[1], size[2]))
