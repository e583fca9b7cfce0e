"""Reader for datasets extracted in the reference's on-disk layout (a copy
of `tpufusion/data/reference_reader.py`).

The reference ETL (`modules/lidar/process/extract_rosbag.py:52-60`) writes
per-bag directories:

    <dir>/lidar_360/<ts>_{distance,height,intensity}_float.lidar.p   (py2 pickles)
    <dir>/camera/<ts>_image.png
    <dir>/radar/radar_tracks.csv
    <dir>/lidar_timestamps.csv, camera_timestamps.csv
    <dir>/obs_poses_interp_transform.csv, obs_poses_camera.csv

This module loads those artifacts into dense float32 arrays (channel order
distance/height/intensity, matching `modules/lidar/train/loader.py:192-209`)
so existing extracted datasets keep working against the new framework.
Python-2 pickles are read with encoding='latin1'.
"""

from __future__ import annotations

import csv
import os
import pickle

import numpy as np

from tpufusion_torch.data.registry import DirSet, load_pose_csv

_CHANNELS = ("distance", "height", "intensity")


def _load_channel_pickle(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f, encoding="latin1"), dtype=np.float32)


def load_lidar_frame(dirpath: str, timestamp: int | str) -> np.ndarray:
    """(H, W, 3) float32 for one timestamp."""
    prefix = os.path.join(dirpath, "lidar_360", str(timestamp))
    chans = [
        _load_channel_pickle(f"{prefix}_{c}_float.lidar.p") for c in _CHANNELS
    ]
    return np.stack(chans, axis=-1)


def load_timestamps(dirpath: str, source: str = "lidar") -> list[int]:
    fname = os.path.join(dirpath, f"{source}_timestamps.csv")
    out = []
    with open(fname) as f:
        for row in csv.DictReader(f):
            out.append(int(row["timestamp"]))
    return out


def load_camera_frame(dirpath: str, timestamp: int | str) -> np.ndarray:
    """(H, W, 1) float grayscale, like loader.py:211-231."""
    import cv2

    path = os.path.join(dirpath, "camera", f"{timestamp}_image.png")
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return np.asarray(img, dtype=np.float32)[..., None]


def load_radar_tracks(dirpath: str) -> list[dict[str, float]]:
    path = os.path.join(dirpath, "radar", "radar_tracks.csv")
    out = []
    with open(path) as f:
        for row in csv.DictReader(f):
            out.append({k: float(v) for k, v in row.items()})
    return out


class ReferenceDirDataset:
    """All lidar frames + interpolated ground truth of one extracted dir.

    Frames are matched to poses by timestamp like
    `loader.py:367-419` (the GT csv's timestamps index lidar_360 files).
    """

    def __init__(self, dirset: DirSet):
        self.dirset = dirset
        self.poses = load_pose_csv(
            os.path.join(dirset.dir, "obs_poses_interp_transform.csv")
        )
        self.size = np.asarray(dirset.obstacle_size, dtype=np.float32)

    def __len__(self) -> int:
        return len(self.poses)

    def frame(self, i: int) -> dict[str, np.ndarray]:
        p = self.poses[i]
        return {
            "image": load_lidar_frame(self.dirset.dir, p["timestamp"]),
            "center": np.asarray([p["tx"], p["ty"], p["tz"]], np.float32),
            "yaw": np.float32(p["rz"]),
            "size": self.size,
            "timestamp": np.int64(p["timestamp"]),
        }

    def to_arrays(self) -> dict[str, np.ndarray]:
        frames = [self.frame(i) for i in range(len(self))]
        return {
            k: np.stack([f[k] for f in frames]) for k in frames[0].keys()
        }
