"""Radar track handling.

Covers `modules/lidar/process/radar_tracks.py` (track-message fields) and
`modules/lidar/process/process_radar_data.py:98-115` (polar track ->
lidar-frame 3D point): the reference adds the combined radar->lidar mount
offset `3.8 - 1.5494` = 2.2506 m to the polar RANGE before projecting and
reports tz = 0.

The port's copy of `tpufusion/data/radar.py` (numpy only);
`tests/test_torch_imports.py` holds the two equal.
"""

from __future__ import annotations

import csv
import dataclasses

import numpy as np

RADAR_FIELDS = (
    "status", "number", "range", "rate", "accel", "angle",
    "width", "late_rate", "moving", "power", "absolute_rate",
)

# combined radar->lidar range offset (process_radar_data.py:98,111)
RADAR_LIDAR_OFFSET = 3.8 - 1.5494


@dataclasses.dataclass
class RadarTrack:
    timestamp: int
    range: float
    angle: float  # degrees in the reference data
    rate: float = 0.0
    status: float = 0.0

    def to_xyz(self) -> np.ndarray:
        """Polar -> lidar-frame cartesian, exactly process_radar_data.py:
        108-115: offset the range, then project; tz = 0."""
        a = np.deg2rad(self.angle)
        d = self.range + RADAR_LIDAR_OFFSET
        return np.asarray([d * np.cos(a), -d * np.sin(a), 0.0], np.float64)


def load_radar_csv(path: str) -> list[RadarTrack]:
    out = []
    with open(path) as f:
        for row in csv.DictReader(f):
            out.append(
                RadarTrack(
                    timestamp=int(float(row["timestamp"])),
                    range=float(row["range"]),
                    angle=float(row["angle"]),
                    rate=float(row.get("rate", 0.0)),
                    status=float(row.get("status", 0.0)),
                )
            )
    return out


def radar_features(tracks: list[RadarTrack]) -> np.ndarray:
    """(T, 2) [range, angle] — the fusion net's radar input
    (train_fcn.py:279)."""
    return np.asarray([[t.range, t.angle] for t in tracks], np.float32)


def radar_timestamps(tracks: list[RadarTrack]) -> np.ndarray:
    return np.asarray([t.timestamp for t in tracks], np.int64)
