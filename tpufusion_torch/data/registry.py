"""Dataset registry: CSV rows of (data_dir, metadata_csv) (a copy of
`tpufusion/data/registry.py`).

Same on-disk contract as the reference registry
(`modules/lidar/common/csv_utils.py:9-27`, format documented by
`modules/lidar/data/train_folders.csv`): each row names a per-bag output
directory and a metadata CSV carrying the obstacle dimensions (l, w, h).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from collections.abc import Iterator


@dataclasses.dataclass
class DirSet:
    dir: str
    metadata: dict[str, str]

    @property
    def obstacle_size(self) -> tuple[float, float, float]:
        return (
            float(self.metadata["l"]),
            float(self.metadata["w"]),
            float(self.metadata["h"]),
        )


def read_registry(registry_csv: str, dir_prefix: str = "") -> Iterator[DirSet]:
    with open(registry_csv) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            data_dir = os.path.join(dir_prefix, row[0]) if dir_prefix else row[0]
            meta_path = (
                os.path.join(dir_prefix, row[1]) if dir_prefix else row[1]
            )
            with open(meta_path) as mf:
                records = list(csv.DictReader(mf))
            yield DirSet(dir=data_dir, metadata=records[0])


def load_pose_csv(path: str) -> list[dict[str, float]]:
    """Per-frame ground truth rows (timestamp, tx..rz), as written next to
    the reference's extracted data (`obs_poses_interp_transform.csv`)."""
    out = []
    with open(path) as f:
        for row in csv.DictReader(f):
            out.append(
                {
                    "timestamp": int(row["timestamp"]),
                    "tx": float(row["tx"]),
                    "ty": float(row["ty"]),
                    "tz": float(row["tz"]),
                    "rx": float(row.get("rx", 0.0)),
                    "ry": float(row.get("ry", 0.0)),
                    "rz": float(row["rz"]),
                }
            )
    return out
