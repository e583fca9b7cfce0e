"""Fusion (camera + lidar + radar) batched inference: the counterpart of
the serving half of `tpufusion/train/fusion_trainer.py`
(`build_fusion_batches`, `predict_fusion`). Its training half
(`train_fusion`, the train step, the optimizer chain) waits for the
training slice.

`build_fusion_batches` (numpy, kept in `data/fusion.py`, which the
generators use too) joins the three sensor streams by nearest timestamp,
one sample per camera frame; `predict_fusion` runs the net over them in
fixed-size batches and writes the centroid + rz CSV.
"""

from __future__ import annotations

import csv

import numpy as np
import torch

from tpufusion_torch.data.fusion import build_fusion_batches  # noqa: F401  (served from here too)
from tpufusion_torch.models.fusion import FusionNet

CSV_FIELDS = ("timestamp", "tx", "ty", "tz", "rx", "ry", "rz", "l", "w", "h")


@torch.inference_mode()
def predict_fusion(
    net: FusionNet,
    data: dict[str, np.ndarray],
    timestamps,
    output_csv: str,
    batch_size: int = 8,
    device: torch.device | str = "cuda",
) -> None:
    """Batched fusion inference -> centroid + rz CSV (one row per frame:
    timestamp, tx, ty, tz, rx = ry = 0, rz, l = w = h = 0). The last
    partial batch is padded by repeating its last row, so every forward
    has one shape. The net is moved to `device` (the card unless the
    caller asks for "cpu"; without a card that raises)."""
    device = torch.device(device)
    net.to(device).eval()
    n = len(data["cam"])
    rows = []
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        pad = batch_size - (hi - lo)

        def pick(a):
            x = np.asarray(a[lo:hi])
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, 0)])
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        centroid, rz = net(pick(data["cam"]), pick(data["lidar"]), pick(data["radar"]))
        centroid = centroid.cpu().numpy()[: hi - lo]
        rz = rz.cpu().numpy()[: hi - lo]
        rows.extend((c[0], c[1], c[2], r[0]) for c, r in zip(centroid, rz))
    with open(output_csv, "w", newline="") as f:
        wr = csv.DictWriter(f, CSV_FIELDS)
        wr.writeheader()
        for ts, (tx, ty, tz, rz_) in zip(timestamps, rows):
            wr.writerow(
                {
                    "timestamp": ts,
                    "tx": float(tx), "ty": float(ty), "tz": float(tz),
                    "rx": 0.0, "ry": 0.0, "rz": float(rz_),
                    "l": 0.0, "w": 0.0, "h": 0.0,
                }
            )
