"""Joining the camera, lidar and radar streams into fusion samples
(counterpart of `tpufusion/train/fusion_trainer.py::build_fusion_batches`).
numpy only: the generators of `data.synthetic` and the serving entry
point of `serve.fusion` both take their samples from here.
"""

from __future__ import annotations

import numpy as np

from tpufusion_torch.data.align import align_camera_lidar_radar


def build_fusion_batches(
    cam_images: np.ndarray,  # (Fc, Hc, Wc, 1) in camera-timestamp order
    cam_ts: np.ndarray,
    cam_poses: np.ndarray,  # (Fc, 4) tx ty tz rz at camera timestamps
    lidar_images: np.ndarray,  # (Fl, H, W, 3)
    lidar_ts: np.ndarray,
    radar_feats: np.ndarray,  # (Fr, 2) range, angle
    radar_ts: np.ndarray,
) -> dict[str, np.ndarray]:
    """One aligned sample per camera frame."""
    idx = align_camera_lidar_radar(cam_ts, lidar_ts, radar_ts)
    return {
        "cam": cam_images,
        "lidar": lidar_images[idx["lidar_index"]],
        "radar": radar_feats[idx["radar_index"]],
        "centroid": np.asarray(cam_poses[:, :3], np.float32),
        "rz": np.asarray(cam_poses[:, 3:4], np.float32),
    }
