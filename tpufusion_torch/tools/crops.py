"""Detection crop extractor: camera-frame boxes -> per-object JPEGs (a
copy of `tpufusion/tools/crops.py`; cv2 imported where a crop is written).

Rebuilds `modules/video/extract_image.py:15-33` minus its external YOLO
detector (pyDarknet, never vendored — `reader_yolo.py:26-41`): the crops
here come from the framework's OWN boxes — predicted poses or ground-truth
tracklets — projected into the camera through the CameraModel, instead of
a 2D detector. Same purpose: training material for a downstream
orientation classifier.

Crop rounding matches the reference exactly (floor(x + 0.5), clamped to
the image). Filenames are deterministic (`<label>_<tag>_<index>.jpg`)
where the reference appended time.time() — a documented divergence so
re-runs are reproducible.
"""

from __future__ import annotations

import os

import numpy as np


def crop_box(image: np.ndarray, box) -> np.ndarray | None:
    """box = (top, left, bottom, right) floats; reference rounding/clamp
    semantics (extract_image.py:22-27). Returns None for empty crops."""
    top, left, bottom, right = box
    h, w = image.shape[:2]
    top = max(0, int(np.floor(top + 0.5)))
    left = max(0, int(np.floor(left + 0.5)))
    bottom = min(h, int(np.floor(bottom + 0.5)))
    right = min(w, int(np.floor(right + 0.5)))
    if bottom <= top or right <= left:
        return None
    return image[top:bottom, left:right]


def box_from_pose(pose, camera, crop_top: int = 0):
    """(tx, ty, tz, rz, l, w, h) -> camera-frame (top, left, bottom,
    right) via the 8 projected corners (yaw-less, like the reference's
    camera footprint, encoder.py:240-268)."""
    from tpufusion_torch.geometry.boxes import _CORNER_SIGNS

    tx, ty, tz, _rz, l, w, h = [float(v) for v in pose[:7]]
    if l <= 0 or w <= 0:
        return None
    corners = (
        np.array([tx, ty, tz]) + _CORNER_SIGNS * np.array([l, w, h]) / 2.0
    )
    if not np.all(corners[:, 0] > 0.5):  # behind the camera
        return None
    uv = camera.project_lidar_to_pixels(corners)
    u0, v0 = uv.min(axis=0)
    u1, v1 = uv.max(axis=0)
    return (v0 - crop_top, u0, v1 - crop_top, u1)


def extract_crops(
    images: np.ndarray,  # (F, H, W) or (F, H, W, C)
    poses,  # (F, >=7) rows: tx ty tz rz l w h (zero row = no detection)
    camera,
    out_dir: str,
    label: str = "Car",
    tag: str = "dataset",
    crop_top: int = 0,
) -> list[str]:
    """Crop every frame's box; returns the written file paths."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, (img, pose) in enumerate(zip(images, poses)):
        if np.all(np.asarray(pose[:3]) == 0.0):
            continue
        box = box_from_pose(pose, camera, crop_top)
        if box is None:
            continue
        crop = crop_box(img, box)
        if crop is None or crop.size == 0:
            continue
        path = os.path.join(out_dir, f"{label}_{tag}_{i:05d}.jpg".replace(" ", "-"))
        cv2.imwrite(path, crop)
        written.append(path)
    return written
