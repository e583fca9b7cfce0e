"""Extrinsic lidar->camera calibration by reprojection optimization (a
copy of `tpufusion/tools/calibrate.py`: numpy and scipy).

Rebuilds `modules/camera-lidar-calibration/lidar_image_calibration_
standalone.py:24-92`: SLSQP over the 6-DoF transform (3 euler angles +
translation) minimizing the mean pixel reprojection error of hand-labeled
3D<->2D correspondences, with random restarts until the error drops under
an acceptance threshold (the reference accepted 28.82 px over 6 points with
threshold 30). `calibrate_from_settings` reads the camera yaml through
`CameraModel.load_camera_calibration`, which imports yaml.
"""

from __future__ import annotations

import json

import numpy as np
from scipy.optimize import minimize

from tpufusion_torch.geometry.camera import CameraModel


def reprojection_error(
    params: np.ndarray,  # (6,) rz1, rx, rz2 euler (reference order) + txyz
    camera: CameraModel,
    points3d: np.ndarray,  # (N, 3) lidar frame
    pixels: np.ndarray,  # (N, 2) hand-labeled
    axes: str = "rzxz",
) -> float:
    """SUM of per-point pixel distances — the reference's cost
    (lidar_image_calibration_standalone.py:44-62) and what its <30 px
    acceptance threshold is calibrated against."""
    cam = CameraModel()
    cam.K, cam.D, cam.R, cam.P = camera.K, camera.D, camera.R, camera.P
    cam.width, cam.height = camera.width, camera.height
    cam.set_extrinsic_from_euler(params[:3], params[3:6], axes)
    uv = cam.project_lidar_to_pixels(points3d)
    return float(np.linalg.norm(uv - pixels, axis=1).sum())


def calibrate(
    camera: CameraModel,
    points3d: np.ndarray,
    pixels: np.ndarray,
    bounds=None,
    axes: str = "rzxz",
    accept_px: float = 30.0,
    max_restarts: int = 50,
    seed: int = 0,
) -> dict:
    rng = np.random.default_rng(seed)
    if bounds is None:
        bounds = [(-np.pi, np.pi)] * 3 + [(-3.0, 3.0)] * 3
    best = None
    for attempt in range(max_restarts):
        x0 = np.asarray([rng.uniform(lo, hi) for lo, hi in bounds])
        res = minimize(
            reprojection_error,
            x0,
            args=(camera, points3d, pixels, axes),
            method="SLSQP",
            bounds=bounds,
        )
        if best is None or res.fun < best.fun:
            best = res
        if best.fun <= accept_px:
            break
    return {
        "rotations": best.x[:3].tolist(),
        "translation": best.x[3:6].tolist(),
        "euler_axes": axes,
        "error_px": float(best.fun),
        "restarts": attempt + 1,
        "accepted": bool(best.fun <= accept_px),
    }


def calibrate_from_settings(settings_json: str, camera_yaml: str, **kw) -> dict:
    """settings JSON carries points/uvs/bounds like the reference's
    data/calibration/lidar_calibration.json (which uses commentjson —
    `//` comments are stripped here). The reference orders parameters
    (tx, ty, tz, Ay, Ap, Ar); internally we use (angles, translation), so
    the bounds are reordered accordingly."""
    import re

    with open(settings_json) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    s = json.loads(text)
    bounds = s.get("bounds")
    if bounds is not None and len(bounds) == 6:
        bounds = list(bounds[3:]) + list(bounds[:3])  # (t, r) -> (r, t)
    camera = CameraModel().load_camera_calibration(camera_yaml)
    return calibrate(
        camera,
        np.asarray(s["points"], float)[:, :3],
        np.asarray(s["uvs"], float),
        bounds=bounds,
        axes=s.get("axes", "rzxz"),
        **kw,
    )
