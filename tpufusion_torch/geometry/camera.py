"""Camera model: intrinsics, lidar->camera extrinsics, batched projection,
and the calibration paint table that puts camera pixels onto the BEV grid.

The numpy part is the port's copy of `tpufusion/geometry/camera.py`
(`tests/test_torch_imports.py` holds the two equal): a YAML-loaded pinhole
model whose projection is one batched matmul, the camera-source label
footprint, `rgb_onto_bev` and the synthetic forward-facing pinhole. `yaml`
and `cv2` are imported where they are used, so the module loads without
them.

Conventions preserved:
  * extrinsics from euler angles applied as euler_matrix(rz2, rx, rz1)
    with a configurable axes convention (the reference data uses 'rzxz')
    and the translation written into the last column;
  * projection through the rectified projection matrix P (3x4), i.e.
    ROS project3dToPixel.

`paint_table` and `paint_bev` are what the reference's fused benchmark
does inline: the table (BEV cell -> camera pixel, built once on the host
in float64 with `rgb_onto_bev` itself, so projection, rounding and flips
are the painter's) lives on the device, and painting a batch is one
gather.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpufusion_torch.config import BevSpec

# euler convention tables (standard axis-sequence algorithm)
_NEXT_AXIS = [1, 2, 0, 1]


def _axes_spec(axes: str):
    """Parse an axes string like 'rzxz'/'sxyz' -> (firstaxis, parity,
    repetition, frame)."""
    frame = 1 if axes[0] == "r" else 0
    seq = axes[1:]
    first = "xyz".index(seq[0])
    second = "xyz".index(seq[1])
    parity = 0 if _NEXT_AXIS[first] == second else 1
    repetition = 1 if seq[0] == seq[2] else 0
    return first, parity, repetition, frame


def euler_matrix(ai: float, aj: float, ak: float, axes: str = "sxyz") -> np.ndarray:
    """4x4 homogeneous rotation from euler angles, matching ROS
    tf.transformations.euler_matrix for any of the 24 conventions."""
    firstaxis, parity, repetition, frame = _axes_spec(axes)
    i = firstaxis
    j = _NEXT_AXIS[i + parity]
    k = _NEXT_AXIS[i - parity + 1]

    if frame:
        ai, ak = ak, ai
    if parity:
        ai, aj, ak = -ai, -aj, -ak

    si, sj, sk = math.sin(ai), math.sin(aj), math.sin(ak)
    ci, cj, ck = math.cos(ai), math.cos(aj), math.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk

    m = np.eye(4)
    if repetition:
        m[i, i] = cj
        m[i, j] = sj * si
        m[i, k] = sj * ci
        m[j, i] = sj * sk
        m[j, j] = -cj * ss + cc
        m[j, k] = -cj * cs - sc
        m[k, i] = -sj * ck
        m[k, j] = cj * sc + cs
        m[k, k] = cj * cc - ss
    else:
        m[i, i] = cj * ck
        m[i, j] = sj * sc - cs
        m[i, k] = sj * cc + ss
        m[j, i] = cj * sk
        m[j, j] = sj * ss + cc
        m[j, k] = sj * cs - sc
        m[k, i] = -sj
        m[k, j] = cj * si
        m[k, k] = cj * ci
    return m


class CameraModel:
    """Pinhole intrinsics + optional lidar->camera extrinsic transform."""

    def __init__(self):
        self.width = 0
        self.height = 0
        self.K = np.eye(3)
        self.D = np.zeros(5)
        self.R = np.eye(3)
        self.P = np.zeros((3, 4))
        self.extrinsic = np.eye(4)

    def load_camera_calibration(
        self, camera_yaml: str, lidar2cam_yaml: str | None = None
    ) -> "CameraModel":
        import yaml

        with open(camera_yaml) as f:
            calib = yaml.safe_load(f)
        self.width = int(calib["image_width"])
        self.height = int(calib["image_height"])
        self.K = np.asarray(calib["camera_matrix"]["data"], float).reshape(3, 3)
        self.D = np.asarray(calib["distortion_coefficients"]["data"], float)
        self.R = np.asarray(calib["rectification_matrix"]["data"], float).reshape(3, 3)
        self.P = np.asarray(calib["projection_matrix"]["data"], float).reshape(3, 4)
        if lidar2cam_yaml is not None:
            with open(lidar2cam_yaml) as f:
                lc = yaml.safe_load(f)
            t = lc["translation"]["data"]
            rot = lc["euler_rotations"]["data"]
            axes = lc.get("euler_axes", "rzxz")
            m = euler_matrix(rot[2], rot[1], rot[0], axes)
            m[:3, 3] = t[:3]
            self.extrinsic = m
        return self

    def set_extrinsic_from_euler(self, rotations, translation, axes="rzxz"):
        m = euler_matrix(rotations[2], rotations[1], rotations[0], axes)
        m[:3, 3] = np.asarray(translation[:3], float)
        self.extrinsic = m
        return self

    def project_lidar_to_pixels(self, points: np.ndarray) -> np.ndarray:
        """(N, 3) lidar-frame points -> (N, 2) rectified pixel coords.

        Batched equivalent of camera_model.py:48-56 (extrinsic transform
        then project3dToPixel through P).
        """
        pts = np.asarray(points, float)
        homo = np.concatenate([pts[:, :3], np.ones((len(pts), 1))], axis=1)
        cam = homo @ self.extrinsic.T  # (N, 4)
        uvw = np.concatenate([cam[:, :3], np.ones((len(pts), 1))], 1) @ self.P.T
        z = np.where(np.abs(uvw[:, 2]) > 1e-12, uvw[:, 2], 1e-12)
        return uvw[:, :2] / z[:, None]

    def rectify_image(self, raw: np.ndarray) -> np.ndarray:
        """Undistort + rectify (rectify_image.py:33-48)."""
        import cv2

        map1, map2 = cv2.initUndistortRectifyMap(
            self.K, self.D, self.R, self.P[:3, :3],
            (self.width, self.height), cv2.CV_32FC1,
        )
        return cv2.remap(raw, map1, map2, cv2.INTER_LINEAR)


def camera_label_footprint(
    center: np.ndarray,  # (3,) tx, ty, tz (lidar frame)
    size: np.ndarray,  # (3,) l, w, h
    camera: CameraModel,
    image_hw: tuple[int, int],
    crop_top: int = 430,
    margin_frac: float = 0.25,
) -> tuple[np.ndarray, tuple]:
    """Camera-source training footprint.

    Rebuilds `generate_camera_bb` / `generate_camera_label`
    (`modules/lidar/train/encoder.py:240-327`, outer_rect method): project
    the yaw-less 8-corner box + centroid into the camera, shift v by the
    camera crop, take the bbox of the 4 corners farthest from the projected
    centroid, dilate by a quarter of its extent, and rasterize a one-hot
    (background, foreground) label.
    """
    tx, ty, tz = [float(v) for v in center]
    l, w, h = [float(v) for v in size]
    signs = np.array(
        [
            [-1, 1, 1], [-1, 1, -1], [-1, -1, 1], [-1, -1, -1],
            [1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1],
        ],
        float,
    )
    corners = np.array([tx, ty, tz]) + signs * np.array([l, w, h]) / 2.0
    uv = camera.project_lidar_to_pixels(corners).astype(int)
    cuv = camera.project_lidar_to_pixels(np.array([[tx, ty, tz]])).astype(int)[0]
    d = np.linalg.norm(uv - cuv, axis=1).astype(int)
    outer = uv[np.argsort(d, kind="stable")][-4:]
    outer = outer.copy()
    outer[:, 1] -= crop_top
    ulx, uly = outer.min(axis=0)
    lrx, lry = outer.max(axis=0)
    mx = (lrx - ulx) // 4 if margin_frac == 0.25 else int((lrx - ulx) * margin_frac)
    my = (lry - uly) // 4 if margin_frac == 0.25 else int((lry - uly) * margin_frac)
    ulx, uly, lrx, lry = ulx - mx, uly - my, lrx + mx, lry + my

    hh, ww = image_hw
    label = np.zeros((hh, ww), np.float32)
    # raw numpy slice like the reference (encoder.py:322): negative starts
    # wrap, so edge-crossing boxes yield an empty (all-background) label
    label[uly:lry, ulx:lrx] = 1.0
    onehot = np.stack([1.0 - label, label], axis=-1)
    return onehot, ((ulx, uly), (lrx, lry))


def rgb_onto_bev(
    image: np.ndarray,  # (Hc, Wc, C) rectified camera image
    camera: CameraModel,
    bev_nx: int,
    bev_ny: int,
    max_range: float = 120.0,
    res_x: float = 0.2,
    res_y: float = 1.33,
    ground_z: float = -1.0,
) -> np.ndarray:
    """BASELINE config 3: paint camera channels onto the BEV grid.

    Every BEV cell center (assumed at ground height) is projected into the
    camera; cells that land inside the image take its pixel value, the rest
    are zero. Pure array math -> jit-compatible if ported to jnp; kept in
    numpy since calibration tables live on host.
    """
    xs = -max_range + res_x * (np.arange(bev_nx) + 0.5)
    ys = -max_range + res_y * (np.arange(bev_ny) + 0.5)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack(
        [gx.ravel(), gy.ravel(), np.full(gx.size, ground_z)], axis=1
    )
    uv = camera.project_lidar_to_pixels(pts)
    u = np.round(uv[:, 0]).astype(int)
    v = np.round(uv[:, 1]).astype(int)
    # forward-facing only: reject cells projecting behind the camera
    homo = np.concatenate([pts, np.ones((len(pts), 1))], 1)
    depth = (homo @ camera.extrinsic.T)[:, 2]
    ok = (
        (u >= 0) & (u < image.shape[1]) & (v >= 0) & (v < image.shape[0])
        & (depth > 0)
    )
    c = image.shape[2] if image.ndim == 3 else 1
    out = np.zeros((bev_nx * bev_ny, c), image.dtype)
    out[ok] = image[v[ok], u[ok]].reshape(-1, c)
    # same flip as the BEV raster
    return out.reshape(bev_nx, bev_ny, c)[::-1, ::-1]


def synthetic_camera(
    width: int = 1368, height: int = 1024, f: float = 1400.0
) -> CameraModel:
    """A forward-facing pinhole with reference-like intrinsics, for
    synthetic datasets that carry no calibration YAML (the real bags ship
    one; the synthesizer does not). Extrinsic maps lidar x-forward/
    y-left/z-up onto camera z-forward/x-right/y-down."""
    cam = CameraModel()
    cam.width, cam.height = width, height
    cam.P = np.asarray(
        [[f, 0.0, width / 2.0, 0.0],
         [0.0, f, height / 2.0, 0.0],
         [0.0, 0.0, 1.0, 0.0]]
    )
    cam.extrinsic = np.asarray(
        [[0.0, -1.0, 0.0, 0.0],
         [0.0, 0.0, -1.0, 0.0],
         [1.0, 0.0, 0.0, 0.0],
         [0.0, 0.0, 0.0, 1.0]]
    )
    return cam


def paint_table(
    camera: CameraModel,
    spec: BevSpec = BevSpec(),
    device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(v, u, ok): for every cell of the flipped (nx, ny) BEV raster the
    camera row and column it takes its value from (int64) and whether it
    lands inside the image in front of the camera (bool), on `device`.

    Coordinate planes are fed through `rgb_onto_bev`, so the tables hold
    exactly the painter's projection, half-to-even rounding and flips."""
    hc, wc = camera.height, camera.width
    kw = dict(max_range=spec.max_range, res_x=spec.res_x, res_y=spec.res_y)
    vv = np.broadcast_to(np.arange(hc, dtype=np.float32)[:, None, None], (hc, wc, 1))
    uu = np.broadcast_to(np.arange(wc, dtype=np.float32)[None, :, None], (hc, wc, 1))
    one = np.ones((hc, wc, 1), np.float32)
    v = rgb_onto_bev(vv, camera, spec.nx, spec.ny, **kw)[..., 0].astype(np.int64)
    u = rgb_onto_bev(uu, camera, spec.nx, spec.ny, **kw)[..., 0].astype(np.int64)
    ok = rgb_onto_bev(one, camera, spec.nx, spec.ny, **kw)[..., 0] > 0
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device) for t in (v, u, ok))


def paint_bev(
    cam_img: torch.Tensor,  # (B, Hc, Wc, C)
    table: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Channel 0 of each camera frame painted onto the BEV grid through
    `table`: (B, nx, ny), 0 where a cell sees no pixel."""
    v, u, ok = table
    return torch.where(ok, cam_img[:, v, u, 0], 0.0)
