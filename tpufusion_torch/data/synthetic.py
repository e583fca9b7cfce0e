"""Beam-structured synthetic Velodyne scans in numpy (counterpart of
`tpufusion/data/synthetic.py::synthesize_beam_scan_batch`,
`synthesize_beam_multi_vehicle_batch`, `synthesize_beam_tracking_sequence`
and `_raycast_scene`, default `vehicle_surface="circle"`).

Each (beam, azimuth) ray of a spinning sweep (32 beams by default, 64 at
131,072 points) is cast against a ground plane, the vehicles (each a
rotationally symmetric rounded box: a circle of radius 0.8 * half the
footprint diagonal, within the box's z extent) and K vertical clutter
objects; the nearest hit wins, so occlusion shadows and range-dependent
density emerge from geometry. Rays with no return, or dropped by the
range-dependent dropout model, are invalid and parked at the origin.
Same distribution as the reference generators, not the same bits: a
`numpy.random.Generator` replaces `jax.random`. The ellipse and box
surfaces, and with them the oriented tracking sequence, wait (ROADMAP
Queue 1: tools).

`render_camera_frames` and `build_fusion_dataset` (counterparts of
`tpufusion/tools/train_fusion_synthetic.py::render_camera_frames` and
`build_dataset`) make aligned camera + lidar + radar inputs for the
fusion net: the vehicle spawns inside the camera's field of view, a
synthetic pinhole renders it as a bright box on smooth noise at the
reference's 512 x 1368 crop, the radar reports the cluster's noisy
(range, angle), and three offset timestamp streams are joined by
`data.align`.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufusion_torch.config import CameraConfig, RangeViewSpec
from tpufusion_torch.data.fusion import build_fusion_batches
from tpufusion_torch.geometry.boxes import _CORNER_SIGNS
from tpufusion_torch.geometry.camera import CameraModel, synthetic_camera
from tpufusion_torch.geometry.range_view import range_view_project_batch

# the reference's full camera geometry (512 x 1368 crop of a 1024-row image)
FUSION_CAMERA = CameraConfig(width=1368, height=512, crop_top=0)
FUSION_FOV = (-0.42, 0.42)  # the camera's field-of-view wedge (~24 deg half)


def _raycast_scene(
    rng: np.random.Generator,
    batch: int,
    n_beams: int,
    n_azimuth: int,
    centers: np.ndarray,  # (B, V, 3) physical cluster centers
    sizes: np.ndarray,  # (B, V, 3)
    max_range: float,
    n_clutter: int,
    dropout: float,
    sensor_z: float = 0.0,
    ground_z: float = -1.9,
    vfov_lo_deg: float = -30.67,
    vfov_hi_deg: float = 10.67,
) -> tuple[np.ndarray, np.ndarray]:
    """Ray-cast (points (B, n_beams * n_azimuth, 4) float32, valid (B, N))."""
    b, n = batch, n_beams * n_azimuth
    f32 = np.float32
    elev = np.deg2rad(
        np.linspace(vfov_lo_deg + 0.665, vfov_hi_deg - 0.665, n_beams)
    ).astype(f32)
    phase = rng.uniform(0.0, 2 * np.pi, (b, 1)).astype(f32)
    az = (
        np.arange(n_azimuth, dtype=f32)[None, :] * f32(2 * np.pi / n_azimuth)
        + phase
        + f32(np.pi)
    ) % f32(2 * np.pi) - f32(np.pi)  # (B, A) in [-pi, pi)
    az = np.broadcast_to(az[:, None, :], (b, n_beams, n_azimuth)).reshape(b, n)
    phi = np.broadcast_to(elev[None, :, None], (b, n_beams, n_azimuth)).reshape(b, n)
    tan_phi = np.tan(phi)
    big = f32(1e9)

    # ground plane, with gentle height noise
    g_noise = rng.standard_normal((b, n)).astype(f32) * f32(0.02)
    with np.errstate(divide="ignore"):
        rho_ground = np.where(
            tan_phi < -1e-4, (ground_z + g_noise - sensor_z) / tan_phi, big
        )

    # vehicles: the ray's chord entry into the circle of radius r_eff
    d_v = np.linalg.norm(centers[..., :2], axis=-1)  # (B, V)
    alpha_v = np.arctan2(centers[..., 1], centers[..., 0])
    dalpha = (az[:, None, :] - alpha_v[:, :, None] + np.pi) % (2 * np.pi) - np.pi
    r_eff = 0.5 * np.sqrt(sizes[..., 0] ** 2 + sizes[..., 1] ** 2) * 0.8
    cross = d_v[:, :, None] * np.sin(dalpha)
    under = r_eff[:, :, None] ** 2 - cross**2
    hit_az = under > 0.0
    rho_vehicle = d_v[:, :, None] * np.cos(dalpha) - np.sqrt(
        np.where(hit_az, under, 1.0)
    )
    z_at = sensor_z + rho_vehicle * tan_phi[:, None, :]
    zb = centers[..., 2] - sizes[..., 2] / 2.0
    zt = centers[..., 2] + sizes[..., 2] / 2.0
    hit_veh = (
        hit_az
        & (rho_vehicle > 0.5)
        & (z_at >= zb[:, :, None])
        & (z_at <= zt[:, :, None])
    )
    surf_noise = rng.standard_normal(rho_vehicle.shape) * 0.03
    rho_vehicle = np.where(hit_veh, rho_vehicle + surf_noise, big).min(axis=1)

    # vertical clutter: azimuth interval, distance and top height each
    c_az = rng.uniform(-np.pi, np.pi, (b, n_clutter))
    c_hw = rng.uniform(0.003, 0.035, (b, n_clutter))
    c_d = rng.uniform(3.0, max_range, (b, n_clutter))
    c_top = rng.uniform(-1.0, 2.5, (b, n_clutter))
    rho_clutter = np.full((b, n), big)
    for j in range(n_clutter):  # one object at a time: (B, N) temporaries
        dca = (az - c_az[:, j : j + 1] + np.pi) % (2 * np.pi) - np.pi
        z_c = sensor_z + c_d[:, j : j + 1] * tan_phi
        hit_c = (
            (np.abs(dca) <= c_hw[:, j : j + 1])
            & (z_c >= ground_z)
            & (z_c <= c_top[:, j : j + 1])
        )
        rho_clutter = np.minimum(
            rho_clutter, np.where(hit_c, c_d[:, j : j + 1], big)
        )

    # nearest hit wins; range-dependent dropout
    rho = np.minimum(np.minimum(rho_ground, rho_vehicle), rho_clutter)
    hit = rho < min(max_range, big * 0.5)
    p_drop = dropout * (0.35 + 0.65 * np.clip(rho / max_range, 0.0, 1.0))
    valid = hit & (rng.uniform(size=(b, n)) >= p_drop)

    x = rho * np.cos(az)
    y = rho * np.sin(az)
    z = sensor_z + rho * tan_phi
    base_i = rng.uniform(3.0, 25.0, (b, n))
    veh_i = rng.uniform(30.0, 95.0, (b, n))
    clut_i = rng.uniform(5.0, 70.0, (b, n))
    is_veh = rho_vehicle <= rho
    is_clut = (rho_clutter <= rho) & ~is_veh
    intensity = np.where(is_veh, veh_i, np.where(is_clut, clut_i, base_i))
    points = np.stack([x, y, z, intensity], axis=-1).astype(np.float32)
    points[~valid] = 0.0  # invalid rays: parked at the origin, zero intensity
    return points, valid


def _check_beams(n_points: int, n_beams: int) -> None:
    if n_points % n_beams:
        raise ValueError(f"n_points {n_points} must be a multiple of n_beams {n_beams}")


def _slot_centers(rng: np.random.Generator, batch: int, n_vehicles: int) -> np.ndarray:
    """(B, V, 3) vehicle centers at evenly spaced azimuth slots, turned
    per frame, +-0.3 rad jitter, 8-30 m away: clusters stay disjoint in
    azimuth (the reference's synthesize_multi_vehicle_batch layout)."""
    if not 1 <= n_vehicles <= 5:
        raise ValueError(
            f"the slot layout keeps clusters disjoint only for 1-5 vehicles, got {n_vehicles}"
        )
    b, v = batch, n_vehicles
    base = np.linspace(0.0, 2.0 * np.pi, v, endpoint=False)
    frame_rot = rng.uniform(-np.pi, np.pi, (b, 1))
    jitter = rng.uniform(-0.3, 0.3, (b, v))
    angle = base[None, :] + frame_rot + jitter
    dist = rng.uniform(8.0, 30.0, (b, v))
    return np.stack(
        [dist * np.cos(angle), dist * np.sin(angle), np.full((b, v), -0.7)], axis=-1
    )


def synthesize_beam_scan_batch(
    rng: np.random.Generator,
    batch: int,
    n_points: int = 32768,
    n_beams: int = 32,
    max_range: float = 60.0,
    max_yaw: float = 0.05,
    n_clutter: int = 24,
    dropout: float = 0.12,
    angle_range: tuple[float, float] = (-np.pi, np.pi),
    vehicle_surface: str = "circle",
) -> tuple[np.ndarray, dict[str, np.ndarray], np.ndarray]:
    """Beam-structured single-vehicle scenes -> (points (B, N, 4) float32,
    gt {center (B, 3), size (B, 3), yaw (B,)}, valid (B, N) bool).

    The vehicle sits 8-30 m away at a uniform azimuth within angle_range
    (e.g. a camera's field of view, for fusion inputs); as in the
    reference, the physical cluster is at Rz(yaw) @ center while gt
    "center" stays unrotated (the orbit-origin convention)."""
    if vehicle_surface != "circle":
        raise NotImplementedError(
            f"vehicle_surface={vehicle_surface!r} is not ported yet "
            "(ROADMAP Queue 1: tools); use 'circle'"
        )
    _check_beams(n_points, n_beams)
    b = batch
    dist = rng.uniform(8.0, 30.0, b)
    angle = rng.uniform(angle_range[0], angle_range[1], b)
    center = np.stack(
        [dist * np.cos(angle), dist * np.sin(angle), np.full(b, -0.7)], axis=-1
    )
    yaw = rng.uniform(-max_yaw, max_yaw, b)
    size = np.broadcast_to(np.array([4.2, 1.6, 1.5]), (b, 3)).copy()
    c, s = np.cos(yaw), np.sin(yaw)
    spot = np.stack(
        [c * center[:, 0] - s * center[:, 1], s * center[:, 0] + c * center[:, 1],
         center[:, 2]],
        axis=-1,
    )
    points, valid = _raycast_scene(
        rng, b, n_beams, n_points // n_beams, spot[:, None, :], size[:, None, :],
        max_range, n_clutter, dropout,
    )
    gt = {
        "center": center.astype(np.float32),
        "size": size.astype(np.float32),
        "yaw": yaw.astype(np.float32),
    }
    return points, gt, valid


def synthesize_beam_multi_vehicle_batch(
    rng: np.random.Generator,
    batch: int,
    n_points: int = 32768,
    n_vehicles: int = 2,
    n_beams: int = 32,
    max_range: float = 60.0,
    n_clutter: int = 24,
    dropout: float = 0.12,
) -> tuple[np.ndarray, dict[str, np.ndarray], np.ndarray]:
    """Beam-structured multi-vehicle scenes -> (points (B, N, 4), gt
    {center, size (B, V, 3), yaw (B, V)}, valid (B, N))."""
    _check_beams(n_points, n_beams)
    center = _slot_centers(rng, batch, n_vehicles)
    size = np.broadcast_to(np.array([4.2, 1.6, 1.5]), center.shape).copy()
    points, valid = _raycast_scene(
        rng, batch, n_beams, n_points // n_beams, center, size,
        max_range, n_clutter, dropout,
    )
    gt = {
        "center": center.astype(np.float32),
        "size": size.astype(np.float32),
        "yaw": np.zeros(center.shape[:2], np.float32),
    }
    return points, gt, valid


def synthesize_beam_tracking_sequence(
    rng: np.random.Generator,
    frames: int,
    n_points: int = 32768,
    n_vehicles: int = 2,
    n_beams: int = 32,
    dt: float = 0.1,
    max_range: float = 60.0,
    n_clutter: int = 24,
    dropout: float = 0.12,
    oriented: bool = False,
) -> tuple[np.ndarray, dict[str, np.ndarray], np.ndarray]:
    """A temporal sequence: V vehicles on constant-velocity paths (per-axis
    speed up to 2 m/s) from one slot layout, clutter and sweep phase drawn
    anew every frame -> (points (F, N, 4), gt (F, V, ...), valid (F, N))."""
    if oriented:
        raise NotImplementedError(
            "oriented=True (ellipse surface) is not ported yet "
            "(ROADMAP Queue 1: tools)"
        )
    _check_beams(n_points, n_beams)
    f, v = frames, n_vehicles
    c0 = _slot_centers(rng, 1, v)[0]
    vel = rng.uniform(-2.0, 2.0, (v, 3))
    vel[:, 2] = 0.0
    centers = c0[None] + vel[None] * (np.arange(f)[:, None, None] * dt)
    size = np.broadcast_to(np.array([4.2, 1.6, 1.5]), centers.shape).copy()
    points, valid = _raycast_scene(
        rng, f, n_beams, n_points // n_beams, centers, size,
        max_range, n_clutter, dropout,
    )
    gt = {
        "center": centers.astype(np.float32),
        "size": size.astype(np.float32),
        "yaw": np.zeros((f, v), np.float32),
    }
    return points, gt, valid


def render_camera_frames(
    centers_phys: np.ndarray,  # (F, 3) physical cluster centers
    sizes: np.ndarray,  # (F, 3)
    cam: CameraModel,
    rng: np.random.Generator,
) -> np.ndarray:
    """(F, Hc, Wc, 1) grayscale frames: smooth noise background + a bright
    vehicle box whose position and scale encode direction and distance
    (the signal a real camera contributes to late fusion)."""
    f = len(centers_phys)
    hc, wc = FUSION_CAMERA.height, FUSION_CAMERA.width
    out = np.empty((f, hc, wc, 1), np.float32)
    vcrop = (cam.height - hc) // 2  # center crop rows like the reference's 430:942
    for i in range(f):
        img = rng.uniform(0.05, 0.25, (hc, wc)).astype(np.float32)
        # cheap smoothing: two half-resolution averages
        img = 0.5 * img + 0.5 * img[::-1, ::-1]
        c, s = centers_phys[i], sizes[i]
        corners = c + _CORNER_SIGNS * s / 2.0
        uv = cam.project_lidar_to_pixels(corners)
        if np.all(corners @ [1, 0, 0] > 0.5):  # in front of the camera
            u0, v0 = uv.min(axis=0)
            u1, v1 = uv.max(axis=0)
            v0, v1 = v0 - vcrop, v1 - vcrop
            u0, u1 = np.clip([u0, u1], 0, wc - 1).astype(int)
            v0, v1 = np.clip([v0, v1], 0, hc - 1).astype(int)
            if u1 > u0 and v1 > v0:
                shade = rng.uniform(0.7, 1.0)
                img[v0:v1, u0:u1] = shade
                # windows: darker band in the upper third
                vb = v0 + max(1, (v1 - v0) // 4)
                img[v0:vb, u0:u1] = shade * 0.5
        out[i, :, :, 0] = img
    return out


def build_fusion_dataset(
    n_frames: int,
    seed: int,
    spec: RangeViewSpec = RangeViewSpec(),
    n_points: int = 32768,
    device: torch.device | str = "cuda",
) -> dict[str, np.ndarray]:
    """Aligned {cam (F, 512, 1368, 1), lidar (F, H, W, 3), radar (F, 2),
    centroid (F, 3), rz (F, 1)} numpy arrays for n_frames scenes, plus the
    raw "points" (F, N, 4) and "valid" (F, N) the lidar images came from.
    The range view is projected on `device` (the card unless the caller
    asks for "cpu")."""
    cam = synthetic_camera(FUSION_CAMERA.width, 1024, 1400.0)
    rng = np.random.default_rng(seed)
    pts, gt, valid = synthesize_beam_scan_batch(
        rng, n_frames, n_points, angle_range=FUSION_FOV
    )
    with torch.inference_mode():
        imgs = range_view_project_batch(
            torch.from_numpy(pts).to(device), spec, torch.from_numpy(valid).to(device)
        ).cpu().numpy()
    center, yaw, size = gt["center"], gt["yaw"], gt["size"]
    cy, sy = np.cos(yaw), np.sin(yaw)
    phys = np.stack(
        [cy * center[:, 0] - sy * center[:, 1], sy * center[:, 0] + cy * center[:, 1],
         center[:, 2]],
        axis=-1,
    )
    cam_frames = render_camera_frames(phys, size, cam, rng)

    # radar: sensor-noised polar observation of the physical cluster
    rr = np.linalg.norm(phys[:, :2], axis=1) + rng.normal(0, 0.25, n_frames)
    ra = np.arctan2(phys[:, 1], phys[:, 0]) + rng.normal(0, 0.008, n_frames)
    radar = np.stack([rr, ra], axis=-1).astype(np.float32)

    # deliberately offset timestamp streams through the aligner (scenes
    # are independent, so every stream runs at the frame rate; the
    # offsets still exercise the nearest-timestamp joins)
    t0 = 1_490_000_000_000
    lidar_ts = t0 + np.arange(n_frames) * 100_000  # 10 Hz (us)
    cam_ts = lidar_ts + 7_000
    radar_ts = lidar_ts + 3_000
    poses = np.concatenate([center, yaw[:, None]], axis=1).astype(np.float32)
    data = build_fusion_batches(cam_frames, cam_ts, poses, imgs, lidar_ts, radar, radar_ts)
    data.update(points=pts, valid=valid, timestamps=cam_ts)
    return data
