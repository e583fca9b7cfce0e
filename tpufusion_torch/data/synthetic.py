"""Synthetic scenes in numpy (counterpart of `tpufusion/data/synthetic.py`).

Two families, as in the reference:

* uniform clouds (`synthesize_points_batch`, `synthesize_multi_vehicle_batch`,
  `synthesize_tracking_sequence`, `synthesize_dataset`): a uniform clutter
  ring and one dense box-shaped cluster a vehicle, stamped into the last
  point slots. The cluster sits at Rz(yaw) @ center while gt "center"
  stays unrotated (the reference's orbit-origin corner convention).
* beam-structured Velodyne scans (`synthesize_beam_scan_batch`,
  `synthesize_beam_multi_vehicle_batch`, `synthesize_beam_tracking_sequence`,
  `_raycast_scene`): each (beam, azimuth) ray of a spinning sweep (32
  beams by default, 64 at 131,072 points) is cast against a ground plane,
  the vehicles and K vertical clutter objects; the nearest hit wins, so
  occlusion shadows and range-dependent density emerge from geometry. A
  vehicle's surface is a circle of radius 0.8 * half the footprint
  diagonal (rotationally symmetric: yaw unobservable), an ellipse with
  semi-axes 0.9 * (l/2, w/2) turned by its yaw, or the true l x w box
  (slab-method entry), each within the box's z extent. Rays with no
  return, or dropped by the range-dependent dropout model, are invalid
  and parked at the origin. `surface_fit_params` names the decode's fit
  for each scene family.

Same distributions as the reference generators, not the same bits: a
`numpy.random.Generator` replaces `jax.random`. The ellipse and box
surfaces compute in float32, as the reference does, so a ray's entry
point matches the reference's to float32 rounding.

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
_VEHICLE_SIZE = (4.2, 1.6, 1.5)
_SIZE_RANGE = ((3.5, 1.4, 1.2), (5.5, 2.1, 1.9))  # vary_size: l, w, h bounds
_SURFACES = ("circle", "ellipse", "box")


def _gt(center, size, yaw) -> dict[str, np.ndarray]:
    return {"center": np.asarray(center, np.float32), "size": np.asarray(size, np.float32),
            "yaw": np.asarray(yaw, np.float32)}


def _orbit_spot(center: np.ndarray, yaw: np.ndarray) -> np.ndarray:
    """Rz(yaw) @ center: where the orbit-origin convention puts the cluster."""
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack(
        [c * center[..., 0] - s * center[..., 1], s * center[..., 0] + c * center[..., 1],
         center[..., 2]],
        axis=-1,
    )


def _clutter_ring(rng: np.random.Generator, batch: int, n_points: int, max_range: float):
    """Uniform clutter: x, y, z, intensity, each (B, N)."""
    az = rng.uniform(-np.pi, np.pi, (batch, n_points))
    r = rng.uniform(2.0, max_range, (batch, n_points))
    z = rng.uniform(-1.9, 0.5, (batch, n_points))
    intensity = rng.uniform(0.0, 100.0, (batch, n_points))
    return r * np.cos(az), r * np.sin(az), z, intensity


def synthesize_points_batch(
    rng: np.random.Generator,
    batch: int,
    n_points: int = 16384,
    max_range: float = 60.0,
    max_yaw: float = 0.6,
    vary_size: bool = False,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Uniform clouds with one vehicle -> (points (B, N, 4) float32, gt
    {center (B, 3), size (B, 3), yaw (B,)}).

    The vehicle is a dense box cluster of N // 8 points (the last slots),
    8-30 m away at a uniform azimuth, at Rz(yaw) @ center. vary_size=True
    draws l, w, h from vehicle-like ranges instead of (4.2, 1.6, 1.5). The
    cluster is axis-aligned, so a large max_yaw makes the pose target
    unobservable (the reference explains why); detector scenes use ~0."""
    b, n = batch, n_points
    x, y, z, intensity = _clutter_ring(rng, b, n, max_range)
    dist = rng.uniform(8.0, 30.0, b)
    angle = rng.uniform(-np.pi, np.pi, b)
    center = np.stack([dist * np.cos(angle), dist * np.sin(angle), np.full(b, -0.7)], axis=-1)
    yaw = rng.uniform(-max_yaw, max_yaw, b)
    if vary_size:
        size = rng.uniform(*_SIZE_RANGE, (b, 3))
    else:
        size = np.broadcast_to(np.array(_VEHICLE_SIZE), (b, 3)).copy()
    m = n // 8
    offs = rng.uniform(-1.0, 1.0, (b, m, 3))
    vpts = _orbit_spot(center, yaw)[:, None, :] + offs * (size[:, None, :] / 2.0 * 0.95)
    x[:, -m:], y[:, -m:], z[:, -m:] = vpts[..., 0], vpts[..., 1], vpts[..., 2]
    points = np.stack([x, y, z, intensity], axis=-1).astype(np.float32)
    return points, _gt(center, size, yaw)


def _clutter_with_clusters(
    rng: np.random.Generator,
    batch: int,
    n_points: int,
    centers: np.ndarray,  # (B, V, 3) physical cluster centers
    sizes: np.ndarray,  # (B, V, 3)
    max_range: float,
) -> np.ndarray:
    """The uniform clutter ring plus one dense box cluster a (frame,
    vehicle), stamped into the last V * m point slots -> points (B, N, 4)."""
    b, n, v = batch, n_points, centers.shape[1]
    x, y, z, intensity = _clutter_ring(rng, b, n, max_range)
    m = (n // 8) // v  # points a vehicle cluster
    offs = rng.uniform(-1.0, 1.0, (b, v, m, 3))
    vflat = (centers[:, :, None, :] + offs * (sizes[:, :, None, :] / 2.0 * 0.95)).reshape(b, v * m, 3)
    x[:, -v * m:], y[:, -v * m:], z[:, -v * m:] = vflat[..., 0], vflat[..., 1], vflat[..., 2]
    return np.stack([x, y, z, intensity], axis=-1).astype(np.float32)


def synthesize_multi_vehicle_batch(
    rng: np.random.Generator,
    batch: int,
    n_points: int = 16384,
    n_vehicles: int = 2,
    max_range: float = 60.0,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Uniform clouds with V vehicles at azimuth slots >= 0.7 rad apart ->
    (points (B, N, 4), gt {center, size (B, V, 3), yaw (B, V) zeros})."""
    center = _slot_centers(rng, batch, n_vehicles)
    size = np.broadcast_to(np.array(_VEHICLE_SIZE), center.shape).copy()
    points = _clutter_with_clusters(rng, batch, n_points, center, size, max_range)
    return points, _gt(center, size, np.zeros(center.shape[:2]))


def _constant_velocity_paths(rng: np.random.Generator, frames: int, n_vehicles: int, dt: float):
    """(centers (F, V, 3), velocities (V, 3)): V vehicles from one slot
    layout on constant-velocity paths, speed up to 2 m/s on each planar
    axis."""
    c0 = _slot_centers(rng, 1, n_vehicles)[0]
    vel = rng.uniform(-2.0, 2.0, (n_vehicles, 3))
    vel[:, 2] = 0.0
    return c0[None] + vel[None] * (np.arange(frames)[:, None, None] * dt), vel


def synthesize_tracking_sequence(
    rng: np.random.Generator,
    frames: int,
    n_points: int = 16384,
    n_vehicles: int = 2,
    dt: float = 0.1,
    max_range: float = 60.0,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """A temporal sequence of uniform clouds: V vehicles on
    constant-velocity paths, the clutter drawn anew every frame ->
    (points (F, N, 4), gt {center, size (F, V, 3), yaw (F, V)})."""
    centers, _ = _constant_velocity_paths(rng, frames, n_vehicles, dt)
    size = np.broadcast_to(np.array(_VEHICLE_SIZE), centers.shape).copy()
    points = _clutter_with_clusters(rng, frames, n_points, centers, size, max_range)
    return points, _gt(centers, size, np.zeros(centers.shape[:2]))


def synthesize_dataset(seed: int, num_frames: int, n_points: int = 16384) -> dict[str, np.ndarray]:
    """Host arrays of a whole synthetic sequence of uniform clouds:
    points, center, size, yaw and 10 Hz nanosecond timestamps."""
    points, gt = synthesize_points_batch(np.random.default_rng(seed), num_frames, n_points)
    timestamp = np.arange(num_frames, dtype=np.int64) * 100_000_000 + 1_490_000_000_000_000_000
    return {"points": points, **gt, "timestamp": timestamp}


def surface_fit_params(scenes: str) -> tuple[str, float]:
    """(fit_boundary, fit_surface_scale) of the decode's "fit" for a
    scene family, matching `_raycast_scene`'s surface insets: ellipse
    semi-axes 0.9 * (l/2, w/2), circle radius 0.8 * half the diagonal.
    The box family renders the true l x w rectangle and is fitted with
    the head's l / w at scale 1.0; "mixed" (dual-codec assets) gates the
    boundary per cluster, with the oriented arm's scale."""
    if scenes == "mixed":
        return "auto", 0.9
    if scenes.endswith("ellipse"):
        return "ellipse", 0.9
    if scenes.endswith("box"):
        return "box", 1.0
    return "circle", 0.8



def _circle_entry(az, centers, sizes):
    """(hit (B, V, N), entry distance): the ray's chord entry into the
    circle of radius 0.8 * half the footprint diagonal (yaw unobservable)."""
    d_v = np.linalg.norm(centers[..., :2], axis=-1)  # (B, V)
    alpha_v = np.arctan2(centers[..., 1], centers[..., 0])
    dalpha = (az[:, None, :] - alpha_v[:, :, None] + np.pi) % (2 * np.pi) - np.pi
    r_eff = 0.5 * np.sqrt(sizes[..., 0] ** 2 + sizes[..., 1] ** 2) * 0.8
    cross = d_v[:, :, None] * np.sin(dalpha)
    under = r_eff[:, :, None] ** 2 - cross**2
    hit_az = under > 0.0
    return hit_az, d_v[:, :, None] * np.cos(dalpha) - np.sqrt(np.where(hit_az, under, 1.0))


def _oriented_frame(az, centers, sizes, yaws):
    """float32 (cos yaw, sin yaw, half length, half width, center x, y,
    ray direction x, y), broadcast to (B, V, N)."""
    f32 = np.float32
    centers, sizes, yaws = (np.asarray(a, f32) for a in (centers, sizes, yaws))
    ct, st = np.cos(yaws)[:, :, None], np.sin(yaws)[:, :, None]
    hl = np.maximum(sizes[..., 0] / f32(2.0), f32(1e-3))[:, :, None]
    hw = np.maximum(sizes[..., 1] / f32(2.0), f32(1e-3))[:, :, None]
    cx, cy = centers[..., 0][:, :, None], centers[..., 1][:, :, None]
    az = np.asarray(az, f32)
    dx, dy = np.cos(az)[:, None, :], np.sin(az)[:, None, :]
    return ct, st, hl, hw, cx, cy, dx, dy


def _ellipse_entry(az, centers, sizes, yaws):
    """The ray p(t) = t d enters the ellipse with semi-axes 0.9 * (l/2,
    w/2) turned by yaw: in the ellipse's frame, scaled to a unit circle,
    q(t) = q0 + t dq with q0 = -S R c and dq = S R d, and the entry is the
    smaller root of |q(t)|^2 = 1."""
    f32 = np.float32
    ct, st, hl, hw, cx, cy, dx, dy = _oriented_frame(az, centers, sizes, yaws)
    a, bax = hl * f32(0.9), hw * f32(0.9)
    q0x = (ct * -cx + st * -cy) / a
    q0y = (-st * -cx + ct * -cy) / bax
    dqx = (ct * dx + st * dy) / a
    dqy = (-st * dx + ct * dy) / bax
    qa = dqx**2 + dqy**2
    qb = q0x * dqx + q0y * dqy
    qc = q0x**2 + q0y**2 - f32(1.0)
    under = qb**2 - qa * qc
    hit_az = under > 0.0
    return hit_az, (-qb - np.sqrt(np.where(hit_az, under, f32(1.0)))) / qa


def _box_entry(az, centers, sizes, yaws):
    """Slab-method entry into the true l x w rectangle turned by yaw: in
    the box's frame q(t) = t d' - c' with d' = R(-yaw) d, c' = R(-yaw) c;
    the entry is t_near = the larger slab minimum, a hit iff t_near <=
    t_far and t_far > 0. A ray parallel to a slab (|d'| <= 1e-9 on that
    axis) is inside it for every t or for none."""
    f32 = np.float32
    big = f32(1e9)
    ct, st, hl, hw, cx, cy, dx, dy = _oriented_frame(az, centers, sizes, yaws)
    dqx = ct * dx + st * dy
    dqy = -st * dx + ct * dy
    q0x = -(ct * cx + st * cy)
    q0y = -(-st * cx + ct * cy)

    def slab(q0, dq, half):
        par = np.abs(dq) <= 1e-9
        safe = np.where(par, f32(1.0), dq)
        t1 = (-half - q0) / safe
        t2 = (half - q0) / safe
        inside = np.abs(q0) <= half
        tmin = np.where(par, np.where(inside, -big, big), np.minimum(t1, t2))
        tmax = np.where(par, np.where(inside, big, -big), np.maximum(t1, t2))
        return tmin, tmax

    tx1, tx2 = slab(q0x, dqx, hl)
    ty1, ty2 = slab(q0y, dqy, hw)
    t_near, t_far = np.maximum(tx1, ty1), np.minimum(tx2, ty2)
    return (t_near <= t_far) & (t_far > 0.0), t_near


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
    vehicle_surface: str = "circle",
    yaws: np.ndarray | None = None,  # (B, V) physical orientations (ellipse, box)
) -> tuple[np.ndarray, np.ndarray]:
    """Ray-cast (points (B, n_beams * n_azimuth, 4) float32, valid (B, N))."""
    if vehicle_surface not in _SURFACES:
        raise ValueError(f"unknown vehicle_surface {vehicle_surface!r}")
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

    # vehicles: the ray's entry distance into each vehicle's surface
    if vehicle_surface == "circle":
        hit_az, rho_vehicle = _circle_entry(az, centers, sizes)
    else:
        if yaws is None:
            yaws = np.zeros(centers.shape[:2], f32)
        entry = _ellipse_entry if vehicle_surface == "ellipse" else _box_entry
        hit_az, rho_vehicle = entry(az, centers, sizes, yaws)
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
    vary_size: bool = False,
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
    "center" stays unrotated (the orbit-origin convention), and its
    surface ("circle", "ellipse" or "box") is turned by yaw. vary_size
    draws l, w, h from vehicle-like ranges."""
    _check_beams(n_points, n_beams)
    b = batch
    dist = rng.uniform(8.0, 30.0, b)
    angle = rng.uniform(angle_range[0], angle_range[1], b)
    center = np.stack(
        [dist * np.cos(angle), dist * np.sin(angle), np.full(b, -0.7)], axis=-1
    )
    yaw = rng.uniform(-max_yaw, max_yaw, b)
    if vary_size:
        size = rng.uniform(*_SIZE_RANGE, (b, 3))
    else:
        size = np.broadcast_to(np.array(_VEHICLE_SIZE), (b, 3)).copy()
    points, valid = _raycast_scene(
        rng, b, n_beams, n_points // n_beams, _orbit_spot(center, yaw)[:, None, :],
        size[:, None, :], max_range, n_clutter, dropout,
        vehicle_surface=vehicle_surface, yaws=yaw[:, None],
    )
    return points, _gt(center, size, yaw), valid


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
    anew every frame -> (points (F, N, 4), gt (F, V, ...), valid (F, N)).

    oriented=True renders each vehicle as an ellipse heading along its
    velocity. The gt stays in the orbit convention: yaw is the constant
    heading and "center" is Rz(-yaw) of the physical path."""
    _check_beams(n_points, n_beams)
    f, v = frames, n_vehicles
    centers, vel = _constant_velocity_paths(rng, f, v, dt)
    size = np.broadcast_to(np.array(_VEHICLE_SIZE), centers.shape).copy()
    if not oriented:
        points, valid = _raycast_scene(
            rng, f, n_beams, n_points // n_beams, centers, size,
            max_range, n_clutter, dropout,
        )
        return points, _gt(centers, size, np.zeros((f, v))), valid
    psi = np.arctan2(vel[:, 1], vel[:, 0])  # (V,) physical headings
    yaws = np.broadcast_to(psi[None], (f, v))
    points, valid = _raycast_scene(
        rng, f, n_beams, n_points // n_beams, centers, size, max_range, n_clutter,
        dropout, vehicle_surface="ellipse", yaws=yaws,
    )
    return points, _gt(_orbit_spot(centers, -yaws), size, yaws), valid


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
