"""Top-K pose scoring: the port's copy of `score_multi_poses` and the
helpers it needs from the JAX package's numpy module
(`tpufusion/eval/scoring.py`): the orbit/physical frame conversions,
yaw-aware 3D box IoU (rotated-rectangle polygon clip in BEV x vertical
overlap) and per-pose errors. `tests/test_torch_imports.py` holds it
equal to the reference.

Pose frames. The decode and the synthetic ground truth carry centers in
the reference's orbit-origin convention: the box's physical center is
Rz(rz) @ (tx, ty, tz). Boxes overlap in the physical frame, so scoring
converts both sides with `orbit_to_physical` when told the inputs are
orbit-convention (pose_frame="orbit").
"""

from __future__ import annotations

import numpy as np


def orbit_to_physical(poses: np.ndarray) -> np.ndarray:
    """(..., 7) orbit-convention poses -> physical-frame poses.

    physical center = Rz(rz) @ (tx, ty, tz); rz / l / w / h unchanged.
    The all-zero no-detection sentinel maps to itself (Rz of the origin
    is the origin), so `found` masks derived from zero-checks survive.
    """
    p = np.asarray(poses, np.float64)
    out = p.copy()
    c, s = np.cos(p[..., 3]), np.sin(p[..., 3])
    out[..., 0] = c * p[..., 0] - s * p[..., 1]
    out[..., 1] = s * p[..., 0] + c * p[..., 1]
    return out


def physical_to_orbit(poses: np.ndarray) -> np.ndarray:
    """Inverse of `orbit_to_physical` (rotate the center by -rz)."""
    p = np.asarray(poses, np.float64)
    out = p.copy()
    c, s = np.cos(-p[..., 3]), np.sin(-p[..., 3])
    out[..., 0] = c * p[..., 0] - s * p[..., 1]
    out[..., 1] = s * p[..., 0] + c * p[..., 1]
    return out


def _rect_corners_bev(cx, cy, l, w, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    dx = np.asarray([l, l, -l, -l]) / 2.0
    dy = np.asarray([w, -w, -w, w]) / 2.0
    return np.stack([cx + c * dx - s * dy, cy + s * dx + c * dy], axis=-1)


def _polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(
        float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    )


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman against a convex clip polygon (ccw)."""
    out = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        edge = b - a
        inp, out = out, []
        if not inp:
            break

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= 0

        for j in range(len(inp)):
            p, q = inp[j], inp[(j + 1) % len(inp)]
            pin, qin = inside(p), inside(q)
            if pin:
                out.append(p)
            if pin != qin:
                d = q - p
                denom = edge[0] * d[1] - edge[1] * d[0]
                if abs(denom) > 1e-12:
                    # solve cross(edge, p + t d - a) = 0
                    t = -(edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0])) / denom
                    out.append(p + t * d)
    return np.asarray(out) if out else np.zeros((0, 2))


def _ccw(poly: np.ndarray) -> np.ndarray:
    x, y = poly[:, 0], poly[:, 1]
    signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return poly if signed > 0 else poly[::-1]


def box_iou_3d(pose_a, pose_b) -> float:
    """poses are (tx, ty, tz, rz, l, w, h)."""
    a = np.asarray(pose_a, np.float64)
    b = np.asarray(pose_b, np.float64)
    ra = _ccw(_rect_corners_bev(a[0], a[1], a[4], a[5], a[3]))
    rb = _ccw(_rect_corners_bev(b[0], b[1], b[4], b[5], b[3]))
    inter_poly = _clip_polygon(ra, rb)
    if len(inter_poly) < 3:
        return 0.0
    inter_bev = _polygon_area(inter_poly)
    za0, za1 = a[2] - a[6] / 2, a[2] + a[6] / 2
    zb0, zb1 = b[2] - b[6] / 2, b[2] + b[6] / 2
    dz = max(0.0, min(za1, zb1) - max(za0, zb0))
    inter = inter_bev * dz
    vol_a = a[4] * a[5] * a[6]
    vol_b = b[4] * b[5] * b[6]
    union = vol_a + vol_b - inter
    return float(inter / union) if union > 0 else 0.0


def pose_errors(pred, truth) -> dict[str, float]:
    p = np.asarray(pred, np.float64)
    t = np.asarray(truth, np.float64)
    dyaw = (p[3] - t[3]) % np.pi
    return {
        "trans_err": float(np.linalg.norm(p[:3] - t[:3])),
        "xy_err": float(np.linalg.norm(p[:2] - t[:2])),
        "yaw_err": float(min(dyaw, np.pi - dyaw)),
    }


def score_multi_poses(
    poses: np.ndarray,  # (F, K, 7) top-K decoded boxes per frame
    found: np.ndarray,  # (F, K) validity
    gt_centers: np.ndarray,  # (F, V, 3)
    gt_yaws: np.ndarray,  # (F, V)
    gt_sizes: np.ndarray,  # (F, V, 3)
    match_dist: float = 4.0,
    pose_frame: str = "physical",
) -> dict[str, float]:
    """Per-box accuracy of the multi-obstacle decode (config 5's top-K
    path), which `score_poses` (one box per frame) cannot measure.

    Greedy per-frame matching: each GT vehicle takes the nearest unused
    decoded box within match_dist (xy). Reports recall over all
    (frame, vehicle) pairs, mean 3D IoU / xy error over the matches, and
    decoded boxes that matched nothing (false positives).

    pose_frame="orbit": poses and (gt_centers, gt_yaws) are
    orbit-convention; both are rotated to the physical frame first so
    matching distances and IoU are geometric (see module docstring)."""
    poses = np.asarray(poses, np.float64)
    found = np.asarray(found, bool)
    gt_centers = np.asarray(gt_centers, np.float64)
    gt_yaws = np.asarray(gt_yaws, np.float64)
    if pose_frame == "orbit":
        poses = orbit_to_physical(poses)
        c, s = np.cos(gt_yaws), np.sin(gt_yaws)
        gt_centers = np.stack(
            [
                c * gt_centers[..., 0] - s * gt_centers[..., 1],
                s * gt_centers[..., 0] + c * gt_centers[..., 1],
                gt_centers[..., 2],
            ],
            axis=-1,
        )
    elif pose_frame != "physical":
        raise ValueError(f"unknown pose_frame {pose_frame!r}")
    f, v = gt_centers.shape[:2]
    matched, false_pos = 0, 0
    ious, xy_errs, yaw_errs = [], [], []
    for fr in range(f):
        cand = [k for k in range(poses.shape[1]) if found[fr, k]]
        used = set()
        for vi in range(v):
            c = gt_centers[fr, vi]
            avail = [k for k in cand if k not in used]
            if not avail:
                continue
            d = [np.linalg.norm(poses[fr, k, :2] - c[:2]) for k in avail]
            j = int(np.argmin(d))
            if d[j] > match_dist:
                continue
            k = avail[j]
            used.add(k)
            matched += 1
            truth = np.concatenate(
                [c, [gt_yaws[fr, vi]], gt_sizes[fr, vi]]
            )
            ious.append(box_iou_3d(poses[fr, k], truth))
            xy_errs.append(d[j])
            dy = abs((poses[fr, k, 3] - gt_yaws[fr, vi]) % np.pi)
            yaw_errs.append(min(dy, np.pi - dy))
        false_pos += len(cand) - len(used)
    return {
        "box_recall": round(matched / max(f * v, 1), 3),
        "box_mean_iou": round(float(np.mean(ious)) if ious else 0.0, 3),
        "box_xy_err": round(float(np.mean(xy_errs)) if xy_errs else float("nan"), 3),
        "box_yaw_err": round(
            float(np.mean(yaw_errs)) if yaw_errs else float("nan"), 3
        ),
        "false_positives": int(false_pos),
    }
