"""Direct-pose decode: heat -> clusters -> largest cluster -> pose
(counterpart of the direct path of `tpufusion/decode/decode.py`).

The reference decodes one frame and vmaps it; here every function takes
the batch as its first dimension. Stages, as in the reference:

  _heat_components   threshold >= min_prob, 4x4 heat stamp (positives at
                     row < 2 or col < 2 stamp nothing), heat > min_heat,
                     4-connected components with bbox extents (the CC
                     kernel on CUDA tensors, the plain sweeps on the CPU)
  _topk_roots        the largest-area cluster root (k = 1; ties to the
                     smallest root, as lax.top_k's stable order)
  _direct_pose_from_cluster   prob-weighted lwh and yaw (global or local
                     frame) over the cluster, plus the surface-point mean
  back_project_2d_to_3d       bbox-center pixel (nearest valid fallback)
                     -> 3D point
  decode_batch_direct         center estimators backproject, geometric,
                     consensus and fit (circle, ellipse or box boundary)

Not ported yet (ROADMAP Queue 1): the surface/head/silhouette centers,
direct_yaw_frame="auto", fit_boundary="auto", k > 1 and the corner decode.

Every float32 sqrt goes through `sqrt_f32` (exact ties in the fallback
argmin must stay ties; see geometry/range_view.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from tpufusion.config import DecodeConfig, RangeViewSpec
from tpufusion_torch.geometry.encoding import pixel_angles, pixel_points
from tpufusion_torch.geometry.range_view import sqrt_f32
from tpufusion_torch.ops.cc import connected_components_with_bbox

_SENTINEL = 1e8  # reference uses 10e7 for "no valid pixel"

_CENTERS = ("backproject", "geometric", "consensus", "fit")
_CENTERS_NOT_PORTED = ("surface", "head", "silhouette")

# "fit" center-mode constants (decode.py:709-713)
_FIT_PHI_CANDIDATES = 36
_FIT_GN_ITERS = 4
_FIT_PRIOR = 0.08
_FIT_ACCEPT_DIST = 2.0
_FIT_MIN_POINTS = 5


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1: the rest of the decode)"
    )


def _floor_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """jnp.remainder: exact fmod, shifted by y where the signs differ.
    (torch.remainder divides and floors, which rounds differently: at
    3*pi mod 2*pi it lands on the other side of a tie the fit breaks.)"""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def heat_mask(prob: torch.Tensor, cfg: DecodeConfig) -> torch.Tensor:
    """(B, H, W) probabilities -> (B, H, W) bool mask the clusters are
    labelled on: positives stamp a 4x4 heat count, kept above min_heat."""
    _, h, w = prob.shape
    dev = prob.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    stamp = (prob >= cfg.min_prob) & (rows >= 2) & (cols >= 2)
    # heat[r, c] = #stamping positives in rows [r-1, r+2] x cols [c-1, c+2]
    # (an exact integer count: a box sum over the padded stamp)
    padded = F.pad(stamp.to(torch.float32)[:, None], (1, 2, 1, 2))
    heat = F.avg_pool2d(padded, 4, stride=1, divisor_override=1)[:, 0]
    heat = torch.where(heat <= cfg.min_heat, 0.0, heat)
    return (heat > 0).contiguous()


def _heat_components(prob: torch.Tensor, cfg: DecodeConfig):
    """(B, H, W) probabilities -> (mask, labels, min_x, max_x, min_y,
    max_y), each (B, H, W)."""
    mask = heat_mask(prob, cfg)
    labels, min_x, max_x, min_y, max_y = connected_components_with_bbox(
        mask, cfg.max_cc_iters, cfg.cc_impl
    )
    return mask, labels, min_x, max_x, min_y, max_y


def _topk_roots(mask, labels, min_x, max_x, min_y, max_y, cfg, k: int = 1):
    """Largest-area cluster root per frame. Returns (root_idx (B,) flat,
    found (B,), bboxes (B, 4) [l, t, r, b] shrunk by 2, centroids (B, 2)
    [x, y], areas (B,)). Integer math is int64 so the background's
    sentinel extents (never selected when found) cannot overflow."""
    if k != 1:
        raise _not_ported(f"k={k} (multi-obstacle decode)")
    _, h, w = mask.shape
    flat_ids = torch.arange(h * w, device=mask.device, dtype=torch.int32)
    is_root = mask & (labels == flat_ids.view(h, w))
    area = (max_x.long() - min_x.long()) * (max_y.long() - min_y.long())
    score = torch.where(is_root, area, -1).flatten(1)
    idx = score.argmax(dim=1)  # the first maximum, as lax.top_k for k = 1

    def at(t):
        return t.flatten(1).gather(1, idx[:, None])[:, 0].long()

    areas = at(score)
    found = areas > cfg.min_bbox_area
    bboxes = torch.stack(
        [at(min_x) + 2, at(min_y) + 2, at(max_x) - 2, at(max_y) - 2], dim=-1
    )
    centroids = torch.stack(
        [
            ((bboxes[:, 0] + bboxes[:, 2]).to(torch.float32) / 2.0).long(),
            ((bboxes[:, 1] + bboxes[:, 3]).to(torch.float32) / 2.0).long(),
        ],
        dim=-1,
    )
    return idx, found, bboxes, centroids, areas


def back_project_2d_to_3d(
    centroid: torch.Tensor,  # (B, 2) [x, y]
    bbox: torch.Tensor,  # (B, 4) [l, t, r, b]
    dist_img: torch.Tensor,  # (B, H, W)
    height_img: torch.Tensor,  # (B, H, W)
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
):
    """Returns (xyz (B, 3), centroid' (B, 2), ok (B,))."""
    b, h, w = dist_img.shape
    dev = dist_img.device
    bi = torch.arange(b, device=dev)
    valid = (dist_img > 0) & (height_img > spec.min_height)
    cx, cy = centroid[:, 0], centroid[:, 1]
    # JAX clamps out-of-range gather indices; only a frame without a
    # cluster (masked downstream) carries such a centroid
    centroid_ok = valid[bi, cy.clamp(0, h - 1), cx.clamp(0, w - 1)]

    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]

    def lane(t):
        return t[:, None, None]

    in_window = (
        (rows >= lane(bbox[:, 1]))
        & (rows <= lane(bbox[:, 3]))
        & (cols >= lane(bbox[:, 0]))
        & (cols <= lane(bbox[:, 2]))
    )
    dx = (cols - lane(cx)).to(torch.float32)
    dy = (rows - lane(cy)).to(torch.float32)
    d2c = sqrt_f32(dx * dx + dy * dy)
    d2c = torch.where(valid & in_window, d2c, _SENTINEL).flatten(1)
    flat_arg = d2c.argmin(dim=1)  # first minimum in raster order
    fb_y, fb_x = flat_arg // w, flat_arg % w
    fb_ok = d2c.gather(1, flat_arg[:, None])[:, 0] < _SENTINEL

    use_fallback = (~centroid_ok) & (bbox[:, 0] != 0) & (bbox[:, 2] != 0)
    zero = torch.zeros_like(cx)
    new_cx = torch.where(use_fallback, torch.where(fb_ok, fb_x, zero), cx)
    new_cy = torch.where(use_fallback, torch.where(fb_ok, fb_y, zero), cy)

    nonzero = ~((new_cx == 0) & (new_cy == 0))
    iy, ix = new_cy.clamp(0, h - 1), new_cx.clamp(0, w - 1)
    d = dist_img[bi, iy, ix] + cfg.range_offset
    theta = (new_cx.to(torch.float32) + spec.x_min) * spec.res_h_rad
    xyz = torch.stack(
        [d * torch.cos(theta), -d * torch.sin(theta), height_img[bi, iy, ix]],
        dim=-1,
    )
    xyz = torch.where(nonzero[:, None], xyz, 0.0)
    return xyz, torch.stack([new_cx, new_cy], dim=-1), nonzero


def _direct_pose_from_cluster(y_pred, image, cluster, spec, cfg):
    """Weighted yaw and lwh over the cluster's valid pixels (with_center=
    False in the reference). Returns (yaw (B,), lwh (B, 3), ok (B,),
    p_mean (B, 3)); yaw and lwh are 0 where ok is False."""
    prob = y_pred[..., 1]
    valid = (image[..., 0] > 0) & (image[..., 1] > spec.min_height)
    m = cluster & valid & (prob >= cfg.min_prob)
    wgt = torch.where(m, prob, 0.0)
    tot = wgt.sum(dim=(1, 2)).clamp(min=1e-6)

    def wmean(ch):
        return (ch * wgt).sum(dim=(1, 2)) / tot

    lwh = (y_pred[..., 5:8] * wgt[..., None]).sum(dim=(1, 2)) / tot[:, None]
    dual = y_pred.shape[-1] >= 12
    if cfg.direct_yaw_frame == "local":
        # sin/cos(yaw + theta_pixel): rotate each pixel's vector back first
        theta, _ = pixel_angles(spec, y_pred.device)
        st, ct = torch.sin(theta), torch.cos(theta)
        s_px, c_px = y_pred[..., 8], y_pred[..., 9]
        sin_m = wmean(s_px * ct - c_px * st)
        cos_m = wmean(c_px * ct + s_px * st)
    elif cfg.direct_yaw_frame == "global":
        gi = 10 if dual else 8
        sin_m, cos_m = wmean(y_pred[..., gi]), wmean(y_pred[..., gi + 1])
    elif cfg.direct_yaw_frame == "auto":
        raise _not_ported("direct_yaw_frame='auto'")
    else:
        raise ValueError(f"unknown direct_yaw_frame {cfg.direct_yaw_frame!r}")
    yaw = torch.atan2(sin_m, cos_m)

    # prob-weighted mean of the cluster's surface points within a vehicle
    # depth of its closest return
    p = pixel_points(image, spec)
    d = image[..., 0]
    dmin = torch.where(m, d, math.inf).amin(dim=(1, 2))
    msurf = m & (d <= dmin[:, None, None] + 4.0)
    wsurf = torch.where(msurf, prob, 0.0)
    p_mean = (p * wsurf[..., None]).sum(dim=(1, 2)) / wsurf.sum(
        dim=(1, 2)
    ).clamp(min=1e-6)[:, None]
    ok = m.flatten(1).any(dim=1)
    yaw = torch.where(ok, yaw, 0.0)
    lwh = torch.where(ok[:, None], lwh, 0.0)
    return yaw, lwh, ok, p_mean


def _fit_pose_to_surface(image, cluster, spec, cfg, yaw, lwh, seed):
    """Gauss-Newton fit of the box's known-size boundary to the cluster's
    raw surface points (reference `_fit_pose_to_surface`, which documents
    the model). Candidates: the head yaw alone for a circle, a 36-step
    grid over [0, pi) plus the head yaw for an ellipse or box. Returns
    (center (B, 3), phi (B,), ok_fit (B,))."""
    b = image.shape[0]
    dev = image.device
    l_, w_ = lwh[:, 0], lwh[:, 1]
    head_phi = _floor_mod(yaw, math.pi)[:, None]
    if cfg.fit_boundary == "circle":
        a = cfg.fit_surface_scale * 0.5 * sqrt_f32(l_ * l_ + w_ * w_)
        a = bb = a.clamp(min=1e-2)
        phis = head_phi
    elif cfg.fit_boundary in ("ellipse", "box"):
        a = (cfg.fit_surface_scale * l_ / 2.0).clamp(min=1e-2)
        bb = (cfg.fit_surface_scale * w_ / 2.0).clamp(min=1e-2)
        grid = (
            torch.arange(_FIT_PHI_CANDIDATES, dtype=torch.float32, device=dev)
            / _FIT_PHI_CANDIDATES
            * math.pi
        )
        phis = torch.cat([grid[None].expand(b, -1), head_phi], dim=1)
    elif cfg.fit_boundary == "auto":
        raise _not_ported("fit_boundary='auto'")
    else:
        raise ValueError(f"unknown fit_boundary {cfg.fit_boundary!r}")
    a3, b3 = a[:, None, None], bb[:, None, None]

    valid = (image[..., 0] > 0) & (image[..., 1] > spec.min_height)
    m = cluster & valid
    p = pixel_points(image, spec)
    d = image[..., 0]
    dmin = torch.where(m, d, math.inf).amin(dim=(1, 2))
    gate = 0.5 * sqrt_f32(l_ * l_ + w_ * w_) + 3.0
    dp = p - seed[:, None, None, :]
    dist2 = dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1] + dp[..., 2] * dp[..., 2]
    near = dist2 <= (gate * gate)[:, None, None]
    msurf = m & (d <= dmin[:, None, None] + 4.0) & near
    px = p[..., 0].flatten(1)[:, None, :]  # (B, 1, P)
    py = p[..., 1].flatten(1)[:, None, :]
    wts = msurf.flatten(1).to(torch.float32)[:, None, :]
    nw = wts.sum(dim=2).clamp(min=1e-6)  # (B, 1)
    lam = _FIT_PRIOR * nw
    seed_xy = seed[:, :2]

    def residual(mx, my, phi):
        """Residual per point and its box-frame gradient; mx, my, phi are
        (B, C)."""
        c, s = torch.cos(phi)[..., None], torch.sin(phi)[..., None]
        dx = px - mx[..., None]
        dy = py - my[..., None]
        u = c * dx + s * dy
        v = -s * dx + c * dy
        if cfg.fit_boundary == "box":
            su = torch.abs(u) / a3
            sv = torch.abs(v) / b3
            r = torch.maximum(su, sv) - 1.0
            act_u = su >= sv
            gu = torch.where(act_u, torch.sign(u) / a3, 0.0)
            gv = torch.where(act_u, 0.0, torch.sign(v) / b3)
        else:
            vx = u / a3
            vy = v / b3
            r = vx * vx + vy * vy - 1.0
            gu = 2.0 * vx / a3
            gv = 2.0 * vy / b3
        return r, gu, gv, c, s

    mx = seed_xy[:, 0:1].expand_as(phis)
    my = seed_xy[:, 1:2].expand_as(phis)
    for _ in range(_FIT_GN_ITERS):
        r, gx, gy, c, s = residual(mx, my, phis)
        jx = -(c * gx - s * gy)
        jy = -(s * gx + c * gy)
        jxx = (wts * jx * jx).sum(dim=2) + lam
        jxy = (wts * jx * jy).sum(dim=2)
        jyy = (wts * jy * jy).sum(dim=2) + lam
        bx = (wts * jx * r).sum(dim=2) + lam * (mx - seed_xy[:, 0:1])
        by = (wts * jy * r).sum(dim=2) + lam * (my - seed_xy[:, 1:2])
        det = jxx * jyy - jxy * jxy
        mx, my = mx - (jyy * bx - jxy * by) / det, my - (jxx * by - jxy * bx) / det
    r, *_ = residual(mx, my, phis)
    ress = (wts * r * r).sum(dim=2) / nw  # (B, C)

    i = ress.argmin(dim=1, keepdim=True)  # first minimum
    decisive = ress.gather(1, i)[:, 0] < 0.9 * ress[:, -1]
    ctr = torch.where(
        decisive[:, None],
        torch.stack([mx.gather(1, i)[:, 0], my.gather(1, i)[:, 0]], dim=-1),
        torch.stack([mx[:, -1], my[:, -1]], dim=-1),
    )
    phi = torch.where(decisive, phis.gather(1, i)[:, 0], phis[:, -1])
    # resolve the boundary's pi-symmetry with the head yaw
    cand = torch.stack([phi, phi + math.pi, phi - math.pi], dim=-1)
    off = torch.abs(
        _floor_mod((cand - yaw[:, None]) + math.pi, 2 * math.pi) - math.pi
    )
    phi = cand.gather(1, off.argmin(dim=1, keepdim=True))[:, 0]
    dc = ctr - seed_xy
    ok_fit = (wts.sum(dim=(1, 2)) >= _FIT_MIN_POINTS) & (
        dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1] <= _FIT_ACCEPT_DIST**2
    )
    center = torch.cat([ctr, seed[:, 2:]], dim=-1)
    return (
        torch.where(ok_fit[:, None], center, seed),
        torch.where(ok_fit, phi, yaw),
        ok_fit,
    )


def decode_batch_direct(
    y_pred: torch.Tensor,  # (B, H, W, 2 + 8)
    images: torch.Tensor,  # (B, H, W, >=2)
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
    k: int = 1,
    center: str | None = None,
) -> dict[str, torch.Tensor]:
    """Direct-head decode -> poses (B, k, 7) = (x, y, z, yaw, l, w, h),
    found (B, k), areas (B, k). `center` (None -> cfg.direct_center)
    picks the position estimator (see the reference's
    decode_frame_direct)."""
    if center is None:
        center = cfg.direct_center
    if center in _CENTERS_NOT_PORTED:
        raise _not_ported(f"direct_center={center!r}")
    if center not in _CENTERS:
        raise ValueError(f"unknown direct_center {center!r}")
    if k != 1:
        raise _not_ported(f"k={k} (multi-obstacle decode)")
    if center == "fit" and cfg.fit_boundary == "auto":
        raise _not_ported("fit_boundary='auto'")
    mask, labels, min_x, max_x, min_y, max_y = _heat_components(
        y_pred[..., 1], cfg
    )
    root, found, bboxes, centroids, areas = _topk_roots(
        mask, labels, min_x, max_x, min_y, max_y, cfg, k
    )
    # geometric/consensus/fit back-project to the raw surface point; the
    # radial push replaces the fixed range_offset
    bp_cfg = dataclasses.replace(cfg, range_offset=0.0) if center != "backproject" else cfg

    cluster = mask & (labels == root[:, None, None].to(labels.dtype))
    yaw, lwh, nonempty, p_mean = _direct_pose_from_cluster(
        y_pred, images, cluster, spec, cfg
    )
    l_, w_ = lwh[:, 0], lwh[:, 1]

    def push(xyz):
        """Push a surface point outward along its ray by the box's half
        extent 0.5 (l |cos d| + w |sin d|), d = ray azimuth - heading."""
        x, y = xyz[:, 0], xyz[:, 1]
        d = torch.atan2(y, x) - yaw
        p_ = 0.5 * (l_ * torch.abs(torch.cos(d)) + w_ * torch.abs(torch.sin(d)))
        rho = sqrt_f32(x * x + y * y)
        scale = (rho + p_) / rho.clamp(min=1e-6)
        return torch.stack([x * scale, y * scale, xyz[:, 2]], dim=-1)

    xyz, _, bp_ok = back_project_2d_to_3d(
        centroids, bboxes, images[..., 0], images[..., 1], spec, bp_cfg
    )
    if center in ("consensus", "fit"):
        geo = push(xyz)
        surf = push(p_mean)
        dd = surf - geo
        agree = dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1] + dd[:, 2] * dd[:, 2] <= 2.5**2
        xyz = torch.where(agree[:, None], surf, geo)
    elif center == "geometric":
        xyz = push(xyz)
    if center == "fit":
        xyz, yaw, _ = _fit_pose_to_surface(
            images, cluster, spec, cfg, yaw, lwh, xyz
        )
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    ctr = torch.stack(
        [c * xyz[:, 0] - s * xyz[:, 1], s * xyz[:, 0] + c * xyz[:, 1], xyz[:, 2]],
        dim=-1,
    )
    pose = torch.cat([ctr, yaw[:, None], lwh], dim=-1)
    good = found & nonempty & bp_ok
    return {
        "poses": torch.where(good[:, None], pose, 0.0)[:, None],
        "found": good[:, None],
        "areas": torch.where(found, areas.to(torch.float32), 0.0)[:, None],
    }
