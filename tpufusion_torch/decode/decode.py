"""Pose decode: heat -> clusters -> top-k clusters -> pose (counterpart of
`tpufusion/decode/decode.py`).

The reference decodes one frame and vmaps it, and vmaps again over the
k clusters of a frame. Here every function takes the batch as its first
dimension, and the k clusters of each frame are a second "lane"
dimension: per-cluster tensors are (B, k, ...), per-frame inputs are
broadcast over the lanes, so k > 1 costs no Python loop. Stages, as in
the reference:

  _heat_components   threshold >= min_prob, 4x4 heat stamp (positives at
                     row < 2 or col < 2 stamp nothing), heat > min_heat,
                     4-connected components with bbox extents (the CC
                     kernel on CUDA tensors, the plain sweeps on the CPU)
  _topk_roots        the k largest-area cluster roots, in lax.top_k's
                     stable order (ties to the smaller flat index);
                     find_obstacle, the corner path's largest cluster,
                     is its first lane
  back_project_2d_to_3d       bbox-center pixel (nearest valid fallback)
                     -> 3D point
  corner_vote        candidates in column-major scan order up to
                     max_candidates, corners decoded per candidate,
                     neighbour counts in the Gram form, tied winners
                     averaged, pose from the box's corner geometry
  decode_batch / decode_batch_multi   the corner decode, k = 1 / top-k
  _direct_pose_from_cluster   prob-weighted lwh and yaw (local, global
                     or the dual-codec "auto" gate), the surface-point
                     mean and, for the "head" center, the head's center
  decode_batch_direct         center estimators backproject, geometric,
                     surface, head, silhouette, consensus and fit
                     (circle, ellipse, box or the dual "auto" boundary)

Every float32 sqrt goes through `sqrt_f32` (exact ties in the fallback
argmin must stay ties; see geometry/range_view.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

from tpufusion_torch.config import DecodeConfig, RangeViewSpec
from tpufusion_torch.geometry.boxes import rot_y, rot_z
from tpufusion_torch.geometry.encoding import (
    pixel_angles,
    pixel_points,
    pixel_rotations,
)
from tpufusion_torch.geometry.range_view import sqrt_f32
from tpufusion_torch.ops.cc import connected_components_with_bbox

_SENTINEL = 1e8  # reference uses 10e7 for "no valid pixel"

_CENTERS = (
    "backproject", "geometric", "surface", "head", "silhouette",
    "consensus", "fit",
)

# "fit" center-mode constants (decode.py:709-713)
_FIT_PHI_CANDIDATES = 36
_FIT_GN_ITERS = 4
_FIT_PRIOR = 0.08
_FIT_ACCEPT_DIST = 2.0
_FIT_MIN_POINTS = 5


def _floor_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """jnp.remainder: exact fmod, shifted by y where the signs differ.
    (torch.remainder divides and floors, which rounds differently: at
    3*pi mod 2*pi it lands on the other side of a tie the fit breaks.)"""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """Squared norm over the last axis of size 3, summed left to right."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def _at(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, H, W[, C]) at flat pixel indices idx (B, n) -> (B, n[, C])."""
    b = t.shape[0]
    flat = t.reshape(b, -1, *t.shape[3:])
    if t.dim() == 3:
        return flat.gather(1, idx)
    return flat.gather(1, idx[..., None].expand(-1, -1, flat.shape[-1]))


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


def _area(min_x, max_x, min_y, max_y) -> torch.Tensor:
    """Bbox area per pixel, int64 so the background's sentinel extents
    (masked out by every caller) cannot overflow."""
    return (max_x.long() - min_x.long()) * (max_y.long() - min_y.long())


def _shrunk_bbox(min_x, max_x, min_y, max_y, idx):
    """Extents at flat pixels idx (B, n) -> (bbox (B, n, 4) [l, t, r, b]
    shrunk by 2, integer centroid (B, n, 2) [x, y])."""
    bbox = torch.stack(
        [
            _at(min_x, idx).long() + 2,
            _at(min_y, idx).long() + 2,
            _at(max_x, idx).long() - 2,
            _at(max_y, idx).long() - 2,
        ],
        dim=-1,
    )
    centroid = torch.stack(
        [
            ((bbox[..., 0] + bbox[..., 2]).to(torch.float32) / 2.0).long(),
            ((bbox[..., 1] + bbox[..., 3]).to(torch.float32) / 2.0).long(),
        ],
        dim=-1,
    )
    return bbox, centroid


def _topk_roots(mask, labels, min_x, max_x, min_y, max_y, cfg, k: int):
    """Top-k cluster roots by bbox area. Returns (root_idx (B, k) flat,
    found (B, k), bboxes (B, k, 4) [l, t, r, b] shrunk by 2, centroids
    (B, k, 2) [x, y], areas (B, k) int64). lax.top_k is stable: equal
    areas go to the smaller flat index (the smaller root label), and so
    do the non-root entries scored -1 when k exceeds the cluster count.
    torch.topk promises no order among ties, so it ranks a unique key,
    score * H*W + (H*W - 1 - index)."""
    _, h, w = mask.shape
    hw = h * w
    flat_ids = torch.arange(hw, device=mask.device)
    is_root = mask & (labels == flat_ids.view(h, w).to(labels.dtype))
    score = torch.where(is_root, _area(min_x, max_x, min_y, max_y), -1).flatten(1)
    _, idx = (score * hw + (hw - 1 - flat_ids)).topk(k, dim=1)
    areas = score.gather(1, idx)
    found = areas > cfg.min_bbox_area
    bboxes, centroids = _shrunk_bbox(min_x, max_x, min_y, max_y, idx)
    return idx, found, bboxes, centroids, areas


def find_obstacles_topk(
    prob: torch.Tensor, cfg: DecodeConfig = DecodeConfig(), k: int = 4
):
    """Top-k clusters by bbox area, largest first. (B, H, W) ->
    (centroids (B, k, 2), bboxes (B, k, 4), areas (B, k) float32,
    found (B, k)); zeros where not found."""
    mask, labels, min_x, max_x, min_y, max_y = _heat_components(prob, cfg)
    _, found, bboxes, centroids, areas = _topk_roots(
        mask, labels, min_x, max_x, min_y, max_y, cfg, k
    )
    fm = found[..., None]
    return (
        torch.where(fm, centroids, 0),
        torch.where(fm, bboxes, 0),
        torch.where(found, areas.to(torch.float32), 0.0),
        found,
    )


def find_obstacle(prob: torch.Tensor, cfg: DecodeConfig = DecodeConfig()):
    """The largest cluster per frame (the corner path): lane 0 of the
    top-k. (B, H, W) -> (centroid (B, 2), bbox (B, 4), area (B,), found
    (B,)). The reference takes the smallest root label among the largest
    areas; a cluster's root is its smallest flat index, so that is
    lax.top_k's stable order at k = 1."""
    return tuple(t[:, 0] for t in find_obstacles_topk(prob, cfg, 1))


@contextlib.contextmanager
def _full_f32_matmuls():
    """float32 matmuls in full precision inside the block (or the
    decorated function), the process's setting restored after. With
    torch.set_float32_matmul_precision("high") anywhere in the process
    they would run in TF32 on the card ("medium": bf16 passes in oneDNN
    on some CPUs), and the corner vote's neighbour count would move
    pairs across its distance threshold."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def back_project_2d_to_3d(
    centroid: torch.Tensor,  # (B, ..., 2) [x, y]
    bbox: torch.Tensor,  # (B, ..., 4) [l, t, r, b]
    dist_img: torch.Tensor,  # (B, H, W)
    height_img: torch.Tensor,  # (B, H, W)
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
):
    """Returns (xyz (B, ..., 3), centroid' (B, ..., 2), ok (B, ...)):
    one back-projection per lane of `centroid`."""
    b, h, w = dist_img.shape
    lead = centroid.shape[:-1]
    dev = dist_img.device
    cx = centroid[..., 0].reshape(b, -1)
    cy = centroid[..., 1].reshape(b, -1)
    bb = bbox.reshape(b, -1, 4)
    valid = (dist_img > 0) & (height_img > spec.min_height)
    # JAX clamps out-of-range gather indices; only a lane without a
    # cluster (masked downstream) carries such a centroid
    centroid_ok = _at(valid, cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1))

    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]

    def lane(t):
        return t[..., None, None]

    in_window = (
        (rows >= lane(bb[..., 1]))
        & (rows <= lane(bb[..., 3]))
        & (cols >= lane(bb[..., 0]))
        & (cols <= lane(bb[..., 2]))
    )
    dx = (cols - lane(cx)).to(torch.float32)
    dy = (rows - lane(cy)).to(torch.float32)
    d2c = sqrt_f32(dx * dx + dy * dy)
    d2c = torch.where(valid[:, None] & in_window, d2c, _SENTINEL).flatten(2)
    flat_arg = d2c.argmin(dim=-1)  # first minimum in raster order
    fb_y, fb_x = flat_arg // w, flat_arg % w
    fb_ok = d2c.gather(-1, flat_arg[..., None])[..., 0] < _SENTINEL

    use_fallback = (~centroid_ok) & (bb[..., 0] != 0) & (bb[..., 2] != 0)
    zero = torch.zeros_like(cx)
    new_cx = torch.where(use_fallback, torch.where(fb_ok, fb_x, zero), cx)
    new_cy = torch.where(use_fallback, torch.where(fb_ok, fb_y, zero), cy)

    nonzero = ~((new_cx == 0) & (new_cy == 0))
    pix = new_cy.clamp(0, h - 1) * w + new_cx.clamp(0, w - 1)
    d = _at(dist_img, pix) + cfg.range_offset
    theta = (new_cx.to(torch.float32) + spec.x_min) * spec.res_h_rad
    xyz = torch.stack(
        [d * torch.cos(theta), -d * torch.sin(theta), _at(height_img, pix)],
        dim=-1,
    )
    xyz = torch.where(nonzero[..., None], xyz, 0.0)
    return (
        xyz.reshape(*lead, 3),
        torch.stack([new_cx, new_cy], dim=-1).reshape(*lead, 2),
        nonzero.reshape(lead),
    )


@_full_f32_matmuls()
def corner_vote(
    y_pred: torch.Tensor,  # (B, H, W, 2 + 24)
    image: torch.Tensor,  # (B, H, W, >=2)
    bbox: torch.Tensor,  # (B, n, 4) [l, t, r, b]
    centroid_3d: torch.Tensor,  # (B, n, 3)
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
):
    """The reference's corner vote, one per lane (B, n). Returns (pose
    (B, n, 7) [xyz, yaw, l, w, h], box (B, n, 8, 3), ok (B, n),
    overflow (B, n)).

    Candidates are the pixels in the bbox +- margins whose row and column
    hold a positive anywhere in the frame, taken in the reference's
    column-major scan order up to K = max_candidates (`overflow` where
    more were there). The TPU reference inverts the rank with a one-hot
    matmul because its scatter runs serially; here the rank is a cumsum
    in column-major order and the pixel ids scatter into the K slots.
    Each candidate decodes its 8 corners c = Rz(theta) Ry(phi) c' + p;
    corners beyond far_delta of the 3D centroid drop out; each candidate
    counts the others within max_bbox_dist (Frobenius over 24 dims) in
    the reference's Gram form sq_i + sq_j - 2 <c_i, c_j>, centred on the
    centroid, so pairs at the threshold fall as in the reference. The
    Gram product is (B, n, K, K) float32, 16 MiB per lane at K = 2048.
    Every matmul here runs in full float32 (`_full_f32_matmuls`)."""
    b, h, w = y_pred.shape[:3]
    n = bbox.shape[1]
    dev = y_pred.device
    k = min(cfg.max_candidates, h * w)

    pos = y_pred[..., 1] >= cfg.min_prob
    col_has_pos = pos.any(dim=1)  # (B, W)
    row_has_pos = pos.any(dim=2)  # (B, H)
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]

    def lane(t):
        return t[..., None, None]

    in_window = (
        (cols >= lane(bbox[..., 0] - cfg.margin_x))
        & (cols < lane(bbox[..., 2] + cfg.margin_x))
        & (rows >= lane(bbox[..., 1] - cfg.margin_y))
        & (rows < lane(bbox[..., 3] + cfg.margin_y))
    )
    cand = in_window & col_has_pos[:, None, None, :] & row_has_pos[:, None, :, None]

    # slot s holds the (s+1)-th candidate in column-major order; slots
    # past the candidate count keep the reference's pixel (row 0, W - 1)
    cand_cm = cand.transpose(-1, -2).reshape(b, n, w * h)
    rank = cand_cm.cumsum(dim=-1)
    total = rank[..., -1]
    slot = torch.where(cand_cm & (rank <= k), rank - 1, k)  # k: discarded
    ids = torch.arange(w * h, device=dev).expand(b, n, -1)
    sel = torch.full((b, n, k + 1), (w - 1) * h, device=dev, dtype=torch.long)
    sel = sel.scatter(-1, slot, ids)[..., :k]
    sel_col, sel_row = sel // h, sel % h
    sel_valid = torch.arange(k, device=dev) < total[..., None]

    pix = (sel_row * w + sel_col).reshape(b, n * k)
    reg = _at(y_pred, pix)[..., 2:26].reshape(b, n, k, 8, 3)
    dist_h = _at(image, pix)[..., :2].reshape(b, n, k, 2)
    theta = (sel_col.to(torch.float32) + spec.x_min) * spec.res_h_rad
    phi = (sel_row.to(torch.float32) + spec.y_min) * spec.res_v_rad
    rot = rot_z(theta) @ rot_y(phi)  # (B, n, K, 3, 3)
    p3 = torch.stack(
        [
            dist_h[..., 0] * torch.cos(theta),
            -dist_h[..., 0] * torch.sin(theta),
            dist_h[..., 1],
        ],
        dim=-1,
    )
    corners = reg @ rot.transpose(-1, -2) + p3[..., None, :]  # (B, n, K, 8, 3)

    c3 = centroid_3d[:, :, None, None, :]
    delta = torch.tensor(cfg.far_delta, dtype=torch.float32, device=dev)
    near = ((corners - c3).abs() <= delta).all(dim=-1).all(dim=-1)
    sel_valid = sel_valid & near
    flat = corners.reshape(b, n, k, 24)

    # neighbour counts, centred on the centroid (distances are
    # translation invariant; small magnitudes keep the Gram form exact)
    sel_c = flat - centroid_3d.repeat(1, 1, 8)[:, :, None, :]
    sq = (sel_c * sel_c).sum(dim=-1)
    d2 = sq[..., :, None] + sq[..., None, :]
    d2 -= 2.0 * (sel_c @ sel_c.transpose(-1, -2))
    d2.clamp_(min=0.0)
    d2.diagonal(dim1=-2, dim2=-1).zero_()
    pair_ok = (d2 > 1e-9) & (d2 < cfg.max_bbox_dist**2)
    del d2
    pair_ok &= sel_valid[..., None, :]
    pair_ok &= sel_valid[..., :, None]
    counts = torch.where(sel_valid, pair_ok.sum(dim=-1), -1)
    del pair_ok
    winners = sel_valid & (counts == counts.amax(dim=-1, keepdim=True))
    n_win = winners.sum(dim=-1).clamp(min=1)
    box = torch.where(winners[..., None], flat, 0.0).sum(dim=-2)
    box = box.reshape(b, n, 8, 3) / n_win[..., None, None]
    ok = sel_valid.any(dim=-1)

    # pose from the corner geometry (predict.py:166-197)
    dx = box[..., 0:4, 0] - box[..., 4:8, 0]
    dy = box[..., 0:4, 1] - box[..., 4:8, 1]
    yaw = torch.atan2(dy, dx)
    cos_yaw = torch.cos(yaw)
    big = torch.abs(cos_yaw) > 1e-12
    safe_cos = torch.where(big, cos_yaw, 1.0)
    box_l = torch.where(big, dx / safe_cos, dy)
    dx2 = box[..., 0:4, 0] - box[..., 2:6, 0]
    dy2 = box[..., 0:4, 1] - box[..., 2:6, 1]
    box_w = torch.where(big, dy2 / safe_cos, dx2)
    box_h = torch.abs(box[..., 0:4, 2] - box[..., 1:5, 2])
    pose = torch.cat(
        [
            box.mean(dim=-2),
            torch.stack(
                [
                    yaw.mean(dim=-1),
                    box_l.abs().mean(dim=-1),
                    box_w.abs().mean(dim=-1),
                    box_h.mean(dim=-1),
                ],
                dim=-1,
            ),
        ],
        dim=-1,
    )
    pose = torch.where(ok[..., None], pose, 0.0)
    box = torch.where(ok[..., None, None], box, 0.0)
    return pose, box, ok, total > k


def _corner_lanes(y_pred, images, centroid, bbox, found, spec, cfg):
    """The corner decode's stages per lane (B, n), from the 2D cluster
    on: (stage1, stage2, xyz, pose, box, ok, overflow)."""
    stage1 = found & ~((centroid[..., 0] == 0) & (centroid[..., 1] == 0))
    xyz, _, bp_ok = back_project_2d_to_3d(
        centroid, bbox, images[..., 0], images[..., 1], spec, cfg
    )
    stage2 = stage1 & bp_ok & ~((xyz[..., 0] == 0.0) & (xyz[..., 1] == 0.0))
    pose, box, cv_ok, overflow = corner_vote(y_pred, images, bbox, xyz, spec, cfg)
    return stage1, stage2, xyz, pose, box, stage2 & cv_ok, overflow


def decode_batch(
    y_pred: torch.Tensor,  # (B, H, W, 2 + 24)
    images: torch.Tensor,  # (B, H, W, >=2)
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
) -> dict[str, torch.Tensor]:
    """The corner decode of the largest cluster per frame: pose (B, 7) =
    (tx, ty, tz, rz, l, w, h), zeros where no obstacle survives every
    stage, plus the intermediate products (reference decode_frame)."""
    centroid, bbox, area, found = find_obstacle(y_pred[..., 1], cfg)
    stage1, stage2, xyz, pose, box, ok, overflow = _corner_lanes(
        y_pred, images, centroid[:, None], bbox[:, None], found[:, None], spec, cfg
    )
    stage1, stage2, ok = stage1[:, 0], stage2[:, 0], ok[:, 0]
    return {
        "pose": torch.where(ok[:, None], pose[:, 0], 0.0),
        "found": ok,
        "centroid_2d": torch.where(stage1[:, None], centroid, 0),
        "bbox_2d": torch.where(stage1[:, None], bbox, 0),
        "centroid_3d": torch.where(stage2[:, None], xyz[:, 0], 0.0),
        "corners_3d": torch.where(ok[:, None, None], box[:, 0], 0.0),
        "area": area,
        # the fixed vote budget truncated the candidates: the pose may
        # differ from the reference's unbounded scan
        "vote_overflow": stage2 & overflow[:, 0],
    }


def decode_batch_multi(
    y_pred: torch.Tensor,
    images: torch.Tensor,
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
    k: int = 4,
) -> dict[str, torch.Tensor]:
    """The corner decode of the top-k clusters: poses (B, k, 7) ordered by
    cluster area, found (B, k), areas (B, k), vote_overflow (B, k)."""
    centroids, bboxes, areas, founds = find_obstacles_topk(y_pred[..., 1], cfg, k)
    _, stage2, _, pose, _, ok, overflow = _corner_lanes(
        y_pred, images, centroids, bboxes, founds, spec, cfg
    )
    return {
        "poses": torch.where(ok[..., None], pose, 0.0),
        "found": ok,
        "areas": areas,
        "vote_overflow": stage2 & overflow,
    }


@_full_f32_matmuls()
def _direct_pose_from_cluster(y_pred, image, cluster, spec, cfg, with_center):
    """Weighted yaw and lwh over each cluster's valid pixels; y_pred and
    image are per frame (B, H, W, C), cluster per lane (B, n, H, W).
    Returns (yaw (B, n), lwh (B, n, 3), ok (B, n), p_mean (B, n, 3),
    oriented (B, n), center (B, n, 3) or None); yaw, lwh and center are
    0 where ok is False. `oriented` says the local-frame codec gave the
    yaw; `center` (with_center) is the head's averaged center in the
    reference's frame."""
    yp, im = y_pred[:, None], image[:, None]
    prob = yp[..., 1]
    valid = (im[..., 0] > 0) & (im[..., 1] > spec.min_height)
    m = cluster & valid & (prob >= cfg.min_prob)
    wgt = torch.where(m, prob, 0.0)
    tot = wgt.sum(dim=(-2, -1)).clamp(min=1e-6)

    def wmean(ch):
        return (ch * wgt).sum(dim=(-2, -1)) / tot

    lwh = (yp[..., 5:8] * wgt[..., None]).sum(dim=(-3, -2)) / tot[..., None]
    dual = y_pred.shape[-1] >= 12  # [.., sin_l, cos_l, sin_g, cos_g]

    def local_mean():
        # sin/cos(yaw + theta_pixel): rotate each pixel's vector back first
        theta, _ = pixel_angles(spec, y_pred.device)
        st, ct = torch.sin(theta), torch.cos(theta)
        s_px, c_px = yp[..., 8], yp[..., 9]
        return wmean(s_px * ct - c_px * st), wmean(c_px * ct + s_px * st)

    def global_mean():
        gi = 10 if dual else 8
        return wmean(yp[..., gi]), wmean(yp[..., gi + 1])

    if cfg.direct_yaw_frame == "local":
        sin_m, cos_m = local_mean()
        oriented = torch.ones_like(m[..., 0, 0])
    elif cfg.direct_yaw_frame == "global":
        sin_m, cos_m = global_mean()
        oriented = torch.zeros_like(m[..., 0, 0])
    elif cfg.direct_yaw_frame == "auto":
        # dual-codec gate: the codec that cannot see this cluster's
        # surface family averages toward the zero vector, so each mean
        # vector's length is that codec's confidence
        if not dual:
            raise ValueError(
                "direct_yaw_frame='auto' needs a dual-codec head "
                "(ModelConfig.yaw_codec='dual', 12-channel output); got "
                f"{y_pred.shape[-1]} channels"
            )
        sl, cl = local_mean()
        sg, cg = global_mean()
        oriented = sl * sl + cl * cl >= sg * sg + cg * cg
        sin_m = torch.where(oriented, sl, sg)
        cos_m = torch.where(oriented, cl, cg)
    else:
        raise ValueError(f"unknown direct_yaw_frame {cfg.direct_yaw_frame!r}")
    yaw = torch.atan2(sin_m, cos_m)

    # prob-weighted mean of the cluster's surface points within a vehicle
    # depth of its closest return
    p = pixel_points(im, spec)  # (B, 1, H, W, 3)
    d = im[..., 0]
    dmin = torch.where(m, d, math.inf).amin(dim=(-2, -1))
    msurf = m & (d <= dmin[..., None, None] + 4.0)
    wsurf = torch.where(msurf, prob, 0.0)
    p_mean = (p * wsurf[..., None]).sum(dim=(-3, -2)) / wsurf.sum(
        dim=(-2, -1)
    ).clamp(min=1e-6)[..., None]
    ok = m.flatten(-2).any(dim=-1)
    center = None
    if with_center:
        # per-pixel decoded physical center R dc + p, averaged, then back
        # to the reference's frame: Rz(-yaw) c_phys
        rot = pixel_rotations(spec, y_pred.device)
        c_px = (rot @ yp[..., 2:5, None])[..., 0] + p
        c_phys = (c_px * wgt[..., None]).sum(dim=(-3, -2)) / tot[..., None]
        c, s = torch.cos(-yaw), torch.sin(-yaw)
        center = torch.stack(
            [
                c * c_phys[..., 0] - s * c_phys[..., 1],
                s * c_phys[..., 0] + c * c_phys[..., 1],
                c_phys[..., 2],
            ],
            dim=-1,
        )
        center = torch.where(ok[..., None], center, 0.0)
    yaw = torch.where(ok, yaw, 0.0)
    lwh = torch.where(ok[..., None], lwh, 0.0)
    return yaw, lwh, ok, p_mean, oriented, center


def _silhouette_center(image, cluster, spec, yaw, lwh, seed):
    """Refine the seed (B, n, 3) laterally from the cluster's surface
    silhouette in the predicted-yaw box frame (reference
    `_silhouette_center`, which documents the model): 3 %/97 % quantile
    extents of the gated points, the near-face constraint of each axis
    weighted by how head-on the ray meets it. Fewer than 5 gated points
    keep the seed."""
    im = image[:, None]
    valid = (im[..., 0] > 0) & (im[..., 1] > spec.min_height)
    m = cluster & valid
    p = pixel_points(im, spec)
    l_, w_ = lwh[..., 0], lwh[..., 1]
    gate = 0.5 * sqrt_f32(l_ * l_ + w_ * w_) + 1.0
    near = _norm2(p - seed[..., None, None, :]) <= (gate * gate)[..., None, None]
    mext = m & near
    n = mext.flatten(-2).sum(dim=-1)

    cy, sy = torch.cos(yaw), torch.sin(yaw)
    u = p[..., 0] * cy[..., None, None] + p[..., 1] * sy[..., None, None]
    v = -p[..., 0] * sy[..., None, None] + p[..., 1] * cy[..., None, None]
    q = torch.tensor([0.03, 0.97], dtype=torch.float32, device=image.device)
    # linear interpolation over the non-NaN values, as jnp.nanquantile
    min_u, max_u = torch.nanquantile(
        torch.where(mext, u, math.nan).flatten(-2), q, dim=-1
    )
    min_v, max_v = torch.nanquantile(
        torch.where(mext, v, math.nan).flatten(-2), q, dim=-1
    )
    d_rel = torch.atan2(seed[..., 1], seed[..., 0]) - yaw
    cos_d, sin_d = torch.cos(d_rel), torch.sin(d_rel)
    half_l, half_w = 0.5 * l_, 0.5 * w_
    cu_near = torch.where(cos_d > 0, min_u + half_l, max_u - half_l)
    cv_near = torch.where(sin_d > 0, min_v + half_w, max_v - half_w)
    u_seed = seed[..., 0] * cy + seed[..., 1] * sy
    v_seed = -seed[..., 0] * sy + seed[..., 1] * cy
    a_u, a_v = torch.abs(cos_d), torch.abs(sin_d)
    cu = a_u * cu_near + (1 - a_u) * u_seed
    cv = a_v * cv_near + (1 - a_v) * v_seed
    p_sil = torch.stack([cu * cy - cv * sy, cu * sy + cv * cy, seed[..., 2]], dim=-1)
    return torch.where((n >= 5)[..., None], p_sil, seed)


def _fit_pose_to_surface(image, cluster, spec, cfg, yaw, lwh, seed):
    """Gauss-Newton fit of the box's known-size boundary to each
    cluster's raw surface points (reference `_fit_pose_to_surface`, which
    documents the model). Candidates: the head yaw alone for a circle, a
    36-step grid over [0, pi) plus the head yaw for an ellipse or box.
    Per lane (B, n); returns (center (B, n, 3), phi (B, n), ok_fit)."""
    dev = image.device
    l_, w_ = lwh[..., 0], lwh[..., 1]
    head_phi = _floor_mod(yaw, math.pi)[..., None]
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
        phis = torch.cat([grid.expand(*yaw.shape, -1), head_phi], dim=-1)
    else:
        raise ValueError(f"unknown fit_boundary {cfg.fit_boundary!r}")
    a3, b3 = a[..., None, None], bb[..., None, None]

    im = image[:, None]
    valid = (im[..., 0] > 0) & (im[..., 1] > spec.min_height)
    m = cluster & valid
    p = pixel_points(im, spec)
    d = im[..., 0]
    dmin = torch.where(m, d, math.inf).amin(dim=(-2, -1))
    gate = 0.5 * sqrt_f32(l_ * l_ + w_ * w_) + 3.0
    near = _norm2(p - seed[..., None, None, :]) <= (gate * gate)[..., None, None]
    msurf = m & (d <= dmin[..., None, None] + 4.0) & near
    px = p[..., 0].flatten(-2)[..., None, :]  # (B, 1, 1, P)
    py = p[..., 1].flatten(-2)[..., None, :]
    wts = msurf.flatten(-2).to(torch.float32)[..., None, :]  # (B, n, 1, P)
    nw = wts.sum(dim=-1).clamp(min=1e-6)  # (B, n, 1)
    lam = _FIT_PRIOR * nw
    sx, sy = seed[..., 0:1], seed[..., 1:2]

    def residual(mx, my, phi):
        """Residual per point and its box-frame gradient; mx, my, phi are
        (B, n, C)."""
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

    mx = sx.expand_as(phis)
    my = sy.expand_as(phis)
    for _ in range(_FIT_GN_ITERS):
        r, gx, gy, c, s = residual(mx, my, phis)
        jx = -(c * gx - s * gy)
        jy = -(s * gx + c * gy)
        jxx = (wts * jx * jx).sum(dim=-1) + lam
        jxy = (wts * jx * jy).sum(dim=-1)
        jyy = (wts * jy * jy).sum(dim=-1) + lam
        bx = (wts * jx * r).sum(dim=-1) + lam * (mx - sx)
        by = (wts * jy * r).sum(dim=-1) + lam * (my - sy)
        det = jxx * jyy - jxy * jxy
        mx, my = mx - (jyy * bx - jxy * by) / det, my - (jxx * by - jxy * bx) / det
    r, *_ = residual(mx, my, phis)
    ress = (wts * r * r).sum(dim=-1) / nw  # (B, n, C)

    i = ress.argmin(dim=-1, keepdim=True)  # first minimum
    decisive = ress.gather(-1, i)[..., 0] < 0.9 * ress[..., -1]
    ctr = torch.where(
        decisive[..., None],
        torch.stack([mx.gather(-1, i)[..., 0], my.gather(-1, i)[..., 0]], dim=-1),
        torch.stack([mx[..., -1], my[..., -1]], dim=-1),
    )
    phi = torch.where(decisive, phis.gather(-1, i)[..., 0], phis[..., -1])
    # resolve the boundary's pi-symmetry with the head yaw
    cand = torch.stack([phi, phi + math.pi, phi - math.pi], dim=-1)
    off = torch.abs(
        _floor_mod((cand - yaw[..., None]) + math.pi, 2 * math.pi) - math.pi
    )
    phi = cand.gather(-1, off.argmin(dim=-1, keepdim=True))[..., 0]
    dc = ctr - seed[..., :2]
    ok_fit = (wts.sum(dim=(-2, -1)) >= _FIT_MIN_POINTS) & (
        dc[..., 0] * dc[..., 0] + dc[..., 1] * dc[..., 1] <= _FIT_ACCEPT_DIST**2
    )
    center = torch.cat([ctr, seed[..., 2:]], dim=-1)
    return (
        torch.where(ok_fit[..., None], center, seed),
        torch.where(ok_fit, phi, yaw),
        ok_fit,
    )


def decode_batch_direct(
    y_pred: torch.Tensor,  # (B, H, W, 2 + 8 [+ 2])
    images: torch.Tensor,  # (B, H, W, >=2)
    spec: RangeViewSpec = RangeViewSpec(),
    cfg: DecodeConfig = DecodeConfig(),
    k: int = 1,
    center: str | None = None,
) -> dict[str, torch.Tensor]:
    """Direct-head decode of the top-k clusters -> poses (B, k, 7) =
    (x, y, z, yaw, l, w, h), found (B, k), areas (B, k). `center` (None
    -> cfg.direct_center) picks the position estimator (see the
    reference's decode_frame_direct)."""
    if center is None:
        center = cfg.direct_center
    if center not in _CENTERS:
        raise ValueError(f"unknown direct_center {center!r}")
    mask, labels, min_x, max_x, min_y, max_y = _heat_components(
        y_pred[..., 1], cfg
    )
    root, found, bboxes, centroids, areas = _topk_roots(
        mask, labels, min_x, max_x, min_y, max_y, cfg, k
    )
    cluster = mask[:, None] & (labels[:, None] == root[..., None, None].to(labels.dtype))
    yaw, lwh, nonempty, p_mean, oriented, head_center = _direct_pose_from_cluster(
        y_pred, images, cluster, spec, cfg, with_center=center == "head"
    )
    good = found & nonempty
    if center == "head":
        pose = torch.cat([head_center, yaw[..., None], lwh], dim=-1)
    else:
        l_, w_ = lwh[..., 0], lwh[..., 1]

        def push(xyz):
            """Push a surface point outward along its ray by the box's
            half extent 0.5 (l |cos d| + w |sin d|), d = ray azimuth -
            heading."""
            x, y = xyz[..., 0], xyz[..., 1]
            d = torch.atan2(y, x) - yaw
            p_ = 0.5 * (l_ * torch.abs(torch.cos(d)) + w_ * torch.abs(torch.sin(d)))
            rho = sqrt_f32(x * x + y * y)
            scale = (rho + p_) / rho.clamp(min=1e-6)
            return torch.stack([x * scale, y * scale, xyz[..., 2]], dim=-1)

        def back_project():
            # every center but "backproject" starts from the raw surface
            # point; the radial push replaces the fixed range_offset
            bp_cfg = cfg if center == "backproject" else dataclasses.replace(
                cfg, range_offset=0.0
            )
            xyz, _, ok = back_project_2d_to_3d(
                centroids, bboxes, images[..., 0], images[..., 1], spec, bp_cfg
            )
            return xyz, ok

        if center == "surface":
            xyz, bp_ok = push(p_mean), nonempty
        elif center in ("consensus", "fit"):
            geo, bp_ok = back_project()
            geo, surf = push(geo), push(p_mean)
            agree = _norm2(surf - geo) <= 2.5**2
            xyz = torch.where(agree[..., None], surf, geo)
        else:
            xyz, bp_ok = back_project()
            if center in ("geometric", "silhouette"):
                xyz = push(xyz)
        if center == "silhouette":
            xyz = _silhouette_center(images, cluster, spec, yaw, lwh, xyz)
        elif center == "fit" and cfg.fit_boundary == "auto":
            # dual-codec assets: fit both boundary arms and keep the one
            # matching the codec the yaw gate picked
            cfg_ori = dataclasses.replace(cfg, fit_boundary=cfg.fit_boundary_oriented)
            cfg_sym = dataclasses.replace(
                cfg, fit_boundary="circle", fit_surface_scale=cfg.fit_symmetric_scale
            )
            xyz_o, yaw_o, _ = _fit_pose_to_surface(
                images, cluster, spec, cfg_ori, yaw, lwh, xyz
            )
            xyz_s, yaw_s, _ = _fit_pose_to_surface(
                images, cluster, spec, cfg_sym, yaw, lwh, xyz
            )
            xyz = torch.where(oriented[..., None], xyz_o, xyz_s)
            yaw = torch.where(oriented, yaw_o, yaw_s)
        elif center == "fit":
            xyz, yaw, _ = _fit_pose_to_surface(images, cluster, spec, cfg, yaw, lwh, xyz)
        c, s = torch.cos(-yaw), torch.sin(-yaw)
        ctr = torch.stack(
            [
                c * xyz[..., 0] - s * xyz[..., 1],
                s * xyz[..., 0] + c * xyz[..., 1],
                xyz[..., 2],
            ],
            dim=-1,
        )
        pose = torch.cat([ctr, yaw[..., None], lwh], dim=-1)
        good = good & bp_ok
    return {
        "poses": torch.where(good[..., None], pose, 0.0),
        "found": good,
        "areas": torch.where(found, areas.to(torch.float32), 0.0),
    }
