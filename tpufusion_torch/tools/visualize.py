"""Visualization: range-view / BEV renders with box overlays (counterpart of
`tpufusion/tools/visualize.py`).

The renders the live viewer pushes (`render_range_view`, `render_bev`,
`render_class_mask` without an overlay) are numpy alone: the 8-bit scaling
and the grey-to-BGR step (a channel repeat, what `cv2.cvtColor(...,
COLOR_GRAY2BGR)` computes), so the viewer runs on a host without OpenCV.
The overlays take their corners and rects from the port's
`geometry/boxes.py` on CPU float32 tensors and draw with cv2, imported
where it draws; so do `render_radar_boxes_on_camera`, `detect_edges` and
`save`. On a host without cv2 those raise ImportError.
"""

from __future__ import annotations

import numpy as np

from tpufusion_torch.config import BevSpec, RangeViewSpec


def _to_u8(img: np.ndarray) -> np.ndarray:
    lo, hi = float(np.min(img)), float(np.max(img))
    if hi <= lo:
        return np.zeros_like(img, np.uint8)
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def gray_to_bgr(gray: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> (H, W, 3): the grey value in every channel."""
    return np.repeat(gray[..., None], 3, axis=-1)


def render_range_view(
    image: np.ndarray,  # (H, W, 3) distance/height/intensity
    center=None,
    size=None,
    yaw=None,
    spec: RangeViewSpec = RangeViewSpec(),
) -> np.ndarray:
    """(H, W, 3) uint8 BGR with the projected box overlay (if pose given)."""
    canvas = gray_to_bgr(_to_u8(image[..., 0]))
    if center is not None:
        import cv2
        import torch

        from tpufusion_torch.geometry.boxes import (
            outer_rect,
            project_2d,
            sorted_projected_corners,
        )

        c = torch.as_tensor(np.asarray(center), dtype=torch.float32)
        s = torch.as_tensor(np.asarray(size), dtype=torch.float32)
        y = torch.as_tensor(np.asarray(yaw), dtype=torch.float32)
        corners = sorted_projected_corners(c, s, y, spec).numpy()
        for px, py in corners:
            cv2.circle(canvas, (int(px), int(py)), 2, (255, 255, 255), -1)
        ulx, uly, lrx, lry = [int(v) for v in outer_rect(c, s, y, spec)]
        cv2.rectangle(canvas, (ulx, uly), (lrx, lry), (0, 255, 0), 1)
        ccol, crow = project_2d(c[0], c[1], c[2], spec)
        cv2.circle(canvas, (int(ccol), int(crow)), 2, (0, 0, 255), -1)
    return canvas


def render_class_mask(prob_map: np.ndarray, bbox=None) -> np.ndarray:
    """White car pixels + red decode bbox, like predict.py:451-486."""
    mask = (np.round(prob_map) * 255).astype(np.uint8)
    canvas = gray_to_bgr(mask)
    if bbox is not None and not all(int(v) == 0 for v in bbox):
        import cv2

        l, t, r, b = [int(v) for v in bbox]
        cv2.rectangle(canvas, (l, t), (r, b), (0, 0, 255), 2)
    return canvas


def render_bev(
    bev_image: np.ndarray,  # (nx, ny, C) raster from bev_rasterize
    center=None,
    size=None,
    yaw=None,
    spec: BevSpec = BevSpec(),
) -> np.ndarray:
    """Density channel as grayscale with the rotated BEV box overlay —
    the drawing `draw_obs_bb_on_birds_eye_view.py` named but never built."""
    canvas = gray_to_bgr(_to_u8(bev_image[..., 0]))
    if center is not None:
        import cv2

        cx, cy = float(center[0]), float(center[1])
        l, w = float(size[0]), float(size[1])
        c, s = np.cos(float(yaw)), np.sin(float(yaw))
        dx = np.asarray([l, l, -l, -l]) / 2
        dy = np.asarray([w, -w, -w, w]) / 2
        xs = cx + c * dx - s * dy
        ys = cy + s * dx + c * dy
        # grid index before the double flip: ix = (x+R)/res_x
        ix = (xs + spec.max_range) / spec.res_x
        iy = (ys + spec.max_range) / spec.res_y
        # undo flips: row = nx-1-ix, col = ny-1-iy; draw in (col,row)
        pts = np.stack(
            [spec.ny - 1 - iy, spec.nx - 1 - ix], axis=-1
        ).astype(np.int32)
        cv2.polylines(canvas, [pts.reshape(-1, 1, 2)], True, (0, 255, 0), 1)
    return canvas


def save(path: str, canvas: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, canvas)


def render_radar_boxes_on_camera(
    image_bgr: np.ndarray,  # (H, W, 3) uint8
    tracks,  # iterable of data.radar.RadarTrack (or dicts with range/angle)
    camera,  # geometry.camera.CameraModel
    box_lwh: tuple = (4.2418, 1.574, 1.5748),
    crop_top: int = 0,
) -> np.ndarray:
    """Radar-derived 3D boxes drawn onto a camera frame.

    Matches `modules/lidar/process/process_radar_data.py:122-141` +
    `common/camera_model.py:69-89`: each radar return becomes a nominal
    vehicle box at its range/angle (with the radar->lidar mount offset
    applied by RadarTrack.to_xyz); the centroid is drawn blue, the top
    four corners green, the bottom four red, as filled circles."""
    import cv2

    from tpufusion_torch.data.radar import RadarTrack

    l, w, h = box_lwh
    canvas = image_bgr.copy()
    for t in tracks:
        if isinstance(t, dict):
            t = RadarTrack(
                timestamp=int(t.get("timestamp", 0)),
                range=float(t["range"]),
                angle=float(t["angle"]),
                rate=float(t.get("rate", 0.0)),
                status=float(t.get("status", 0.0)),
            )
        tx, ty, tz = t.to_xyz()
        pts = [
            (tx, ty, tz),  # centroid — blue
            (tx - l / 2, ty + w / 2, tz + h / 2),  # top 4 — green
            (tx - l / 2, ty - w / 2, tz + h / 2),
            (tx + l / 2, ty + w / 2, tz + h / 2),
            (tx + l / 2, ty - w / 2, tz + h / 2),
            (tx + l / 2, ty - w / 2, tz - h / 2),  # bottom 4 — red
            (tx - l / 2, ty + w / 2, tz - h / 2),
            (tx - l / 2, ty - w / 2, tz - h / 2),
            (tx + l / 2, ty + w / 2, tz - h / 2),
        ]
        uv = camera.project_lidar_to_pixels(np.asarray(pts, float))
        hh, ww = canvas.shape[:2]
        for pos, (u, v) in enumerate(uv):
            color = (
                (255, 0, 0) if pos == 0
                else (0, 255, 0) if pos < 5
                else (0, 0, 255)
            )
            u, v = int(round(u)), int(round(v)) - crop_top
            if 0 <= u < ww and 0 <= v < hh:
                cv2.circle(canvas, (u, v), 5, color, thickness=-1)
    return canvas


def detect_edges(
    img: np.ndarray, threshold1: float = 100, threshold2: float = 200
) -> np.ndarray:
    """Canny edge map (`modules/video/edge_detection.py:14-17`; the
    reference's comment records Canny beating Sobel on its test set)."""
    import cv2

    return cv2.Canny(img, threshold1, threshold2)
