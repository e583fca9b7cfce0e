"""Cylindrical 360-degree range-view projection (counterpart of
`tpufusion/geometry/range_view.py`).

  column = trunc(arctan2(-y, x) / res_h - X_MIN)   mod W
  row'   = trunc(arcsin(z / l2) / res_v - Y_MIN)   mod H
  row    = Y_MAX - row'

The nearest point (smallest full L2 norm) wins a pixel, ties to the lowest
point index. Pixel ids, keys and the (xy range, z, intensity) payload are
computed once, by the pixel kernel (`ops/pixels.py`, eager JAX's float32
arithmetic bit for bit); the z-buffer and gather then run in their
kernel (`ops/projection.py`). Both take the plain versions for CPU
tensors. Channels: 0 = distance, 1 = height, 2 = intensity;
empty pixels hold (0, min_height, 0).
"""

from __future__ import annotations

import torch

from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.ops.pixels import project_points
from tpufusion_torch.ops.projection import nearest_wins_image

# "pallas" names the same bit-exact contract as "exact" (the TPU kernel).
_METHODS = ("exact", "pallas")
_NOT_PORTED = ("packed", "scatter", "sort16")


def project_to_pixels(
    points: torch.Tensor, spec: RangeViewSpec
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Points (..., >=3) -> (row, col) int32 pixel coords + float32 L2 key,
    eager JAX's bit for bit (the pixel kernel on the card, its plain
    version on the CPU: `ops/pixels.py`).

    Rows are already flipped to image orientation. A point with a
    non-finite coordinate gets row 0, column 0 and a NaN norm."""
    lead = points.shape[:-1]
    pts = points.to(torch.float32).reshape(1, -1, points.shape[-1]).contiguous()
    pix, key, _, _ = project_points(pts, None, spec)
    pix = pix.reshape(lead)
    return pix // spec.width, pix % spec.width, key.reshape(lead).view(torch.float32)


def _frame_pixels_keys(
    points: torch.Tensor, spec: RangeViewSpec, valid: torch.Tensor | None
):
    """(B, N, >=3) -> (pix (B, N) int32, key_bits (B, N) int32,
    ok (B, N) bool, payload (B, N, 3) float32), the z-buffer's inputs, in
    one launch of the pixel kernel for CUDA tensors. Non-finite points are
    invalid whatever `valid` says; an invalid point gets pixel 0, key
    INT32_MAX and a zero payload."""
    pts = points.to(torch.float32).contiguous()
    ok = None if valid is None else valid.to(torch.bool).contiguous()
    return project_points(pts, ok, spec)


def range_view_project_batch(
    points: torch.Tensor,  # (B, N, >=3)
    spec: RangeViewSpec = RangeViewSpec(),
    valid: torch.Tensor | None = None,  # (B, N) bool
    method: str = "exact",
) -> torch.Tensor:
    """(B, N, 4) [+ (B, N) valid] -> (B, H, W, 3) float32 image."""
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"projection method {method!r} is TPU-only and not ported "
            "(ROADMAP: do not carry over); use 'exact'"
        )
    if method not in _METHODS:
        raise ValueError(f"unknown projection method {method!r}")
    pix, key, ok, payload = _frame_pixels_keys(points, spec, valid)
    return nearest_wins_image(pix, key, ok, payload, spec)


def range_view_project(
    points: torch.Tensor,  # (N, >=3)
    spec: RangeViewSpec = RangeViewSpec(),
    valid: torch.Tensor | None = None,  # (N,) bool
    method: str = "exact",
) -> torch.Tensor:
    """One padded point cloud (N, 4) [+ (N,) valid] -> (H, W, 3) float32
    image: `range_view_project_batch` on a batch of one (one z-buffer
    launch for a CUDA tensor). `valid` masks padding; non-finite points
    are dropped whatever it says."""
    return range_view_project_batch(
        points[None], spec, None if valid is None else valid[None], method)[0]
