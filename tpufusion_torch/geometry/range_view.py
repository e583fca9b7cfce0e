"""Cylindrical 360-degree range-view projection (counterpart of
`tpufusion/geometry/range_view.py`).

  column = trunc(arctan2(-y, x) / res_h - X_MIN)   mod W
  row'   = trunc(arcsin(z / l2) / res_v - Y_MIN)   mod H
  row    = Y_MAX - row'

The nearest point (smallest full L2 norm) wins a pixel, ties to the lowest
point index. Pixel ids, keys and the (xy range, z, intensity) payload are
computed once here; the z-buffer and gather then run in the kernel for
CUDA tensors and in the plain version for CPU tensors
(`ops/projection.py`). Channels: 0 = distance, 1 = height, 2 = intensity;
empty pixels hold (0, min_height, 0).
"""

from __future__ import annotations

import torch

from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.ops.projection import nearest_wins_image
from tpufusion_torch.ops.scatter import _sortable_bits

# "pallas" names the same bit-exact contract as "exact" (the TPU kernel).
_METHODS = ("exact", "pallas")
_NOT_PORTED = ("packed", "scatter", "sort16")


def sqrt_f32(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt. torch's float32 sqrt on the CPU's
    AVX-512 path is not correctly rounded (it differs from numpy/XLA in
    ~0.6% of elements, and by position in the tensor); rounding the
    float64 root to float32 is exact on the CPU and the GPU alike."""
    return torch.sqrt(v.to(torch.float64)).to(torch.float32)


def project_to_pixels(
    points: torch.Tensor, spec: RangeViewSpec
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Points (..., >=3) -> (row, col) int32 pixel coords + float32 L2 key.

    Rows are already flipped to image orientation."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    l2 = sqrt_f32(x * x + y * y + z * z)
    az = torch.atan2(-y, x) / spec.res_h_rad - spec.x_min
    ratio = torch.where(l2 > 0, z / torch.clamp(l2, min=1e-12), 0.0)
    el = torch.asin(ratio) / spec.res_v_rad - spec.y_min
    # NaN/inf casts give garbage here; callers mask those points first
    col = torch.remainder(torch.trunc(az).to(torch.int32), spec.width)
    row_unflipped = torch.remainder(torch.trunc(el).to(torch.int32), spec.height)
    row = spec.y_max - row_unflipped
    return row, col, l2


def _frame_pixels_keys(
    points: torch.Tensor, spec: RangeViewSpec, valid: torch.Tensor | None
):
    """(B, N, >=3) -> (pix (B, N) int32, key_bits (B, N) int32,
    ok (B, N) bool, payload (B, N, 3) float32). Non-finite points are
    invalid whatever `valid` says; invalid points get pixel 0."""
    pts = points.to(torch.float32)
    ok = torch.isfinite(pts).all(dim=-1)
    if valid is not None:
        ok = ok & valid.to(torch.bool)
    row, col, l2 = project_to_pixels(pts, spec)
    pix = torch.where(ok, row * spec.width + col, 0).to(torch.int32)
    key = _sortable_bits(l2)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    intensity = pts[..., 3] if pts.shape[-1] > 3 else torch.zeros_like(x)
    payload = torch.stack([sqrt_f32(x * x + y * y), z, intensity], dim=-1)
    return pix.contiguous(), key.contiguous(), ok.contiguous(), payload.contiguous()


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

