"""3D box corners and their projection into the range view (counterpart
of `tpufusion/geometry/boxes.py`):

  * rot_z, rot_y: rotation matrices
  * box_corners_3d: the 8-corner template rotated by yaw about the sensor
    origin (the reference's orbit-origin convention, which the decode
    inverts)
  * project_2d: 3D -> (col, row) with truncation toward zero, the row
    clamped and flipped, the column not clamped
  * sorted_projected_corners: the corners ordered by 2D distance from the
    projected centroid (stable argsort)
  * inner_rect / outer_rect / circle_rect: bbox of the 4 nearest / 4
    farthest corners, and the square inside the inner rect

Every function takes leading batch axes where the reference uses `vmap`.
The rect edges are integers cut from float trigonometry, so the order of
the float operations is the reference's: the rotation is written out
term by term (no matmul, no fused multiply-add), the norm goes through
`sqrt_f32`, and the divisors are tensors (a Python-number divisor becomes
a multiplication by its reciprocal on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.geometry.range_view import sqrt_f32

# corner template signs in (l, w, h) halves, in the reference's order
_CORNER_SIGNS = np.array(
    [
        [-1, +1, +1],
        [-1, +1, -1],
        [-1, -1, +1],
        [-1, -1, -1],
        [+1, +1, +1],
        [+1, +1, -1],
        [+1, -1, +1],
        [+1, -1, -1],
    ],
    dtype=np.float32,
)


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    """(...) angles -> (..., 3, 3) rotations about z."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, z], -1),
            torch.stack([s, c, z], -1),
            torch.stack([z, z, o], -1),
        ],
        -2,
    )


def rot_y(angle: torch.Tensor) -> torch.Tensor:
    """(...) angles -> (..., 3, 3) rotations about y."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, z, s], -1),
            torch.stack([z, o, z], -1),
            torch.stack([-s, z, c], -1),
        ],
        -2,
    )


def _f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on like's device, made by a fill: a copy of a
    host number to the card would make the host wait for the card."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _corner_signs(device) -> torch.Tensor:
    """_CORNER_SIGNS on `device`, computed there (no host copy)."""
    k = torch.arange(8, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    return torch.stack(
        [torch.where(k < 4, -one, one), torch.where(k % 4 < 2, one, -one),
         torch.where(k % 2 == 0, one, -one)], dim=-1)


def box_corners_3d(center, size, yaw) -> torch.Tensor:
    """(..., 3) center, (..., 3) size (l, w, h), (...) yaw -> (..., 8, 3).

    The whole corner (center offset included) is rotated by Rz(yaw): the
    box orbits the sensor origin, not its own center."""
    center = _f32(center)
    size, yaw = _f32(size, center), _f32(yaw, center)
    signs = _corner_signs(center.device)
    corners = center[..., None, :] + size[..., None, :] * signs / 2.0  # (..., 8, 3)
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    x, y, z = corners.unbind(-1)
    return torch.stack([c * x - s * y, s * x + c * y, z], dim=-1)


def project_2d(tx, ty, tz, spec: RangeViewSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Elementwise 3D -> (col, row) int32: truncation toward zero, the row
    clamped to [0, y_max] and flipped, the column left as it falls."""
    tx = _f32(tx)
    ty, tz = _f32(ty, tx), _f32(tz, tx)
    l2 = sqrt_f32(tx * tx + ty * ty + tz * tz)
    res_h, res_v = _scalar(spec.res_h_rad, tx), _scalar(spec.res_v_rad, tx)
    col = torch.trunc(torch.atan2(-ty, tx) / res_h - spec.x_min).to(torch.int32)
    ratio = torch.where(l2 > 0, tz / torch.clamp(l2, min=1e-12), 0.0)
    row = torch.trunc(torch.asin(ratio) / res_v - spec.y_min).to(torch.int32)
    row = spec.y_max - torch.clamp(row, 0, spec.y_max)
    return col, row


def sorted_projected_corners(center, size, yaw, spec: RangeViewSpec) -> torch.Tensor:
    """The 8 projected corners sorted by 2D distance to the projected
    centroid (stable, as numpy sorts): (..., 8, 2) int32 [col, row]."""
    center = _f32(center)
    corners = box_corners_3d(center, size, yaw)
    ccol, crow = project_2d(corners[..., 0], corners[..., 1], corners[..., 2], spec)
    pcol, prow = project_2d(center[..., 0], center[..., 1], center[..., 2], spec)
    d = sqrt_f32(
        (ccol - pcol[..., None]).to(torch.float32) ** 2
        + (crow - prow[..., None]).to(torch.float32) ** 2
    )
    order = torch.argsort(d, dim=-1, stable=True)
    both = torch.stack([ccol, crow], dim=-1)
    return torch.gather(both, -2, order[..., None].expand(both.shape))


def _rect_of(corners2d: torch.Tensor):
    ul = corners2d.amin(dim=-2)
    lr = corners2d.amax(dim=-2)
    return ul[..., 0], ul[..., 1], lr[..., 0], lr[..., 1]  # ul_col, ul_row, lr_col, lr_row


def inner_rect(center, size, yaw, spec: RangeViewSpec):
    """bbox of the 4 corners nearest the projected centroid."""
    return _rect_of(sorted_projected_corners(center, size, yaw, spec)[..., :4, :])


def outer_rect(center, size, yaw, spec: RangeViewSpec):
    """bbox of the 4 corners farthest from the projected centroid."""
    return _rect_of(sorted_projected_corners(center, size, yaw, spec)[..., -4:, :])


def circle_rect(center, size, yaw, spec: RangeViewSpec):
    """The square of side min(inner-rect dims) centered on the inner rect,
    as float bounds (the reference truncates only when it paints)."""
    ul_x, ul_y, lr_x, lr_y = inner_rect(center, size, yaw, spec)
    dim_x = (lr_x - ul_x).to(torch.float32)
    dim_y = (lr_y - ul_y).to(torch.float32)
    r = torch.minimum(dim_x, dim_y)
    cx = ul_x.to(torch.float32) + dim_x / 2
    cy = ul_y.to(torch.float32) + dim_y / 2
    return cx - r / 2, cy - r / 2, cx + r / 2, cy + r / 2
