"""Per-pixel angles, back-projected points and rotations (counterpart of
`tpufusion/geometry/encoding.py::pixel_angles`, `pixel_points` and
`pixel_rotations`).

  theta = (col + X_MIN) * res_h ;  phi = (row + Y_MIN) * res_v
  p     = (d cos theta, -d sin theta, height)
  R     = Rz(theta) @ Ry(phi)

The label codecs wait for the training slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.geometry.boxes import rot_y, rot_z


def pixel_angles(
    spec: RangeViewSpec, device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta, phi), each (H, W) float32."""
    rows = torch.arange(spec.height, dtype=torch.float32, device=device)
    cols = torch.arange(spec.width, dtype=torch.float32, device=device)
    theta = (cols + spec.x_min) * spec.res_h_rad
    phi = (rows + spec.y_min) * spec.res_v_rad
    theta = theta[None, :].expand(spec.height, spec.width)
    phi = phi[:, None].expand(spec.height, spec.width)
    return theta, phi


def pixel_points(image: torch.Tensor, spec: RangeViewSpec) -> torch.Tensor:
    """(..., H, W, >=2) distance/height image -> (..., H, W, 3) points."""
    theta, _ = pixel_angles(spec, image.device)
    d, h = image[..., 0], image[..., 1]
    return torch.stack([d * torch.cos(theta), -d * torch.sin(theta), h], dim=-1)


def pixel_rotations(
    spec: RangeViewSpec, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """R = Rz(theta) @ Ry(phi) per pixel: (H, W, 3, 3) float32."""
    theta, phi = pixel_angles(spec, device)
    return rot_z(theta) @ rot_y(phi)
