"""Rotation matrices (counterpart of `tpufusion/geometry/boxes.py::rot_z`
and `rot_y`). The corner template, projection and footprint rects wait
for the training slice (ROADMAP Queue 1)."""

from __future__ import annotations

import torch


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
