"""Range-view projection and per-pixel geometry, box corners and rects,
label codecs, the BEV rasterizer and the camera model; exports the names
of `tpufusion/geometry/__init__.py`."""

from tpufusion_torch.geometry.bev import bev_rasterize
from tpufusion_torch.geometry.boxes import (
    box_corners_3d,
    inner_rect,
    outer_rect,
    project_2d,
    sorted_projected_corners,
)
from tpufusion_torch.geometry.range_view import project_to_pixels, range_view_project

__all__ = [
    "range_view_project",
    "project_to_pixels",
    "bev_rasterize",
    "project_2d",
    "box_corners_3d",
    "sorted_projected_corners",
    "outer_rect",
    "inner_rect",
]
