"""Pose decode: the direct, corner and top-K decodes, over a batch and
over one frame; exports the names of `tpufusion/decode/__init__.py`."""

from tpufusion_torch.decode.decode import (
    back_project_2d_to_3d,
    corner_vote,
    decode_batch,
    decode_batch_multi,
    decode_frame,
    decode_frame_multi,
    find_obstacle,
    find_obstacles_topk,
)

__all__ = [
    "find_obstacle",
    "find_obstacles_topk",
    "back_project_2d_to_3d",
    "corner_vote",
    "decode_frame",
    "decode_frame_multi",
    "decode_batch",
    "decode_batch_multi",
]
