"""Wrapper of the connected-component kernel (`csrc/components.cu`).

Counterpart of `tpufusion/ops/pallas_cc.py::propagate_pallas` as the
decode reaches it through `components.connected_components_with_bbox(
mask, max_iters, cc_impl)`. For a mask on the CPU every `cc_impl` runs the
plain sweeps (`ops/components.py`); for a CUDA mask every `cc_impl` runs
the tiled union-find kernel (32 x 64 tiles, one launch a call at any
height and width with B * H * W < 2^31), or raises. The kernel always
converges, so `max_iters` bounds only the plain version.
"""

from __future__ import annotations

import torch

from tpufusion_torch import _build
from tpufusion_torch.ops import components

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

_IMPLS = ("auto", "pallas", "xla")


def connected_components_with_bbox(
    mask: torch.Tensor,  # (B, H, W) bool
    max_iters: int = 128,
    impl: str = "auto",
):
    """(B, H, W) bool -> (labels, min_x, max_x, min_y, max_y), each
    (B, H, W) int32; labels are flat indices within the frame, -1 on
    background."""
    global LAUNCHES
    if impl not in _IMPLS:
        raise ValueError(f"unknown cc impl {impl!r}")
    if mask.device.type == "cpu":
        return components.connected_components_with_bbox(mask, max_iters)
    if mask.device.type != "cuda":
        raise ValueError(f"mask must be a CPU or CUDA tensor, got {mask.device}")
    if mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, got {mask.dtype}")
    if mask.dim() != 3:
        raise ValueError(f"mask must be (B, H, W), got {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    b, h, w = mask.shape
    if b * h * w >= 2**31:
        raise ValueError(f"B*H*W must fit int32, got {b * h * w}")
    lib = _build.load()
    dev = mask.device
    frame_done = torch.empty(b, dtype=torch.int32, device=dev)
    out = torch.empty((5, b, h, w), dtype=torch.int32, device=dev)  # labels, 4 extents
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_components_with_bbox(
            mask.data_ptr(), frame_done.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), b, h, w, stream,
        )
    _build.check(lib, err, "connected_components_with_bbox")
    LAUNCHES += 1
    return out[0], out[1], out[2], out[3], out[4]


def connected_components(mask: torch.Tensor, max_iters: int = 128, impl: str = "auto"):
    """One (H, W) bool mask -> (H, W) int32 labels, -1 on background. A
    CUDA mask is one kernel launch on a batch of one, at any height; a CPU
    mask runs the plain labels-only sweeps."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown cc impl {impl!r}")
    if mask.dim() != 2:
        raise ValueError(f"mask must be (H, W), got {tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return components.connected_components_reference(mask, max_iters)
    return connected_components_with_bbox(mask[None].contiguous(), max_iters, impl)[0][0]
