"""Wrapper of the connected-component kernel (`csrc/components.cu`).

Counterpart of `tpufusion/ops/pallas_cc.py::propagate_pallas` as the
decode reaches it through `components.connected_components_with_bbox(
mask, max_iters, cc_impl)`. For a mask on the CPU every `cc_impl` runs the
plain sweeps (`ops/components.py`); for a CUDA mask every `cc_impl` runs
the union-find kernel, or raises. The kernel always converges, so
`max_iters` bounds only the plain version.
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
    scratch = torch.empty((5, b * h * w), dtype=torch.int32, device=dev)
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    ext = torch.empty((4, b, h, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_components_with_bbox(
            mask.data_ptr(), scratch.data_ptr(), labels.data_ptr(),
            ext.data_ptr(), b, h, w, stream,
        )
    _build.check(lib, err, "connected_components_with_bbox")
    LAUNCHES += 1
    return labels, ext[0], ext[1], ext[2], ext[3]
