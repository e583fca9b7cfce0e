"""Wrapper of the connected-component kernel (`csrc/components.cu`).

Counterpart of `tpufusion/ops/pallas_cc.py::propagate_pallas` as the
decode reaches it through `components.connected_components_with_bbox(
mask, max_iters, cc_impl)`. For a mask on the CPU every `cc_impl` runs the
plain sweeps (`ops/components.py`); for a CUDA mask every `cc_impl` runs
the strip-tiled union-find kernel, or raises. The kernel always converges,
so `max_iters` bounds only the plain version. It holds a frame's full
height in one CTA's strip, so it takes at most `MAX_ROWS` rows.
"""

from __future__ import annotations

import torch

from tpufusion_torch import _build
from tpufusion_torch.ops import components

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
MAX_ROWS = 32  # csrc/components.cu kMaxRows
_STRIP = 64  # columns a strip CTA owns (kStrip)
_MERGE_CAPACITY = 5 * _STRIP * MAX_ROWS  # border pairs one CTA merges

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
    if h > MAX_ROWS or (-(-w // _STRIP) - 1) * h > _MERGE_CAPACITY:
        raise ValueError(f"the kernel takes H <= {MAX_ROWS} and W up to "
                         f"{_MERGE_CAPACITY // h + 1} strips, got {(h, w)}")
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
