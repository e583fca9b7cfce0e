"""Wrapper of the nearest-wins z-buffer kernel (`csrc/nearest_wins.cu`).

Counterpart of `tpufusion/ops/pallas_projection.py::nearest_wins_pallas_batch`
plus the image gather that follows it (`geometry/range_view.py::
_gather_image`). `nearest_wins_image` takes what the range view computed
once in torch — pixel ids, sortable L2 keys, validity, payload — and
returns the (B, H, W, 3) image. For tensors on the CPU it runs the plain
version (`nearest_wins_image_reference`); for CUDA tensors it launches the
kernel (one launch, one 16-CTA cluster a frame), or raises.
"""

from __future__ import annotations

import torch

from tpufusion_torch import _build
from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.ops.scatter import nearest_wins_reference

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)


def gather_image(
    payload: torch.Tensor,  # (B, N, 3) float32
    winner: torch.Tensor,  # (B, P) int32
    occupied: torch.Tensor,  # (B, P) bool
    spec: RangeViewSpec,
) -> torch.Tensor:
    """Winning point indices -> (B, H, W, 3) image with the reference's
    empty-pixel fills (0, min_height, 0)."""
    b = payload.shape[0]
    vals = torch.gather(
        payload, 1, winner.to(torch.int64)[..., None].expand(-1, -1, 3)
    )
    fills = torch.tensor(
        [0.0, spec.min_height, 0.0], dtype=torch.float32, device=payload.device
    )
    img = torch.where(occupied[..., None], vals, fills)
    return img.reshape(b, spec.height, spec.width, 3)


def nearest_wins_image_reference(pix, key_bits, valid, payload, spec):
    """Plain PyTorch version of the kernel: z-buffer, then gather."""
    winner, occupied = nearest_wins_reference(
        pix, key_bits, valid, spec.height * spec.width
    )
    return gather_image(payload, winner, occupied, spec)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nearest_wins_image(
    pix: torch.Tensor,  # (B, N) int32 flat pixel ids, in range where valid
    key_bits: torch.Tensor,  # (B, N) int32 sortable L2 bits
    valid: torch.Tensor,  # (B, N) bool
    payload: torch.Tensor,  # (B, N, 3) float32 (xy range, z, intensity)
    spec: RangeViewSpec,
) -> torch.Tensor:
    """(B, H, W, 3) float32 range-view image; kernel on CUDA tensors."""
    global LAUNCHES
    if pix.device.type == "cpu":
        return nearest_wins_image_reference(pix, key_bits, valid, payload, spec)
    b, n = pix.shape
    p = spec.height * spec.width
    _check("pix", pix, torch.int32, (b, n))
    _check("key_bits", key_bits, torch.int32, (b, n))
    _check("valid", valid, torch.bool, (b, n))
    _check("payload", payload, torch.float32, (b, n, 3))
    if n >= 2**31:
        raise ValueError(f"point count must fit int32, got N={n}")
    for t in (key_bits, valid, payload):
        if t.device != pix.device:
            raise ValueError("all inputs must be on one device")
    lib = _build.load()
    grids = torch.empty((b, p), dtype=torch.int64, device=pix.device)  # the kernel fills it
    img = torch.empty((b, spec.height, spec.width, 3), dtype=torch.float32,
                      device=pix.device)
    with torch.cuda.device(pix.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_nearest_wins_image(
            pix.data_ptr(), key_bits.data_ptr(), valid.data_ptr(),
            payload.data_ptr(), grids.data_ptr(), img.data_ptr(),
            b, n, p, float(spec.min_height), stream,
        )
    _build.check(lib, err, "nearest_wins_image")
    LAUNCHES += 1
    return img
