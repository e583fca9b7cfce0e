"""Wrapper of the range view's pixel kernel (`csrc/pixels.cu`) and its
plain versions.

The port's own kernel: the JAX package computes this arithmetic in XLA,
outside Pallas (`tpufusion/geometry/range_view.py::project_to_pixels` and
`_frame_pixels_keys`, `tpufusion/geometry/boxes.py::project_2d`). It runs
on the card so that the card's pixels equal eager JAX's bit for bit:
fdlibm's float atan2 and XLA's asin expansion (`ops/libm_f32.py`), IEEE
division by the float32 resolutions, no FMA contraction, subnormals
flushed as XLA's CPU code flushes them.

  project_points  (B, N, C >= 3) float32 points [+ (B, N) bool valid] ->
                  pix (B, N) int32, key_bits (B, N) int32, ok (B, N) bool,
                  payload (B, N, 3) float32: the z-buffer's four inputs
  project_2d      elementwise float32 (x, y, z) -> (col, row) int32

For tensors on the CPU each runs its plain version (`*_reference`); for
CUDA tensors it launches the kernel, or raises.

A point is ok when all C channels are finite and `valid` holds. A point
that is not ok gets pixel 0, key INT32_MAX (never a winner; JAX's
`_frame_pixels_keys` sets the same) and a payload of zeros, so that every
output is defined, element for element, whatever the point holds.
"""

from __future__ import annotations

import torch

from tpufusion_torch import _build
from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.ops.libm_f32 import (
    asin_f32,
    atan2_f32,
    const_f32,
    div_f32,
    ftz_f32,
    neg_f32,
    sqrt_f32,
)

LAUNCHES = 0  # project_points kernel launches since import (or since a caller reset it)
LAUNCHES_2D = 0  # project_2d kernel launches
INT32_MAX = 2**31 - 1
L2_FLOOR = 1e-12  # the reference's jnp.maximum(l2, 1e-12) before z / l2


def view_angles(x, y, z, spec: RangeViewSpec):
    """Float32 (x, y, z) -> (azimuth pixel, elevation pixel, L2 norm) as
    eager JAX computes them, before truncation:

      l2 = sqrt((x*x + y*y) + z*z)
      az = atan2(-y, x) / res_h - x_min
      el = asin(l2 > 0 ? z / max(l2, 1e-12) : 0) / res_v - y_min
    """
    xd, yd, zd = ftz_f32(x), ftz_f32(y), ftz_f32(z)
    l2 = sqrt_f32(_square(xd) + _square(yd) + _square(zd))
    az = div_f32(atan2_f32(neg_f32(y), x), const_f32(spec.res_h_rad, x)) - const_f32(spec.x_min, x)
    ratio = torch.where(l2 > 0, div_f32(zd, torch.maximum(l2, const_f32(L2_FLOOR, x))), const_f32(0.0, x))
    el = asin_f32(ratio) / const_f32(spec.res_v_rad, x) - const_f32(spec.y_min, x)
    return az, el, l2


def _square(v: torch.Tensor) -> torch.Tensor:
    """v * v of a flushed v, flushed: a coordinate under 2^-63 squares to
    a subnormal. A sum of two flushed squares is 0 or normal; the
    other results here are 0 or normal whatever the point
    (`ops/libm_f32.py`)."""
    return ftz_f32(v * v)


def trunc_i32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 toward zero as XLA converts and the card's
    `cvt.rzi.s32.f32` does: NaN to 0, out-of-range values saturated."""
    inside = torch.where(v == v, torch.clamp(v, -(2.0**31), 2147483520.0), 0.0)
    return torch.where(v >= 2.0**31, INT32_MAX, inside.to(torch.int32))


def project_points_reference(points: torch.Tensor, valid: torch.Tensor | None,
                             spec: RangeViewSpec):
    """Plain PyTorch version of `tf_project_points`."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    az, el, l2 = view_angles(x, y, z, spec)
    col = torch.remainder(trunc_i32(az), spec.width)
    row = spec.y_max - torch.remainder(trunc_i32(el), spec.height)
    ok = torch.isfinite(points).all(dim=-1)
    if valid is not None:
        ok = ok & valid
    pix = torch.where(ok, row * spec.width + col, 0).to(torch.int32)
    key = torch.where(ok, l2.view(torch.int32), INT32_MAX)
    rho = sqrt_f32(_square(ftz_f32(x)) + _square(ftz_f32(y)))
    intensity = points[..., 3] if points.shape[-1] > 3 else torch.zeros_like(x)
    payload = torch.where(ok[..., None], torch.stack([rho, z, intensity], dim=-1), 0.0)
    return pix, key, ok, payload


def project_2d_reference(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                         spec: RangeViewSpec):
    """Plain PyTorch version of `tf_project_2d`: (col, row) int32, the row
    clamped to [0, y_max] and flipped, the column left as it falls."""
    az, el, _ = view_angles(x, y, z, spec)
    row = torch.clamp(trunc_i32(el), 0, spec.y_max)
    return trunc_i32(az), spec.y_max - row


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError("all inputs must be on one device")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _spec_args(spec: RangeViewSpec):
    return (float(spec.res_h_rad), float(spec.x_min), float(spec.res_v_rad),
            float(spec.y_min), spec.width, spec.height, spec.y_max)


def project_points(points: torch.Tensor, valid: torch.Tensor | None, spec: RangeViewSpec):
    """(B, N, C >= 3) float32 points [+ (B, N) bool valid] -> (pix, key_bits,
    ok, payload); the kernel on CUDA tensors."""
    global LAUNCHES
    if points.device.type == "cpu":
        return project_points_reference(points, valid, spec)
    if points.dim() != 3 or points.shape[-1] < 3:
        raise ValueError(f"points must be (B, N, C >= 3), got {tuple(points.shape)}")
    b, n, c = points.shape
    _check("points", points, torch.float32, (b, n, c), points.device)
    if valid is not None:
        _check("valid", valid, torch.bool, (b, n), points.device)
    if n >= 2**31:
        raise ValueError(f"point count must fit int32, got N={n}")
    dev = points.device
    pix = torch.empty((b, n), dtype=torch.int32, device=dev)
    key = torch.empty((b, n), dtype=torch.int32, device=dev)
    ok = torch.empty((b, n), dtype=torch.bool, device=dev)
    payload = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    if b * n == 0:
        return pix, key, ok, payload
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_project_points(
            points.data_ptr(), None if valid is None else valid.data_ptr(),
            pix.data_ptr(), key.data_ptr(), ok.data_ptr(), payload.data_ptr(),
            b * n, c, *_spec_args(spec), stream,
        )
    _build.check(lib, err, "project_points")
    LAUNCHES += 1
    return pix, key, ok, payload


def project_2d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, spec: RangeViewSpec):
    """Elementwise float32 (x, y, z) of one shape -> (col, row) int32; the
    kernel on CUDA tensors."""
    global LAUNCHES_2D
    if x.device.type == "cpu":
        return project_2d_reference(x, y, z, spec)
    for name, t in (("x", x), ("y", y), ("z", z)):
        _check(name, t, torch.float32, x.shape, x.device)
    n = x.numel()
    col = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    row = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if n == 0:
        return col, row
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_project_2d(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), col.data_ptr(), row.data_ptr(),
            n, *_spec_args(spec), stream,
        )
    _build.check(lib, err, "project_2d")
    LAUNCHES_2D += 1
    return col, row
