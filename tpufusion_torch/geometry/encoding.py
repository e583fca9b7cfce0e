"""Per-pixel angles, points and rotations, and the label codecs
(counterpart of `tpufusion/geometry/encoding.py`).

  theta = (col + X_MIN) * res_h ;  phi = (row + Y_MIN) * res_v
  p     = (d cos theta, -d sin theta, height)
  R     = Rz(theta) @ Ry(phi)

  encode:  c' = R^T (c - p)      decode:  c = R c' + p

`encode_label` writes the corner head's target over the whole range-view
image (one-hot footprint + 24 local-frame corner offsets; on the card in
one fused kernel, `ops/label_encode.py`),
`decode_corners` inverts it, and `encode_direct_label` writes the
direct-pose head's (center offset, size, sin/cos yaw; on the card in one
fused kernel too). Every codec takes
leading batch axes where the reference uses `vmap`, works on the device
of the image it is given, and applies the per-pixel rotation term by term
in float32 (no matmul: nothing here depends on the process's matmul
precision).
"""

from __future__ import annotations

import torch

from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.geometry.boxes import (
    box_corners_3d,
    circle_rect,
    inner_rect,
    outer_rect,
    project_2d,
    rot_y,
    rot_z,
)
from tpufusion_torch.ops import label_encode

DIRECT_CHANNELS = 8  # dc (3 local-frame), l w h (3), sin yaw, cos yaw
DIRECT_CHANNELS_DUAL = 10  # + global sin/cos pair (yaw_frame="both")


def pixel_angles(
    spec: RangeViewSpec,
    col_start=0,
    width: int | None = None,
    device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta, phi), each (H, W') float32 on `device` (the card unless the
    caller asks for "cpu"). col_start / width select a column window."""
    width = spec.width if width is None else width
    rows = torch.arange(spec.height, dtype=torch.float32, device=device)
    cols = torch.arange(width, dtype=torch.float32, device=device) + col_start
    theta = (cols + spec.x_min) * spec.res_h_rad
    phi = (rows + spec.y_min) * spec.res_v_rad
    theta = theta[None, :].expand(spec.height, width)
    phi = phi[:, None].expand(spec.height, width)
    return theta, phi


def pixel_points(image: torch.Tensor, spec: RangeViewSpec, col_start=0) -> torch.Tensor:
    """(..., H, W', >=2) distance/height image -> (..., H, W', 3) points."""
    theta, _ = pixel_angles(spec, col_start, image.shape[-2], image.device)
    d, h = image[..., 0], image[..., 1]
    return torch.stack([d * torch.cos(theta), -d * torch.sin(theta), h], dim=-1)


def pixel_rotations(
    spec: RangeViewSpec,
    col_start=0,
    width: int | None = None,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """R = Rz(theta) @ Ry(phi) per pixel: (H, W', 3, 3) float32."""
    theta, phi = pixel_angles(spec, col_start, width, device)
    rz, ry = rot_z(theta), rot_y(phi)
    return (rz[..., :, :, None] * ry[..., None, :, :]).sum(dim=-2)


def _to_local(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T v per pixel: rot (H, W, 3, 3), v (..., H, W, K, 3) -> same."""
    r = rot[..., None, :, :]  # (H, W, 1, 3, 3)
    return v[..., 0:1] * r[..., 0, :] + v[..., 1:2] * r[..., 1, :] + v[..., 2:3] * r[..., 2, :]


def _to_world(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R v per pixel: rot (H, W, 3, 3), v (..., H, W, K, 3) -> same."""
    r = rot[..., None, :, :]
    return v[..., 0:1] * r[..., :, 0] + v[..., 1:2] * r[..., :, 1] + v[..., 2:3] * r[..., :, 2]


def _pyslice_mask(lo, hi, n: int, idx: torch.Tensor) -> torch.Tensor:
    """The mask of numpy's arr[lo:hi] over an axis of length n, negative
    indices wrapping (the reference assigns label[ul_y:lr_y, ul_x:lr_x]
    with the raw projected ints). lo, hi (...) -> (..., n)."""
    lo = torch.where(lo < 0, lo + n, lo).clamp(0, n)[..., None]
    hi = torch.where(hi < 0, hi + n, hi).clamp(0, n)[..., None]
    return (idx >= lo) & (idx < hi)


def footprint_mask(
    center, size, yaw, spec: RangeViewSpec, method: str = "outer_rect"
) -> torch.Tensor:
    """(..., H, W) float32 0/1 mask of the classification footprint:
    "outer_rect" (bbox of the 4 projected corners farthest from the
    projected centroid, the training default), "inner_rect" (the 4
    nearest) or "circle" (a disk around the projected centroid painted
    inside the circle rect, with the reference's wrap of negative
    indices)."""
    center = torch.as_tensor(center, dtype=torch.float32)
    dev = center.device
    rows = torch.arange(spec.height, dtype=torch.int32, device=dev)
    cols = torch.arange(spec.width, dtype=torch.int32, device=dev)
    if method == "circle":
        ul_x, ul_y, lr_x, lr_y = circle_rect(center, size, yaw, spec)
        # the reference paints `for x in range(int(ul), int(lr))` into
        # label[y, x]: vx = ul + (c - ul) mod W is the loop value that
        # lands on column c
        ul_xi, lr_xi = ul_x.to(torch.int32)[..., None], lr_x.to(torch.int32)[..., None]
        ul_yi, lr_yi = ul_y.to(torch.int32)[..., None], lr_y.to(torch.int32)[..., None]
        vx = ul_xi + torch.remainder(cols - ul_xi, spec.width)  # (..., W)
        vy = ul_yi + torch.remainder(rows - ul_yi, spec.height)  # (..., H)
        in_rect = (vy < lr_yi)[..., :, None] & (vx < lr_xi)[..., None, :]
        r = torch.minimum(lr_y - ul_y, lr_x - ul_x) / 2.0
        pcol, prow = project_2d(center[..., 0], center[..., 1], center[..., 2], spec)
        dist2 = (
            (vx - pcol[..., None]).to(torch.float32)[..., None, :] ** 2
            + (vy - prow[..., None]).to(torch.float32)[..., :, None] ** 2
        )
        return (in_rect & (dist2 <= (r * r)[..., None, None])).to(torch.float32)
    rect = {"outer_rect": outer_rect, "inner_rect": inner_rect}[method]
    ul_x, ul_y, lr_x, lr_y = rect(center, size, yaw, spec)
    rmask = _pyslice_mask(ul_y, lr_y, spec.height, rows)
    cmask = _pyslice_mask(ul_x, lr_x, spec.width, cols)
    return (rmask[..., :, None] & cmask[..., None, :]).to(torch.float32)


def _physical_center(center: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Rz(yaw) @ center: where the box really is under the orbit-origin
    convention. (..., 3), (...) -> (..., 3)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack(
        [c * center[..., 0] - s * center[..., 1], s * center[..., 0] + c * center[..., 1],
         center[..., 2]], dim=-1)


def _gt(center, size, yaw, image: torch.Tensor):
    as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=image.device)  # noqa: E731
    return as_f32(center), as_f32(size), as_f32(yaw)


def encode_label(
    center,  # (..., 3) tx, ty, tz
    size,  # (..., 3) l, w, h
    yaw,  # (...)
    image: torch.Tensor,  # (..., H, W, >=2) distance/height channels
    spec: RangeViewSpec = RangeViewSpec(),
    method: str = "outer_rect",
) -> torch.Tensor:
    """The corner head's target, (..., H, W, 2 + 24) float32 on the image's
    device: channels 0..1 the one-hot (background, foreground) of the
    `method` footprint, 2..25 the local-frame corner offsets, zero outside
    the footprint. A CUDA image goes through the fused kernel
    (`ops/label_encode.py`: one launch, the box arrays sharing the image's
    leading shape), a CPU one through `encode_label_reference`."""
    return label_encode.encode_label(center, size, yaw, image, spec, method)


def encode_label_reference(
    center, size, yaw, image: torch.Tensor,
    spec: RangeViewSpec = RangeViewSpec(),
    method: str = "outer_rect",
) -> torch.Tensor:
    """Plain PyTorch version of the label-encode kernel: the composition
    of footprint_mask, box_corners_3d, pixel_points and pixel_rotations
    (one project_2d launch on the card)."""
    center, size, yaw = _gt(center, size, yaw, image)
    mask = footprint_mask(center, size, yaw, spec, method)  # (..., H, W)
    corners = box_corners_3d(center, size, yaw)  # (..., 8, 3)
    p = pixel_points(image, spec)  # (..., H, W, 3)
    rot = pixel_rotations(spec, device=image.device)
    diff = corners[..., None, None, :, :] - p[..., None, :]  # (..., H, W, 8, 3)
    reg = _to_local(rot, diff).flatten(-2) * mask[..., None]
    onehot = torch.stack([1.0 - mask, mask], dim=-1)
    return torch.cat([onehot, reg], dim=-1)


def encode_label_batch(centers, sizes, yaws, images, spec: RangeViewSpec) -> torch.Tensor:
    """(B, 3), (B, 3), (B,), (B, H, W, C) -> (B, H, W, 26)."""
    return encode_label(centers, sizes, yaws, images, spec)


def decode_corners(
    reg: torch.Tensor,  # (..., H, W', 24) local-frame corner offsets
    image: torch.Tensor,  # (..., H, W', >=2) distance/height channels
    spec: RangeViewSpec = RangeViewSpec(),
    col_start=0,
) -> torch.Tensor:
    """The inverse of encode_label at every pixel, c = R c' + p:
    (..., H, W', 8, 3) world-frame corners. col_start offsets the azimuth
    when reg / image are a column window of the full view."""
    w = reg.shape[-2]
    c_prime = reg.unflatten(-1, (8, 3))
    p = pixel_points(image, spec, col_start)
    rot = pixel_rotations(spec, col_start, w, reg.device)
    return _to_world(rot, c_prime) + p[..., None, :]


def box_surface_mask(
    center, size, yaw, image: torch.Tensor,
    spec: RangeViewSpec = RangeViewSpec(), margin: float = 0.25,
) -> torch.Tensor:
    """(..., H, W) float32 mask of the occupied pixels whose return lies
    inside the box dilated by `margin`: each pixel's point is taken into
    the box frame and tested for containment. The direct head trains on
    this surface, where the outer rect degenerates on oblique views."""
    center, size, yaw = _gt(center, size, yaw, image)
    c, s = torch.cos(yaw)[..., None, None], torch.sin(yaw)[..., None, None]
    rel = pixel_points(image, spec) - _physical_center(center, yaw)[..., None, None, :]
    qx = c * rel[..., 0] + s * rel[..., 1]
    qy = -s * rel[..., 0] + c * rel[..., 1]
    half = (size / 2.0 + margin)[..., None, None, :]
    inside = (
        (qx.abs() <= half[..., 0]) & (qy.abs() <= half[..., 1])
        & (rel[..., 2].abs() <= half[..., 2])
    )
    return (inside & (image[..., 0] > 0)).to(torch.float32)


def encode_direct_label(
    center, size, yaw, image: torch.Tensor,
    spec: RangeViewSpec = RangeViewSpec(),
    footprint: str = "surface",
    yaw_frame: str = "local",
) -> torch.Tensor:
    """The direct head's target, (..., H, W, 2 + 8): [bkg, fg, dc (3), lwh
    (3), sin yaw, cos yaw] (yaw_frame="both": 2 + 10, the local pair then
    the global pair).

    dc = R^T (c_phys - p) in the pixel's local frame, c_phys = Rz(yaw) @
    center. yaw_frame="local" supervises sin/cos(yaw + theta), the yaw
    relative to the pixel's ray (the image's column axis mirrors world
    azimuth, so the ray's azimuth is -theta); "global" the raw
    sin/cos(yaw). footprint="surface" paints the foreground on the box's
    surface returns (box_surface_mask), "rect" on the outer rect. A CUDA
    image goes through the fused kernel (`ops/label_encode.py`: one
    launch, the box arrays sharing the image's leading shape), a CPU one
    through `encode_direct_label_reference`; an unknown footprint or
    yaw_frame raises ValueError."""
    return label_encode.encode_direct_label(center, size, yaw, image, spec, footprint, yaw_frame)


def encode_direct_label_reference(
    center, size, yaw, image: torch.Tensor,
    spec: RangeViewSpec = RangeViewSpec(),
    footprint: str = "surface",
    yaw_frame: str = "local",
) -> torch.Tensor:
    """Plain PyTorch version of the direct label-encode kernel: the
    composition of box_surface_mask (or footprint_mask's outer rect, for
    any footprint other than "surface"), pixel_points, pixel_rotations and
    pixel_angles (one project_2d launch on the card for the rect)."""
    if yaw_frame not in ("local", "global", "both"):
        raise ValueError(f"unknown yaw_frame {yaw_frame!r}")
    center, size, yaw = _gt(center, size, yaw, image)
    if footprint == "surface":
        mask = box_surface_mask(center, size, yaw, image, spec)
    else:
        mask = footprint_mask(center, size, yaw, spec)
    p = pixel_points(image, spec)  # (..., H, W, 3)
    rot = pixel_rotations(spec, device=image.device)
    c_phys = _physical_center(center, yaw)[..., None, None, :]
    dc = _to_local(rot, (c_phys - p)[..., None, :])[..., 0, :]  # (..., H, W, 3)
    hw = mask.shape
    lwh = size[..., None, None, :].expand(*hw, 3)
    yaw_px = yaw[..., None, None]
    pairs = []
    if yaw_frame in ("local", "both"):
        theta, _ = pixel_angles(spec, device=image.device)
        pairs += [torch.sin(yaw_px + theta), torch.cos(yaw_px + theta)]
    if yaw_frame in ("global", "both"):
        pairs += [torch.sin(yaw_px).expand(hw), torch.cos(yaw_px).expand(hw)]
    reg = torch.cat([dc, lwh, torch.stack(pairs, dim=-1)], dim=-1) * mask[..., None]
    onehot = torch.stack([1.0 - mask, mask], dim=-1)
    return torch.cat([onehot, reg], dim=-1)


def encode_direct_label_batch(
    centers, sizes, yaws, images, spec,
    footprint: str = "surface", yaw_frame: str = "local",
) -> torch.Tensor:
    """(B, 3), (B, 3), (B,), (B, H, W, C) -> (B, H, W, 10 or 12)."""
    return encode_direct_label(centers, sizes, yaws, images, spec, footprint, yaw_frame)
