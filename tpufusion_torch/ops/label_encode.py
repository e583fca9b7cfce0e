"""Wrappers of the fused label-encode kernels of both heads
(`csrc/label_encode.cu`).

  encode_label         (..., 3) centers and sizes (l, w, h), (...) yaws
                       and a (..., H, W, C >= 2) float32 distance / height
                       image -> the (..., H, W, 26) float32 label of
                       `geometry/encoding.py::encode_label_reference`, its
                       plain version: the one-hot `method` footprint, then
                       the 8 corners' offsets in each pixel's local frame
  encode_direct_label  the same box arrays and image -> the direct head's
                       (..., H, W, 10) label (12 with yaw_frame "both") of
                       `encode_direct_label_reference`: the one-hot
                       surface or rect footprint, the center offset in the
                       pixel's local frame, l w h and the yaw's sin / cos

The port's own kernels: the JAX package computes the encodes in XLA,
outside Pallas (`tpufusion/geometry/encoding.py::encode_label`,
`encode_direct_label`). Each kernel folds its footprint (the corners'
projection with `tf_project_2d`'s arithmetic, the rect or circle; or the
box-frame surface test), the per-pixel rotation and the yaw's sin / cos
into one pass that reads the image once and writes the label once, bit
for bit the plain version on the card. For an image on the CPU a wrapper
runs the plain version; for a CUDA image it launches its kernel once, or
raises.
"""

from __future__ import annotations

import math

import torch

from tpufusion_torch import _build
from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.ops.pixels import _spec_args

LAUNCHES = 0  # corner kernel launches since import (or since a caller reset it)
LAUNCHES_DIRECT = 0  # direct kernel launches, likewise
METHODS = ("outer_rect", "inner_rect", "circle")  # the corner kernel's method codes, in order
FOOTPRINTS = ("surface", "rect")  # the direct kernel's footprint codes, in order
YAW_FRAMES = ("local", "global", "both")  # its yaw_frame codes, in order
CHANNELS = 26

_TRIG: dict = {}


def pixel_trig(spec: RangeViewSpec, device) -> tuple[torch.Tensor, ...]:
    """(cos theta (W,), sin theta (W,), cos phi (H,), sin phi (H,)) float32
    on `device`, as torch's cos and sin give them for the plain version's
    `pixel_angles`; made once a (spec, device) and shared: read them,
    never write them."""
    from tpufusion_torch.geometry.encoding import pixel_angles

    key = (spec, torch.device(device))
    if key not in _TRIG:
        with torch.inference_mode():
            theta, phi = pixel_angles(spec, device=device)
            theta, phi = theta[0], phi[:, 0]
            _TRIG[key] = tuple(f(a).contiguous() for a in (theta, phi) for f in (torch.cos, torch.sin))
    return _TRIG[key]


def pixel_theta(spec: RangeViewSpec, device) -> torch.Tensor:
    """theta (W,) float32 on `device`: the plain version's `pixel_angles`
    row, from which it takes sin / cos(yaw + theta); made once a (spec,
    device) and shared: read it, never write it."""
    from tpufusion_torch.geometry.encoding import pixel_angles

    key = ("theta", spec, torch.device(device))
    if key not in _TRIG:
        with torch.inference_mode():
            _TRIG[key] = pixel_angles(spec, device=device)[0][0].contiguous()
    return _TRIG[key]


def direct_channels(yaw_frame: str) -> int:
    """The direct label's channels: 2 + 8, or 2 + 10 for yaw_frame "both"."""
    return 12 if yaw_frame == "both" else 10


def _card_inputs(center, size, yaw, image: torch.Tensor, spec: RangeViewSpec):
    """Checks a CUDA image and the box arrays for a kernel; returns (the
    leading shape, (center, size, yaw) contiguous float32 on its device)."""
    if image.device.type != "cuda":
        raise ValueError(f"image must be a CPU or CUDA tensor, got {image.device}")
    if image.dtype != torch.float32:
        raise ValueError(f"image must be float32, got {image.dtype}")
    if image.dim() < 3 or tuple(image.shape[-3:-1]) != (spec.height, spec.width) or (
            image.shape[-1] < 2):
        raise ValueError(f"image must be (..., {spec.height}, {spec.width}, C >= 2), got "
                         f"{tuple(image.shape)}")
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    lead = tuple(image.shape[:-3])
    box = []
    for name, v, shape in (("center", center, lead + (3,)), ("size", size, lead + (3,)),
                           ("yaw", yaw, lead)):
        t = torch.as_tensor(v, dtype=torch.float32, device=image.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape} (the image's leading shape), "
                             f"got {tuple(t.shape)}")
        box.append(t.contiguous())
    frames = math.prod(lead)
    if frames >= 2**31:
        raise ValueError(f"frame count must fit int32, got {frames}")
    return lead, box


def encode_label(center, size, yaw, image: torch.Tensor, spec: RangeViewSpec,
                 method: str = "outer_rect") -> torch.Tensor:
    """The corner head's label; the kernel for a CUDA image. The box
    arrays (anything `torch.as_tensor` takes) share the image's leading
    shape; on the card the image is contiguous float32 of the spec's
    height and width."""
    global LAUNCHES
    if method not in METHODS:
        raise ValueError(f"unknown footprint method {method!r}: one of {METHODS}")
    if image.device.type == "cpu":
        from tpufusion_torch.geometry.encoding import encode_label_reference

        return encode_label_reference(center, size, yaw, image, spec, method)
    lead, box = _card_inputs(center, size, yaw, image, spec)
    dev = image.device
    out = torch.empty(lead + (spec.height, spec.width, CHANNELS), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    trig = pixel_trig(spec, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_encode_label(
            *(t.data_ptr() for t in box), image.data_ptr(), image.shape[-1],
            *(t.data_ptr() for t in trig), out.data_ptr(), math.prod(lead),
            METHODS.index(method), *_spec_args(spec), stream,
        )
    _build.check(lib, err, "encode_label")
    LAUNCHES += 1
    return out


def encode_direct_label(center, size, yaw, image: torch.Tensor, spec: RangeViewSpec,
                        footprint: str = "surface", yaw_frame: str = "local") -> torch.Tensor:
    """The direct head's label; the kernel for a CUDA image, with the
    inputs `encode_label` takes. `footprint` and `yaw_frame` are checked
    before anything runs."""
    global LAUNCHES_DIRECT
    if yaw_frame not in YAW_FRAMES:
        raise ValueError(f"unknown yaw_frame {yaw_frame!r}")
    if footprint not in FOOTPRINTS:
        raise ValueError(f"unknown footprint {footprint!r}: one of {FOOTPRINTS}")
    if image.device.type == "cpu":
        from tpufusion_torch.geometry.encoding import encode_direct_label_reference

        return encode_direct_label_reference(center, size, yaw, image, spec, footprint, yaw_frame)
    lead, box = _card_inputs(center, size, yaw, image, spec)
    dev = image.device
    out = torch.empty(lead + (spec.height, spec.width, direct_channels(yaw_frame)),
                      dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    tables = (*pixel_trig(spec, dev), pixel_theta(spec, dev))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_encode_direct_label(
            *(t.data_ptr() for t in box), image.data_ptr(), image.shape[-1],
            *(t.data_ptr() for t in tables), out.data_ptr(), math.prod(lead),
            FOOTPRINTS.index(footprint), YAW_FRAMES.index(yaw_frame), *_spec_args(spec), stream,
        )
    _build.check(lib, err, "encode_direct_label")
    LAUNCHES_DIRECT += 1
    return out
