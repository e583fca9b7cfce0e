"""Wrapper of the corner head's fused label-encode kernel
(`csrc/label_encode.cu`).

  encode_label  (..., 3) centers and sizes (l, w, h), (...) yaws and a
                (..., H, W, C >= 2) float32 distance / height image ->
                the (..., H, W, 26) float32 label of
                `geometry/encoding.py::encode_label_reference`, its plain
                version: the one-hot `method` footprint, then the 8
                corners' offsets in each pixel's local frame

The port's own kernel: the JAX package computes the encode in XLA,
outside Pallas (`tpufusion/geometry/encoding.py::encode_label`). The
kernel folds the corners' projection (`tf_project_2d`'s arithmetic), the
rect or circle and the per-pixel rotation into one pass that reads the
image once and writes the label once, bit for bit the plain version on
the card. For an image on the CPU it runs the plain version; for a CUDA
image it launches the kernel once, or raises.
"""

from __future__ import annotations

import math

import torch

from tpufusion_torch import _build
from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.ops.pixels import _spec_args

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
METHODS = ("outer_rect", "inner_rect", "circle")  # the kernel's method codes, in order
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
    dev = image.device
    box = {}
    for name, v, shape in (("center", center, lead + (3,)), ("size", size, lead + (3,)),
                           ("yaw", yaw, lead)):
        t = torch.as_tensor(v, dtype=torch.float32, device=dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape} (the image's leading shape), "
                             f"got {tuple(t.shape)}")
        box[name] = t.contiguous()
    out = torch.empty(lead + (spec.height, spec.width, CHANNELS), dtype=torch.float32, device=dev)
    frames = math.prod(lead)
    if frames == 0:
        return out
    if frames >= 2**31:
        raise ValueError(f"frame count must fit int32, got {frames}")
    trig = pixel_trig(spec, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_encode_label(
            box["center"].data_ptr(), box["size"].data_ptr(), box["yaw"].data_ptr(),
            image.data_ptr(), image.shape[-1], *(t.data_ptr() for t in trig), out.data_ptr(),
            frames, METHODS.index(method), *_spec_args(spec), stream,
        )
    _build.check(lib, err, "encode_label")
    LAUNCHES += 1
    return out
