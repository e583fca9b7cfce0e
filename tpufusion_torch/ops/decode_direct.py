"""Wrapper of the direct head's per-cluster decode kernel
(`csrc/decode_direct.cu`).

  decode_direct_clusters  the CC's labels and extents, the heat mask and
                          `_topk_roots`' lanes (root pixel, found) of a
                          (B, H, W, 10 or 12) float32, bf16 or float16 direct-head
                          output and its (B, H, W, C >= 2) image -> poses
                          (B, k, 7) float32 = (x, y, z, yaw, l, w, h) and
                          found (B, k) bool, zeros where not found: what
                          `decode/decode.py::decode_direct_clusters_reference`,
                          its plain version, computes

The port's own kernel: the JAX package computes this decode in XLA,
outside Pallas (`tpufusion/decode/decode.py::_direct_pose_from_cluster`,
`back_project_2d_to_3d`, `_fit_pose_to_surface`, vmapped by
`decode_batch_direct`). A thread-block cluster of CTAs takes one (frame,
lane), each CTA a raster slice of the cluster's bbox window read once into
shared memory: the weighted sums of the yaw frame, the size and the head's
center, the surface mean, the back-projection's nearest valid pixel, the
push, the consensus, and the Gauss-Newton fit of its gated surface points,
every sum exchanged between the CTAs in a fixed order (the same bits call
to call). Every center but "silhouette" (which needs a quantile,
a sort of each lane's points, and runs the plain version on every
device); every fit boundary and yaw frame. A bf16 or float16 output is
read as it is, by the kernel's instance for its type, which rounds where
the plain version rounds (`decode.py::_direct_pose_from_cluster`). For tensors on the CPU
the wrapper runs the plain version; for CUDA tensors it launches the
kernel once, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpufusion_torch import _build
from tpufusion_torch._precision import low_round
from tpufusion_torch.config import DecodeConfig, RangeViewSpec

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)
CENTERS = ("backproject", "geometric", "surface", "consensus", "head", "fit")  # kernel codes, in order
BOUNDARIES = ("circle", "ellipse", "box")  # a fit arm's boundary codes, in order
YAW_FRAMES = ("local", "global", "auto")  # yaw-frame codes, in order
N_CONSTANTS = 5  # the float32 constants the C entry reads from a host array
# the head outputs the kernel reads, by its code
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

def _arms(cfg: DecodeConfig) -> tuple[tuple[int, float], tuple[int, float]]:
    """The fit's two arms as (boundary code, scale factor): the oriented
    arm's, then the symmetric one's (a lone boundary gives both). The
    factor is float32 as torch rounds the Python number it multiplies
    by: scale * 0.5 for a circle's radius, scale for an ellipse's or a
    box's l and w (each then halved)."""
    def arm(boundary: str, scale: float) -> tuple[int, float]:
        if boundary not in BOUNDARIES:
            raise ValueError(f"unknown fit_boundary {boundary!r}")
        factor = scale * 0.5 if boundary == "circle" else scale
        return BOUNDARIES.index(boundary), float(np.float32(factor))

    if cfg.fit_boundary == "auto":
        return arm(cfg.fit_boundary_oriented, cfg.fit_surface_scale), arm(
            "circle", cfg.fit_symmetric_scale)
    one = arm(cfg.fit_boundary, cfg.fit_surface_scale)
    return one, one


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def decode_direct_clusters(y_pred, images, mask, labels, min_x, max_x, min_y, max_y, root,
                           found, spec: RangeViewSpec, cfg: DecodeConfig, center: str):
    """Poses (B, k, 7) float32 and found (B, k) of each lane's cluster;
    the kernel for CUDA tensors. y_pred (B, H, W, C) float32, bfloat16 or
    float16 (C >= 12 for the auto yaw frame), images (B, H, W, >= 2) float32, mask (B, H, W) bool,
    labels and the four extents (B, H, W) int32 as the CC kernel gives
    them (the extents read at each lane's root), root (B, k) int64, found
    (B, k) bool. "silhouette" is refused: it runs the plain version."""
    global LAUNCHES
    if center not in CENTERS:
        raise ValueError(f"the kernel decodes the centers {CENTERS}, not {center!r} (the "
                         "silhouette center runs decode_direct_clusters_reference)")
    if y_pred.device.type == "cpu":
        from tpufusion_torch.decode.decode import decode_direct_clusters_reference

        return decode_direct_clusters_reference(y_pred, images, mask, labels, min_x, max_x,
                                                min_y, max_y, root, found, spec, cfg, center)
    dev = y_pred.device
    if dev.type != "cuda":
        raise ValueError(f"y_pred must be a CPU or CUDA tensor, got {dev}")
    if cfg.direct_yaw_frame not in YAW_FRAMES:
        raise ValueError(f"unknown direct_yaw_frame {cfg.direct_yaw_frame!r}")
    b, h, w = mask.shape
    channels = y_pred.shape[-1] if y_pred.dim() == 4 else 0
    if channels < 10:
        raise ValueError(f"y_pred must be (B, H, W, C >= 10), got {tuple(y_pred.shape)}")
    if cfg.direct_yaw_frame == "auto" and channels < 12:
        raise ValueError(
            "direct_yaw_frame='auto' needs a dual-codec head "
            "(ModelConfig.yaw_codec='dual', 12-channel output); got "
            f"{channels} channels")
    arms = _arms(cfg) if center == "fit" else ((0, 0.0), (0, 0.0))
    if (h, w) != (spec.height, spec.width):
        raise ValueError(f"the frames must be the spec's {spec.height} x {spec.width}, got "
                         f"{h} x {w}")
    y_pred, images = y_pred.contiguous(), images.contiguous()
    if y_pred.dtype not in DTYPES:
        raise ValueError(f"y_pred must be float32, bfloat16 or float16, got {y_pred.dtype}")
    _check("y_pred", y_pred, y_pred.dtype, (b, h, w, channels), dev)
    if images.dim() != 4 or images.shape[-1] < 2:
        raise ValueError(f"images must be (B, H, W, C >= 2), got {tuple(images.shape)}")
    _check("images", images, torch.float32, (b, h, w, images.shape[-1]), dev)
    _check("mask", mask, torch.bool, (b, h, w), dev)
    for name, t in (("labels", labels), ("min_x", min_x), ("max_x", max_x),
                    ("min_y", min_y), ("max_y", max_y)):
        _check(name, t, torch.int32, (b, h, w), dev)
    k = root.shape[-1] if root.dim() == 2 else 0
    _check("root", root, torch.int64, (b, k), dev)
    _check("found", found, torch.bool, (b, k), dev)
    if b * k >= 2**31 or b * h * w >= 2**31:
        raise ValueError(f"B*k and B*H*W must fit int32, got {b * k} and {b * h * w}")
    poses = torch.empty((b, k, 7), dtype=torch.float32, device=dev)
    good = torch.empty((b, k), dtype=torch.bool, device=dev)
    if b * k == 0:
        return poses, good
    from tpufusion_torch.decode.decode import fit_phi_grid
    from tpufusion_torch.ops.label_encode import pixel_trig

    tables = (*pixel_trig(spec, dev), fit_phi_grid(dev))
    offset = cfg.range_offset if center == "backproject" else 0.0
    # the reference compares the probability with min_prob in y_pred's type
    # (rounded in numpy: a torch op here would count as a host sync)
    min_prob = float(low_round(cfg.min_prob, y_pred.dtype)[0])
    consts = (ctypes.c_float * N_CONSTANTS)(
        min_prob, spec.min_height, offset, arms[0][1], arms[1][1])
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_decode_direct(
            y_pred.data_ptr(), channels, images.data_ptr(), images.shape[-1], mask.data_ptr(),
            labels.data_ptr(), min_x.data_ptr(), max_x.data_ptr(), min_y.data_ptr(),
            max_y.data_ptr(), root.data_ptr(), found.data_ptr(), b, k, h, w,
            *(t.data_ptr() for t in tables), CENTERS.index(center),
            YAW_FRAMES.index(cfg.direct_yaw_frame), cfg.fit_boundary == "auto", arms[0][0],
            arms[1][0], consts, poses.data_ptr(), good.data_ptr(), stream,
            DTYPES.index(y_pred.dtype),
        )
    _build.check(lib, err, "decode_direct_clusters")
    LAUNCHES += 1
    return poses, good


def window_pixels(min_x, max_x, min_y, max_y, root, found) -> torch.Tensor:
    """(B, k) int64: the pixels of each found lane's bbox window (0 where
    not found), the window the kernel walks."""
    ext = [t.reshape(t.shape[0], -1).gather(1, root).long() for t in (min_x, max_x, min_y, max_y)]
    n = (ext[1] - ext[0] + 1) * (ext[3] - ext[2] + 1)
    return torch.where(found, n, 0)


def against_plain(y_pred, images, spec: RangeViewSpec, cfg: DecodeConfig, k: int,
                  adversarial: bool = False) -> dict:
    """The kernel and its plain version on the same lanes of a CUDA
    batch: the heat mask, the CC and the top-k roots once, then
    `lanes_against_plain`. Returns `_golden.direct_kernel_readings` (wide
    windows at its looser limit only where `adversarial`: the inputs of
    `parity_inputs.cluster_inputs`) with "found" (lanes the plain version
    found), "windows" (their largest window) and "repeatable" added."""
    from tpufusion_torch.decode import decode as td

    with torch.inference_mode():
        comps = td._heat_components(y_pred[..., 1], cfg)
        root, found, *_ = td._topk_roots(*comps, cfg, k)
    return lanes_against_plain(y_pred, images, comps, root, found, spec, cfg, adversarial)


def lanes_against_plain(y_pred, images, comps, root, found, spec: RangeViewSpec,
                        cfg: DecodeConfig, adversarial: bool = False) -> dict:
    """The kernel (two calls, one launch each, or AssertionError) and its
    plain version on given lanes: the CC's (mask, labels, 4 extents) and
    the roots and found flags, as `decode_batch_direct` hands them over,
    or made by hand (`parity_inputs.crafted_lanes`). Returns
    `_golden.direct_kernel_readings` with "found", "windows" and
    "repeatable" (the two calls' outputs equal bit for bit) added."""
    from tpufusion_torch._golden import direct_kernel_readings, direct_margins
    from tpufusion_torch.decode import decode as td

    center = cfg.direct_center
    with torch.inference_mode():
        before = LAUNCHES
        got = decode_direct_clusters(y_pred, images, *comps, root, found, spec, cfg, center)
        again = decode_direct_clusters(y_pred, images, *comps, root, found, spec, cfg, center)
        assert LAUNCHES == before + 2, "decode_direct_clusters: not one kernel launch a call"
        repeatable = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                         for a, b in zip(got, again))
        margins: dict = {}
        want = td.decode_direct_clusters_reference(y_pred, images, *comps, root, found, spec,
                                                   cfg, center, margins)
        near = (torch.stack(direct_margins(margins)).amin(dim=0) if margins
                else torch.full(found.shape, float("inf"), device=found.device))
        windows = window_pixels(*comps[2:], root, found)
    out = direct_kernel_readings(*(t.cpu().numpy() for t in (*got, *want, windows, near)),
                                 adversarial)
    out.update(found=int(want[1].sum()), windows=int(windows.max()), repeatable=repeatable)
    out["ok"] = out["ok"] and repeatable
    return out
