"""Wrapper of the corner head's vote kernel (`csrc/corner_vote.cu`).

  corner_vote_lanes  a (B, H, W, 26) corner-head output, its (B, H, W,
                     C >= 2) image, each lane's bbox (B, n, 4) [l, t, r,
                     b] and 3D centroid (B, n, 3), and the lanes to vote
                     (B, n) bool or None for all -> pose (B, n, 7), box
                     (B, n, 8, 3), ok (B, n), overflow (B, n): what
                     `decode/decode.py::corner_vote_reference`, its plain
                     version, computes on the voted lanes, and zeros and
                     False on the others

The port's own kernel: the JAX package computes the vote in XLA, outside
Pallas (`tpufusion/decode/decode.py::corner_vote`, vmapped by
`decode_frame`, `decode_frame_multi`, `decode_batch` and
`decode_batch_multi`). Three launches: each frame's rows and columns that
hold a positive; each lane's candidates (the window's positive columns x
its positive rows, in the reference's column-major order), their corners
and their neighbour counts in the Gram form, tiled through shared memory
(no (K, K) array); each lane's winners and pose. For tensors on the CPU
the wrapper runs the plain version; for CUDA tensors it launches the
kernel, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpufusion_torch import _build
from tpufusion_torch.config import DecodeConfig, RangeViewSpec

LAUNCHES = 0  # calls that launched the kernel since import (or since a caller reset it)
N_CONSTANTS = 6  # min_prob, far_delta (3), the count thresholds 1e-9 and max_bbox_dist^2
MAX_SHARED = 200 * 1024  # the counts kernel's shared bytes: its tiles and the lane's lists
TILE = 64  # csrc/corner_vote.cu kTile: candidates a tile
CHUNK = 256  # csrc/corner_vote.cu kThreads: columns a has-pos CTA


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def shared_bytes(height: int, width: int) -> int:
    """The counts kernel's shared memory: two tiles of 24 coordinates,
    sq and validity, the lane's lists of columns and rows."""
    return 2 * TILE * (24 + 2) * 4 + 4 * (width + height) + 64


def corner_vote_lanes(y_pred, image, bbox, centroid_3d, lanes, spec: RangeViewSpec,
                      cfg: DecodeConfig):
    """(pose (B, n, 7), box (B, n, 8, 3), ok (B, n), overflow (B, n)) of
    each lane's vote; the kernel for CUDA tensors (zeros and False on the
    lanes `lanes` leaves out), the plain version, every lane, on the CPU.
    y_pred (B, H, W, >= 26) float32 (another float type is converted, as
    the plain version reads it), image (B, H, W, >= 2) float32, bbox (B,
    n, 4) integer, centroid_3d (B, n, 3) float32, lanes (B, n) bool or
    None."""
    if y_pred.device.type == "cpu":
        from tpufusion_torch.decode.decode import corner_vote_reference

        return corner_vote_reference(y_pred.to(torch.float32), image, bbox, centroid_3d, spec,
                                     cfg)
    return launch(y_pred, image, bbox, centroid_3d, lanes, spec, cfg)[:4]


def launch(y_pred, image, bbox, centroid_3d, lanes, spec: RangeViewSpec, cfg: DecodeConfig):
    """The kernel on CUDA tensors: (pose, box, ok, overflow, counts (B, n,
    K) int32, each real slot's neighbour count or -1 where it is not
    valid; past the lane's candidates the entries are not written)."""
    global LAUNCHES
    dev = y_pred.device
    if dev.type != "cuda":
        raise ValueError(f"y_pred must be a CPU or CUDA tensor, got {dev}")
    if y_pred.dim() != 4 or y_pred.shape[-1] < 26:
        raise ValueError(f"y_pred must be (B, H, W, C >= 26), got {tuple(y_pred.shape)}")
    b, h, w, channels = y_pred.shape
    if (h, w) != (spec.height, spec.width):
        raise ValueError(f"the frames must be the spec's {spec.height} x {spec.width}, got "
                         f"{h} x {w}")
    if not y_pred.is_floating_point():
        raise ValueError(f"y_pred must be a float tensor, got {y_pred.dtype}")
    y_pred = y_pred.to(torch.float32).contiguous()
    if image.dim() != 4 or image.shape[-1] < 2:
        raise ValueError(f"image must be (B, H, W, C >= 2), got {tuple(image.shape)}")
    image = image.contiguous()
    _check("image", image, torch.float32, (b, h, w, image.shape[-1]), dev)
    if bbox.dim() != 3 or bbox.shape[-1] != 4 or bbox.is_floating_point():
        raise ValueError(f"bbox must be an integer (B, n, 4) tensor, got {bbox.dtype} "
                         f"{tuple(bbox.shape)}")
    bbox = bbox.to(torch.int64).contiguous()
    n = bbox.shape[1]
    _check("bbox", bbox, torch.int64, (b, n, 4), dev)
    centroid_3d = centroid_3d.contiguous()
    _check("centroid_3d", centroid_3d, torch.float32, (b, n, 3), dev)
    if lanes is None:
        lanes = torch.ones((b, n), dtype=torch.bool, device=dev)
    lanes = lanes.contiguous()
    _check("lanes", lanes, torch.bool, (b, n), dev)
    if b * h * w * channels >= 2**31 or b * n >= 2**31:
        raise ValueError(f"B*H*W*C and B*n must fit int32, got {b * h * w * channels}, {b * n}")
    smem = shared_bytes(h, w)
    if smem > MAX_SHARED:
        raise ValueError(f"a {h} x {w} frame needs {smem} B of shared memory a CTA, over "
                         f"{MAX_SHARED}")
    k = min(cfg.max_candidates, h * w)
    pose = torch.empty((b, n, 7), dtype=torch.float32, device=dev)
    box = torch.empty((b, n, 8, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((b, n), dtype=torch.bool, device=dev)
    overflow = torch.empty((b, n), dtype=torch.bool, device=dev)
    counts = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    if b * n == 0:
        return pose, box, ok, overflow, counts
    from tpufusion_torch.ops.label_encode import pixel_trig

    chunks, words = -(-w // CHUNK), -(-h // 32)
    col_has = torch.empty((b, w), dtype=torch.uint8, device=dev)
    row_bits = torch.empty((b, chunks, words), dtype=torch.int32, device=dev)
    corners = torch.empty((b, n, k, 24), dtype=torch.float32, device=dev)
    lane_info = torch.empty((b, n, 2), dtype=torch.int32, device=dev)
    f32 = np.float32
    consts = (ctypes.c_float * N_CONSTANTS)(
        f32(cfg.min_prob), *(f32(d) for d in cfg.far_delta), f32(1e-9),
        f32(cfg.max_bbox_dist**2))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_corner_vote(
            y_pred.data_ptr(), channels, image.data_ptr(), image.shape[-1], bbox.data_ptr(),
            centroid_3d.data_ptr(), lanes.data_ptr(),
            *(t.data_ptr() for t in pixel_trig(spec, dev)), b, n, h, w, k, cfg.margin_x,
            cfg.margin_y, consts, col_has.data_ptr(), row_bits.data_ptr(), counts.data_ptr(),
            corners.data_ptr(), lane_info.data_ptr(), pose.data_ptr(), box.data_ptr(),
            ok.data_ptr(), overflow.data_ptr(), stream,
        )
    _build.check(lib, err, "corner_vote_lanes")
    LAUNCHES += 1
    return pose, box, ok, overflow, counts


def corner_lanes(y_pred, images, spec: RangeViewSpec, cfg: DecodeConfig, k: int):
    """The lanes a corner decode votes, as `decode_batch` (k = 1) and
    `decode_batch_multi` hand them to the wrapper: (bbox (B, k, 4),
    centroid_3d (B, k, 3), stage2 (B, k))."""
    from tpufusion_torch.decode import decode as td

    centroids, bboxes, _, founds = td._find_obstacles_topk_batch(y_pred[..., 1], cfg, k)
    _, stage2, xyz = td._corner_stages(images, centroids, bboxes, founds, spec, cfg)
    return bboxes, xyz, stage2


def against_plain(y_pred, images, bbox, centroid_3d, lanes, spec: RangeViewSpec,
                  cfg: DecodeConfig) -> dict:
    """The kernel (one launch, or AssertionError) and its plain version on
    the same lanes of a CUDA batch: `_golden.corner_kernel_readings`, with
    "overflow" (voted lanes over the budget) and "candidates" (the most a
    voted lane had) added."""
    from tpufusion_torch._golden import corner_kernel_readings
    from tpufusion_torch.decode.decode import _corner_pose, corner_vote_reference

    names = ("pose", "box", "ok", "overflow", "counts")
    with torch.inference_mode():
        before = LAUNCHES
        got = dict(zip(names, launch(y_pred, images, bbox, centroid_3d, lanes, spec, cfg)))
        assert LAUNCHES == before + 1, "corner_vote_lanes: not one kernel launch"
        got["box_pose"] = _corner_pose(got["box"])
        readings: dict = {}
        want = dict(zip(names, corner_vote_reference(y_pred.float(), images, bbox, centroid_3d,
                                                     spec, cfg, readings)))
        want["counts"] = readings["counts"]
    voted = np.ones(tuple(bbox.shape[:2]), bool) if lanes is None else lanes.cpu().numpy()
    numpy = {k: v.cpu().numpy() for k, v in readings.items()}
    out = corner_kernel_readings({k: v.cpu().numpy() for k, v in got.items()},
                                 {k: v.cpu().numpy() for k, v in want.items()}, numpy, voted)
    k = min(cfg.max_candidates, y_pred.shape[1] * y_pred.shape[2])
    out.update(overflow=int((numpy["total"] > k)[voted].sum()),
               candidates=int(numpy["total"][voted].max(initial=0)))
    return out
