"""Wrapper of the corner head's vote kernel (`csrc/corner_vote.cu`).

  corner_vote_lanes  a (B, H, W, 26) corner-head output, its (B, H, W,
                     C >= 2) image, each lane's bbox (B, n, 4) [l, t, r,
                     b] and 3D centroid (B, n, 3), the lanes to vote
                     (B, n) bool or None for all, and the (B, H, W) bool
                     positives map the decode's heat mask was stamped
                     from (or None: made here) -> pose (B, n, 7), box
                     (B, n, 8, 3), ok (B, n), overflow (B, n): what
                     `decode/decode.py::corner_vote_reference`, its plain
                     version, computes on the voted lanes, and zeros and
                     False on the others

The port's own kernel: the JAX package computes the vote in XLA, outside
Pallas (`tpufusion/decode/decode.py::corner_vote`, vmapped by
`decode_frame`, `decode_frame_multi`, `decode_batch` and
`decode_batch_multi`). Two launches: each frame with a voting lane reads
the positives map (1 B a pixel) for its rows and columns that hold a
positive, compacts each voting lane's window columns and rows and inverts
each of its candidates (the window's positive columns x its positive
rows, in the reference's column-major order) once, into tiles of 64 (a
frame with no voting lane reads nothing); then each lane's neighbour
counts in the Gram form, tile by tile through shared memory (no (K, K)
array), and, in the lane's last CTA to finish, its winners and pose. For tensors on the CPU the
wrapper runs the plain version; for CUDA tensors it launches the kernel,
or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpufusion_torch import _build
from tpufusion_torch.config import DecodeConfig, RangeViewSpec

LAUNCHES = 0  # calls that launched the kernel since import (or since a caller reset it)
N_CONSTANTS = 5  # far_delta (3), the count thresholds 1e-9 and max_bbox_dist^2
MAX_SHARED = 227 * 1024  # the lists kernel's dynamic shared memory: a frame's flags
MAX_LANES = 1024  # csrc/corner_vote.cu kListThreads: lanes a frame
TILE = 64  # csrc/corner_vote.cu kTile: candidates a tile
INFO = 5  # csrc/corner_vote.cu kInfo: a lane's n_c, total, |C|, |R|, done counter


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def shared_bytes(height: int, width: int) -> int:
    """The lists kernel's shared memory: a frame's row flags (a bit a row)
    and column flags (a byte a column)."""
    return 4 * -(-height // 32) + width


def corner_vote_lanes(y_pred, image, bbox, centroid_3d, lanes, spec: RangeViewSpec,
                      cfg: DecodeConfig, positives=None):
    """(pose (B, n, 7), box (B, n, 8, 3), ok (B, n), overflow (B, n)) of
    each lane's vote; the kernel for CUDA tensors (zeros and False on the
    lanes `lanes` leaves out), the plain version, every lane, on the CPU.
    y_pred (B, H, W, >= 26) float32 (another float type is converted, as
    the plain version reads it), image (B, H, W, >= 2) float32, bbox (B,
    n, 4) integer, centroid_3d (B, n, 3) float32, lanes (B, n) bool or
    None, positives (B, H, W) bool, `decode._positives` of y_pred's
    channel 1, or None to make it here."""
    if y_pred.device.type == "cpu":
        from tpufusion_torch.decode.decode import corner_vote_reference

        return corner_vote_reference(y_pred, image, bbox, centroid_3d, spec, cfg)
    return launch(y_pred, image, bbox, centroid_3d, lanes, spec, cfg, positives)[:4]


def launch(y_pred, image, bbox, centroid_3d, lanes, spec: RangeViewSpec, cfg: DecodeConfig,
           positives=None):
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
    if positives is None:
        from tpufusion_torch.decode.decode import _positives

        positives = _positives(y_pred[..., 1], cfg)
    positives = positives.contiguous()
    _check("positives", positives, torch.bool, (b, h, w), dev)
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
    if lanes is not None:  # None: every lane votes (a null pointer to the kernel)
        lanes = lanes.contiguous()
        _check("lanes", lanes, torch.bool, (b, n), dev)
    if b * h * w * channels >= 2**31 or b * n >= 2**31:
        raise ValueError(f"B*H*W*C and B*n must fit int32, got {b * h * w * channels}, {b * n}")
    smem = shared_bytes(h, w)
    if smem > MAX_SHARED or n > MAX_LANES:
        raise ValueError(f"a {h} x {w} frame needs {smem} B of shared memory a CTA (at most "
                         f"{MAX_SHARED}), and a frame at most {MAX_LANES} lanes (got {n})")
    k = min(cfg.max_candidates, h * w)
    pose = torch.empty((b, n, 7), dtype=torch.float32, device=dev)
    box = torch.empty((b, n, 8, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((b, n), dtype=torch.bool, device=dev)
    overflow = torch.empty((b, n), dtype=torch.bool, device=dev)
    counts = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    if b * n == 0:
        return pose, box, ok, overflow, counts
    from tpufusion_torch.ops.label_encode import pixel_trig

    lists = torch.empty((b, n, w + h), dtype=torch.int32, device=dev)
    tiles = torch.empty((b, n, -(-k // TILE), 26, TILE), dtype=torch.float32, device=dev)
    lane_info = torch.empty((b, n, INFO), dtype=torch.int32, device=dev)
    f32 = np.float32
    consts = (ctypes.c_float * N_CONSTANTS)(
        *(f32(d) for d in cfg.far_delta), f32(1e-9), f32(cfg.max_bbox_dist**2))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tf_corner_vote(
            y_pred.data_ptr(), channels, image.data_ptr(), image.shape[-1],
            positives.data_ptr(), bbox.data_ptr(), centroid_3d.data_ptr(),
            None if lanes is None else lanes.data_ptr(),
            *(t.data_ptr() for t in pixel_trig(spec, dev)), b, n, h, w, k, cfg.margin_x,
            cfg.margin_y, consts, lists.data_ptr(), tiles.data_ptr(), counts.data_ptr(),
            lane_info.data_ptr(), pose.data_ptr(), box.data_ptr(), ok.data_ptr(),
            overflow.data_ptr(), stream,
        )
    _build.check(lib, err, "corner_vote_lanes")
    LAUNCHES += 1
    return pose, box, ok, overflow, counts


def kernel_launches() -> int:
    """The kernels `tf_corner_vote` has launched on the card since the
    library was loaded (two a call: the lists and the counts)."""
    return int(_build.load().tf_corner_vote_kernels())


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
    """The kernel (two calls, one launch each, from the positives map the
    decode makes, or AssertionError) and its plain version (which reads
    y_pred) on the same lanes of a CUDA batch:
    `_golden.corner_kernel_readings`, with "overflow" (voted lanes over
    the budget), "candidates" (the most a voted lane had), "zeros" (every
    lane left out is zeros and False) and "repeatable" (the two calls'
    outputs equal bit for bit, counts of the real slots included)
    added; "ok" holds the last two too."""
    from tpufusion_torch._golden import corner_kernel_readings
    from tpufusion_torch.decode.decode import _corner_pose, _positives, corner_vote_reference

    names = ("pose", "box", "ok", "overflow", "counts")
    with torch.inference_mode():
        positives = _positives(y_pred[..., 1], cfg)
        before = LAUNCHES
        got = dict(zip(names, launch(y_pred, images, bbox, centroid_3d, lanes, spec, cfg,
                                     positives)))
        again = dict(zip(names, launch(y_pred, images, bbox, centroid_3d, lanes, spec, cfg,
                                       positives)))
        assert LAUNCHES == before + 2, "corner_vote_lanes: not one kernel launch a call"
        got["box_pose"] = _corner_pose(got["box"])
        readings: dict = {}
        want = dict(zip(names, corner_vote_reference(y_pred, images, bbox, centroid_3d, spec,
                                                     cfg, readings)))
        want["counts"] = readings["counts"]
    voted = np.ones(tuple(bbox.shape[:2]), bool) if lanes is None else lanes.cpu().numpy()
    numpy = {k: v.cpu().numpy() for k, v in readings.items()}
    k = min(cfg.max_candidates, y_pred.shape[1] * y_pred.shape[2])
    real = (np.arange(k) < np.minimum(numpy["total"], k)[..., None]) & voted[..., None]  # written
    g, a = ({key: v.cpu().numpy() for key, v in d.items()} for d in (got, again))
    repeatable = all(np.array_equal(g[key].view(np.uint8), a[key].view(np.uint8))
                     for key in names[:4]) and np.array_equal(g["counts"][real], a["counts"][real])
    out = corner_kernel_readings(g, {key: v.cpu().numpy() for key, v in want.items()}, numpy,
                                 voted)
    zeros = not (g["pose"][~voted].any() or g["box"][~voted].any() or g["ok"][~voted].any()
                 or g["overflow"][~voted].any())
    out.update(overflow=int((numpy["total"] > k)[voted].sum()),
               candidates=int(numpy["total"][voted].max(initial=0)), zeros=zeros,
               repeatable=repeatable)
    out["ok"] = out["ok"] and zeros and repeatable
    return out
