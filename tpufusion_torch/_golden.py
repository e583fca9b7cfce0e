"""Helpers for holding the port against the committed JAX goldens
(tests/data/torch_port_golden*.npz): used by chip_smoke.py, the golden
tests and the card's tests. numpy at import; the input recipes of the
fusion golden import the port's generators where they are called.
"""

from __future__ import annotations

import numpy as np

# bf16 FCN against JAX's bf16 FCN: both round each layer's output to
# bf16 (8 significant bits, a relative step of 2**-8), so an output may
# differ by a step where the two float32 accumulations straddle a
# rounding boundary. Probabilities come from the softmax in float32 of
# bf16 logits: 2**-8. Regression outputs reach |x| < 8, where a bf16 step
# is 2**-5: two steps, 2**-4.
BF16_PROB_ATOL = 2.0**-8
BF16_REG_ATOL = 2.0**-4
# Such steps are rare: at most this share of the regression outputs may
# differ at all. Measured on the golden frames: 0.06 % on the CPU, 0.58 %
# on an H100 (cuDNN sums in another order than XLA); rounding each
# convolution once instead of twice (a fused bias epilogue) moves 51 %.
BF16_REG_DIFFER_SHARE = 0.05
# The fusion golden (torch_port_golden_fusion.npz). Its lidar points, masks
# and radar rows are stored; the 8 camera frames (22 MB) are made again
# from FUSION_SEED by `fusion_golden_data` and held to stored digests.
FUSION_SEED = 41
FUSION_FRAMES = 8
FUSION_POINTS = 4096  # points per golden frame (the timed run uses 32,768)
BEV_SEED = 42
SEG_STRIDE = 17  # config 3's seg: foreground probability at every 17th pixel
SEG_FRAMES = 2
# Config 3's seg comes from a seeded BEV FCN whose two bf16 logits reach
# |x| < 4 (a bf16 step of 2**-6 there). A logit a step apart moves the
# softmax by at most a quarter of the step, both logits by half of it;
# 2**-6 leaves room for two steps each. Such steps are rare: at most
# BF16_SEG_DIFFER_SHARE of the sampled probabilities may differ by more
# than float32 noise (1e-6). The port reads 4.4e-3 and 0.06 % on the CPU.
BF16_SEG_ATOL = 2.0**-6
BF16_SEG_DIFFER_SHARE = 0.05
# Fusion net against JAX's on the golden's frames. The limits sit between
# what the port reads and what a wrong dtype would move: JAX's own bf16
# net differs from its float32 net on these frames by 1.01e-2 in the
# centroid (metres, up to ~30) and 9.9e-5 in rz (radians; the golden keeps
# both answers), so a port that ran the "bf16" net in float32, or rounded
# once more or less than JAX does, is a gap away and fails all three.
# float32 centroid: cuDNN and cuBLAS sum in another order than XLA on the
# CPU; the port reads 2.9e-6 on the CPU and 3.8e-6 on an H100.
F32_FUSION_ATOL = 1e-4
# bf16 centroid against JAX's bf16: both round every conv output to bf16
# at the same places; the port reads 5.7e-6 on the CPU and 3.8e-6 on an
# H100. A tenth of JAX's float32-vs-bf16 gap.
BF16_FUSION_ATOL = 1e-3
# rz, either dtype: reads 4.5e-8 on the CPU and 3.0e-8 on an H100. A
# tenth of JAX's float32-vs-bf16 gap in rz.
FUSION_RZ_ATOL = 1e-5
# the multi golden keeps JAX's bf16 foreground probability at every pixel
# and its regression outputs at every FCN_REG_STRIDE-th pixel of a frame
FCN_REG_STRIDE = 17


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def wrapped_pose_diff(got, want: np.ndarray) -> np.ndarray:
    """|got - want| per element, yaw (column 3) as an angle: the
    reference's pi-symmetry tie-break in the fit may return yaw or
    yaw + 2 pi. `got` is numpy or a tensor."""
    if hasattr(got, "detach"):
        got = got.detach().cpu().numpy()
    d = np.asarray(got, np.float64) - want
    d[..., 3] = (d[..., 3] + np.pi) % (2 * np.pi) - np.pi
    return np.abs(d)


def fcn_golden_sample(out: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """An FCN output (B, H, W, 2 + reg) -> what the golden keeps of it:
    (foreground probability (B, H, W), regression at every
    FCN_REG_STRIDE-th pixel (B, n, reg))."""
    b = out.shape[0]
    reg = out[..., 2:].reshape(b, -1, out.shape[-1] - 2)
    return out[..., 1], reg[:, ::FCN_REG_STRIDE]


def bf16_fcn_readings(out: np.ndarray, want_prob: np.ndarray, want_reg: np.ndarray):
    """The port's bf16 FCN output against the golden's JAX bf16 sample:
    (largest probability difference, largest regression difference,
    regression outputs that differ at all, regression outputs)."""
    prob, reg = fcn_golden_sample(out)
    dr = np.abs(reg - want_reg)
    return (
        float(np.abs(prob - want_prob).max()),
        float(dr.max()),
        int((dr > 0).sum()),
        dr.size,
    )


def sparse_cells(raster: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A (B, nx, ny, C) raster -> (flat (B, nx, ny) index of every cell
    with a non-zero channel, int64, and those cells' values (n, C))."""
    flat = raster.reshape(-1, raster.shape[-1])
    index = np.flatnonzero((flat != 0).any(axis=1))
    return index.astype(np.int64), flat[index]


def dense_cells(index: np.ndarray, values: np.ndarray, shape) -> np.ndarray:
    """The inverse of `sparse_cells`: the raster of `shape`."""
    out = np.zeros((int(np.prod(shape[:-1])), shape[-1]), values.dtype)
    out[index] = values
    return out.reshape(shape)


def seg_golden_sample(seg: np.ndarray) -> np.ndarray:
    """An FCN output (B, H, W, 2 + reg) -> the foreground probability at
    every SEG_STRIDE-th pixel of a frame, (B, n)."""
    return seg[..., 1].reshape(seg.shape[0], -1)[:, ::SEG_STRIDE]


def seg_readings(seg: np.ndarray, want_prob: np.ndarray) -> tuple[float, float]:
    """Config 3's seg against the golden's sample: (largest difference,
    share of the sampled probabilities that differ by more than 1e-6)."""
    d = np.abs(seg_golden_sample(seg) - want_prob)
    return float(d.max()), float((d > 1e-6).mean())


def bev_golden_inputs(spec) -> tuple[np.ndarray, np.ndarray]:
    """(points (3, 4096, 4), valid (3, 4096)) the BEV golden is made of:
    two beam scans stretched over the +-120 m grid and past it, and the
    edge-case cloud. The golden stores them (numpy's trigonometry may
    differ by ulps between machines)."""
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.ops.parity_inputs import bev_edge_cloud

    scans, _, svalid = synthesize_beam_scan_batch(np.random.default_rng(BEV_SEED), 2, 4096)
    scans[:, :, :2] *= 3.0
    edge, evalid = bev_edge_cloud(spec)
    return np.concatenate([scans, edge[None]]), np.concatenate([svalid, evalid[None]])


def fusion_golden_data(device) -> dict[str, np.ndarray]:
    """The fusion golden's frames made again from FUSION_SEED
    (`data.synthetic.build_fusion_dataset`, the range view projected on
    `device`), plus "cam_sha256", each camera frame's digest."""
    import hashlib

    from tpufusion_torch.data.synthetic import build_fusion_dataset

    data = build_fusion_dataset(FUSION_FRAMES, FUSION_SEED, n_points=FUSION_POINTS, device=device)
    data["cam_sha256"] = np.array(
        [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest() for f in data["cam"]])
    return data
