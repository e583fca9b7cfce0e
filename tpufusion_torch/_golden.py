"""Helpers for holding the port against the committed JAX goldens
(tests/data/torch_port_golden*.npz): used by chip_smoke.py, the golden
tests and the card's tests. numpy only.
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
