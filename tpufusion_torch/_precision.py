"""The pins that keep float32 matmuls (the decode's corner vote and head
center, the fusion net's dense layers) and float32 convolutions (a
small-float FCN's dgrad and wgrad) in full precision; and the rounding of
float32 values to bf16 or float16 on the host."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def bf16_round(a) -> np.ndarray:
    """float32 values rounded to the nearest bf16 (ties to even), as
    float32 (finite inputs), in numpy: no torch op, so no device sync."""
    bits = np.array(a, np.float32, ndmin=1).view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def f16_round(a) -> np.ndarray:
    """float32 values rounded to the nearest float16 (ties to even,
    subnormals kept, overflow to inf), as float32, in numpy: no torch op,
    so no device sync."""
    return np.array(a, np.float32, ndmin=1).astype(np.float16).astype(np.float32)


def low_round(a, dtype: torch.dtype) -> np.ndarray:
    """float32 values rounded to `dtype` (bfloat16 or float16; float32
    leaves them), as float32, in numpy."""
    if dtype == torch.bfloat16:
        return bf16_round(a)
    if dtype == torch.float16:
        return f16_round(a)
    return np.array(a, np.float32, ndmin=1)


@contextlib.contextmanager
def full_f32_matmuls():
    """float32 matmuls in full precision inside the block (or the
    decorated function), the process's setting restored after. With
    torch.set_float32_matmul_precision("high") anywhere in the process
    they would run in TF32 on the card ("medium": bf16 passes in oneDNN
    on some CPUs): the corner vote's neighbour count would move pairs
    across its distance threshold, and the fusion net's 21,888-wide dense
    layer would lose three digits."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@contextlib.contextmanager
def full_f32_convs():
    """float32 convolutions in full precision inside the block, cuDNN's
    TF32 setting restored after: torch lets cuDNN run them in TF32 by
    default (`torch.backends.cudnn.allow_tf32`), which keeps 10 bits of
    a product's operands."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
