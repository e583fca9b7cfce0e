"""The pin that keeps float32 matmuls in full precision, shared by the
decode (corner vote, head center) and the fusion net's dense layers."""

from __future__ import annotations

import contextlib

import torch


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
