"""Plain nearest-wins z-buffer (counterpart of `tpufusion/ops/scatter.py`).

The reference's collision rule: the point with the smallest L2 norm wins a
pixel, ties go to the lowest point index (`nearest_wins_sort`). Here the
rule is one reduction: each valid point packs `(key_bits << 32) | idx`
into an int64, and a `scatter_reduce_("amin")` into a grid filled with
INT64_MAX keeps the smallest pack per pixel. A valid key is the bit
pattern of a finite non-negative float32 (< 2**31), so every pack is a
non-negative int64 below the sentinel and the order of packs is the order
of (key, index). Only `nearest_wins_sort`'s exact contract is ported; the
TPU-only variants (scatter, sort16, packed) are not.
"""

from __future__ import annotations

import torch

INT64_MAX = torch.iinfo(torch.int64).max


def _sortable_bits(x: torch.Tensor) -> torch.Tensor:
    """Bit-pattern encoding of non-negative float32 that preserves order."""
    return x.to(torch.float32).view(torch.int32)


def nearest_wins_reference(
    pixel_ids: torch.Tensor,  # (B, N) int32 flat pixel index, in range where valid
    key_bits: torch.Tensor,  # (B, N) int32 sortable L2 bits; smallest wins
    valid: torch.Tensor,  # (B, N) bool
    num_pixels: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (winner (B, P) int32, occupied (B, P) bool).

    winner[b, p] is the index of the point that wins pixel p of frame b
    (lowest key, ties to the lowest index); 0 where occupied is False.
    Invalid points are dropped before the reduce: their pixel id may be
    garbage (a NaN point's cast) and is never used as an index."""
    b, n = pixel_ids.shape
    idx = torch.arange(n, device=pixel_ids.device, dtype=torch.int64)
    packed = (key_bits.to(torch.int64) << 32) | idx[None, :]
    packed = torch.where(valid, packed, INT64_MAX)
    safe_ids = torch.where(valid, pixel_ids, 0).to(torch.int64)
    grid = torch.full(
        (b, num_pixels), INT64_MAX, dtype=torch.int64, device=pixel_ids.device
    )
    grid.scatter_reduce_(1, safe_ids, packed, "amin", include_self=True)
    occupied = grid != INT64_MAX
    winner = torch.where(occupied, grid & 0xFFFFFFFF, 0).to(torch.int32)
    return winner, occupied
