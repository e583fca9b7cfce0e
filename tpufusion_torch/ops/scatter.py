"""Plain nearest-wins z-buffer and the BEV's count / max scatters
(counterpart of `tpufusion/ops/scatter.py`).

The reference's collision rule: the point with the smallest L2 norm wins a
pixel, ties go to the lowest point index (`nearest_wins_sort`). Here the
rule is one reduction: each valid point packs `(key_bits << 32) | idx`
into an int64, and a `scatter_reduce_("amin")` into a grid filled with
INT64_MAX keeps the smallest pack per pixel. A valid key is the bit
pattern of a finite non-negative float32 (< 2**31), so every pack is a
non-negative int64 below the sentinel and the order of packs is the order
of (key, index). Only `nearest_wins_sort`'s exact contract is ported; the
TPU-only variants (scatter, sort16, packed) are not.

`scatter_count` and `scatter_max` bin the bird's-eye view. The reference
computes them with plain XLA scatters outside any kernel, so they are
`scatter_add_` and `scatter_reduce_("amax")` here; both take one frame
(N,) or a batch (B, N).
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


def scatter_count(
    pixel_ids: torch.Tensor,  # (N,) or (B, N) integer cell index, in range where valid
    valid: torch.Tensor,  # same shape, bool
    num_pixels: int,
) -> torch.Tensor:
    """Number of valid points landing in each pixel, float32: (P,) for
    (N,) inputs, (B, P) for (B, N). Invalid points add 0 to pixel 0, as in
    the reference; counts below 2**24 are exact in float32 in any order."""
    safe_ids = torch.where(valid, pixel_ids, 0).to(torch.int64)
    counts = torch.zeros(
        (*pixel_ids.shape[:-1], num_pixels), dtype=torch.float32, device=pixel_ids.device
    )
    return counts.scatter_add_(-1, safe_ids, valid.to(torch.float32))


def scatter_max(
    pixel_ids: torch.Tensor,  # (N,) or (B, N)
    values: torch.Tensor,  # same shape
    valid: torch.Tensor,  # same shape, bool
    num_pixels: int,
    fill: float = 0.0,
) -> torch.Tensor:
    """Per-pixel maximum of values over valid points; `fill` where the
    result is not finite (an empty pixel). (P,) or (B, P), float32."""
    safe_ids = torch.where(valid, pixel_ids, 0).to(torch.int64)
    neg_inf = float("-inf")
    vals = torch.where(valid, values.to(torch.float32), neg_inf)
    out = torch.full(
        (*pixel_ids.shape[:-1], num_pixels), neg_inf, dtype=torch.float32,
        device=pixel_ids.device,
    )
    out.scatter_reduce_(-1, safe_ids, vals, "amax", include_self=True)
    return torch.where(torch.isfinite(out), out, fill)
