"""Bird's-eye-view rasterization (counterpart of `tpufusion/geometry/bev.py`).

Points are binned with numpy.histogram2d's rule over edges
arange(-max_range, max_range, res): x into rows with res_x, y into columns
with res_y, the last edge inclusive. Channel 0 is the MV3D density
255 * min(1, log(N + 1) / log 64); the spec may add the per-cell maximum
height and maximum intensity. The raster is flipped both ways, as the
reference's is.

The bin of a point is floor((v - lo) / res) in float32, a true division:
a point on an edge moves a whole cell under a reciprocal multiply, which
is what torch does on the card when the divisor is a Python number. The
divisor is therefore a tensor on the points' device. Counts and the two
max channels are bit-identical to the reference; the density differs by
the ulps of log1p.
"""

from __future__ import annotations

import math

import torch

from tpufusion_torch.config import BevSpec
from tpufusion_torch.ops.scatter import scatter_count, scatter_max


def _bucketize(v: torch.Tensor, lo: float, res: float, nbins: int):
    """histogram2d-compatible binning: [edge_i, edge_{i+1}) with the last
    edge inclusive. Returns (bucket int32 clipped to [0, nbins - 1],
    in-range mask)."""
    f32 = dict(dtype=torch.float32, device=v.device)
    # filled on the device: a host number copied to the card waits for it
    lo_t, res_t = torch.full((), lo, **f32), torch.full((), res, **f32)
    last_edge = torch.full((), lo + res * nbins, **f32)
    valid = (v >= lo_t) & (v <= last_edge)
    # a NaN's cast gives garbage here; the caller masks those points first
    bucket = torch.floor((v - lo_t) / res_t).clamp(0, nbins - 1).to(torch.int32)
    return bucket, valid


def bev_rasterize_batch(
    points: torch.Tensor,  # (B, N, >=3)
    spec: BevSpec = BevSpec(),
    valid: torch.Tensor | None = None,  # (B, N) bool
) -> torch.Tensor:
    """Padded point clouds (B, N, >=3) -> (B, nx, ny, C) float32 rasters,
    every frame in one batched scatter.

    Channel 0 is the normalized density in [0, 255]; channels 1 / 2 (if
    enabled in the spec) are max height and max intensity per cell."""
    pts = points.to(torch.float32)
    ok = torch.isfinite(pts).all(dim=-1)
    if valid is not None:
        ok = ok & valid.to(torch.bool)

    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    bx, vx = _bucketize(x, -spec.max_range, spec.res_x, spec.nx)
    by, vy = _bucketize(y, -spec.max_range, spec.res_y, spec.ny)
    ok = ok & vx & vy
    cell = bx * spec.ny + by
    ncells = spec.nx * spec.ny

    counts = scatter_count(cell, ok, ncells)
    log_base = math.log(spec.density_log_base)
    density = torch.where(
        counts > 0,
        255.0 * torch.clamp(torch.log1p(counts) / log_base, max=1.0),
        0.0,
    )

    channels = [density]
    if spec.with_height_channel:
        channels.append(scatter_max(cell, z, ok, ncells, fill=0.0))
    if spec.with_intensity_channel:
        inten = pts[..., 3] if pts.shape[-1] > 3 else torch.zeros_like(x)
        channels.append(scatter_max(cell, inten, ok, ncells, fill=0.0))

    img = torch.stack(channels, dim=-1).reshape(-1, spec.nx, spec.ny, len(channels))
    return torch.flip(img, dims=(1, 2))  # the reference flips both axes


def bev_rasterize(
    points: torch.Tensor,  # (N, >=3)
    spec: BevSpec = BevSpec(),
    valid: torch.Tensor | None = None,  # (N,) bool
) -> torch.Tensor:
    """One padded point cloud (N, >=3) -> (nx, ny, C) float32 raster."""
    return bev_rasterize_batch(
        points[None], spec, None if valid is None else valid[None]
    )[0]
