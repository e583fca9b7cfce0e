"""Adversarial inputs that hold the two CUDA kernels against their plain
versions (`tests/test_torch_cuda.py` and `chip_smoke.py` phases 2-3 run
the same ones), and the BEV rasterizer's edge-case cloud. Numpy only,
made from a seed.

The CC masks aim at the strip tiling of `csrc/components.cu` (64-column
full-height strips, 28 full ones and a ragged 9-column last one at width
1801, with warps of 32 columns inside): components that cross every strip
border many times, teeth and stripes on the border columns, every pixel
its own root, blobs at both ends of a row (no wrap), and frames whose
last strip touches the next frame's first in memory. The z-buffer inputs aim at the 16-CTA cluster of
`csrc/nearest_wins.cu`: a whole frame in one pixel, exact-key ties,
invalid points with garbage pixel ids, an empty frame, and points that all
land in one CTA's slice of the frame.
"""

from __future__ import annotations

import numpy as np

STRIP = 64  # csrc/components.cu kStrip
CLUSTER = 16  # csrc/nearest_wins.cu kCluster


def _serpentine(h: int, w: int) -> np.ndarray:
    """One path: every even row, joined at alternate ends by odd rows."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def _comb(h: int, w: int) -> np.ndarray:
    """A spine on the last row, 1-px teeth on the columns either side of
    each warp edge (every 32 columns, the strip borders among them)."""
    m = np.zeros((h, w), bool)
    m[-1] = True
    for k in range(1, -(-w // 32)):
        m[:, 32 * k - 1 if k % 2 else 32 * k] = True
    return m


def _border_stripes(h: int, w: int) -> np.ndarray:
    """1-px stripes on both border columns: a 2-wide bar across each
    border, nothing else."""
    cols = np.arange(w)
    return np.broadcast_to((cols % STRIP == 0) | (cols % STRIP == STRIP - 1), (h, w)).copy()


def _ends(h: int, w: int) -> np.ndarray:
    """Blobs and full-height lines at columns 0 and W-1 (two components
    each side, never one across the seam)."""
    m = np.zeros((h, w), bool)
    m[:, 0] = m[:, -1] = True
    m[8:24, 2:5] = m[8:24, -5:-2] = True
    m[8:24, 1] = m[8:24, -2] = True
    return m


def _ragged(rng, h: int, w: int) -> np.ndarray:
    """Dense noise on the last full strip and the ragged last one."""
    m = np.zeros((h, w), bool)
    c0 = (-(-w // STRIP) - 2) * STRIP
    m[:, c0:] = rng.random((h, w - c0)) < 0.6
    return m


def _frame_edges(h: int, w: int) -> np.ndarray:
    """The first and last columns full and the corners set, so frame b's
    last pixel and frame b+1's first are both foreground in memory."""
    m = np.zeros((h, w), bool)
    m[:, :2] = m[:, -2:] = True
    m[-1, -STRIP:] = m[0, :STRIP] = True
    return m


def cc_frames(seed: int = 0, height: int = 32, width: int = 1801) -> dict[str, np.ndarray]:
    """Named (H, W) bool masks, one frame each."""
    rng = np.random.default_rng(seed)
    h, w = height, width
    frames = {
        "full": np.ones((h, w), bool),
        "serpentine": _serpentine(h, w),
        "serpentine_columns": _serpentine(w, h).T.copy(),
        "comb": _comb(h, w),
        "checkerboard": (np.add.outer(np.arange(h), np.arange(w)) % 2 == 0),
        "border_stripes": _border_stripes(h, w),
        "ends": _ends(h, w),
        "ragged_last_strip": _ragged(rng, h, w),
        "frame_edges": _frame_edges(h, w),
        "empty": np.zeros((h, w), bool),
    }
    for density in (0.05, 0.4, 0.6):
        frames[f"random_{density}"] = rng.random((h, w)) < density
    return frames


def cc_batch(batch: int, seed: int = 0, height: int = 32, width: int = 1801) -> np.ndarray:
    """(batch, H, W): the named frames in turn ("frame_edges" twice in a row
    at the start, so its edge meets its copy), then fresh random ones."""
    named = cc_frames(seed, height, width)
    order = ["frame_edges", "frame_edges"] + [k for k in named if k != "frame_edges"]
    rng = np.random.default_rng(seed + 1)
    out = []
    for i in range(batch):
        if i < len(order):
            out.append(named[order[i]])
        else:
            out.append(rng.random((height, width)) < (0.05, 0.3, 0.55, 0.6)[i % 4])
    if batch == 1:
        out = [named["serpentine"]]
    return np.stack(out)


CC_BATCHES = (1, 16, 64)  # batch sizes of the cc_batch cases
ZBUFFER_KINDS = ("one_pixel", "ties", "garbage_ids", "all_invalid", "one_cta", "uniform")
# (batch, points per frame, kinds): each kind alone in one frame (config
# 1's shape), then the kinds in turn at the other serving shapes (config
# 3's 8, config 2's 64, config 5's 16 x 131,072) and at an odd N
ZBUFFER_SHAPES = [(1, 32768, (k,)) for k in ZBUFFER_KINDS] + [
    (8, 32768, ZBUFFER_KINDS), (64, 32768, ZBUFFER_KINDS), (16, 131072, ZBUFFER_KINDS),
    (3, 4097, ZBUFFER_KINDS)]


def zbuffer_args(batch: int, n: int, num_pixels: int, seed: int = 0, kinds=ZBUFFER_KINDS):
    """(pix int32, key_bits int32, valid bool, payload float32 (B, N, 3)) in
    numpy, frame f of kind kinds[f % len(kinds)]. Valid points have pixel
    ids in range and keys that are bit patterns of finite non-negative
    float32, as the range view makes them; invalid points carry any id."""
    rng = np.random.default_rng(seed)
    slice_ = -(-num_pixels // CLUSTER)
    pix = np.empty((batch, n), np.int32)
    dist = np.empty((batch, n), np.float32)
    valid = np.empty((batch, n), bool)
    for f in range(batch):
        kind = kinds[f % len(kinds)]
        valid[f] = rng.random(n) > 0.1
        dist[f] = rng.uniform(0.5, 120.0, n)
        if kind == "one_pixel":
            pix[f] = rng.integers(0, num_pixels)
            dist[f] = rng.choice(np.float32([3.0, 3.5, 7.25]), n)
        elif kind == "ties":
            pix[f] = rng.integers(0, 97, n)
            dist[f] = rng.choice(np.float32([1.0, 2.0, 2.5, 9.0]), n)
        elif kind == "one_cta":
            lo = (CLUSTER - 1) * slice_
            pix[f] = rng.integers(lo, num_pixels, n)
        else:
            pix[f] = rng.integers(0, num_pixels, n)
        if kind == "garbage_ids":
            bad = ~valid[f]
            pix[f, bad] = rng.integers(-(2**31), 2**31 - 1, int(bad.sum()), dtype=np.int64)
        if kind == "all_invalid":
            valid[f] = False
            pix[f] = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64)
    k = min(512, n // 4)  # exact copies of the first k points: key and id ties
    for a in (pix, dist, valid):
        a[:, n // 2 : n // 2 + k] = a[:, :k]
    payload = rng.standard_normal((batch, n, 3)).astype(np.float32)
    return pix, dist.view(np.int32), valid, payload


def bev_edge_cloud(spec, seed: int = 5, n: int = 4096):
    """(points (n, 4) float32, valid (n,) bool) for the BEV rasterizer:
    random points over and beyond the grid, points exactly on bin edges
    and at +-max_range (the last edge is inclusive), one ulp outside,
    NaN / inf rows, a crowded corner cell, masked rows. `spec` is a
    BevSpec."""
    rng = np.random.default_rng(seed)
    r = spec.max_range
    pts = rng.uniform(-1.1 * r, 1.1 * r, (n, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 3, n)
    kx = rng.integers(0, spec.nx + 1, 600)
    ky = rng.integers(0, spec.ny + 1, 600)
    pts[:600, 0] = (-r + spec.res_x * kx).astype(np.float32)  # on x edges
    pts[300:900, 1] = (-r + spec.res_y * ky).astype(np.float32)  # on y edges
    pts[900:906, :2] = [[r, r], [-r, -r], [r, -r], [-r, r], [r, 0], [0, -r]]
    pts[906, 0] = np.nextafter(np.float32(r), np.float32(np.inf))
    pts[907, 1] = np.nextafter(np.float32(-r), np.float32(-np.inf))
    pts[910, 0], pts[911, 2], pts[912, 3] = np.nan, np.inf, -np.inf
    pts[920:940] = pts[900]  # a crowded corner cell
    valid = rng.random(n) > 0.2
    valid[900:908] = True
    return pts, valid
