"""Adversarial inputs that hold the CUDA kernels against their plain
versions (`tests/test_torch_cuda.py` and `chip_smoke.py` phases 1b-3 run
the same ones), and the BEV rasterizer's edge-case cloud. Numpy only,
made from a seed.

The pixel kernel's points (`csrc/pixels.cu`) aim at fdlibm's branches
and the pixel borders: every combination of coordinates from a set of
edge values (+-0, subnormals, the smallest normal, +-1, fdlibm's |y/x|
breakpoints and their neighbours, 2^+-60, huge values, +-inf, NaN), so
x < 0 with y = +-0, points on the z axis and a non-finite value in each
channel; quotients y/x one ulp either side of each breakpoint; points
whose azimuth or elevation falls within a few ulps of a column or row
border; random points, duplicates and invalid ones.

The CC masks aim at the tiling of `csrc/components.cu` (32-row x
64-column tiles: at 32 x 1801 one row of 28 full tiles and a ragged
9-column last one, at 63 x 1801 a second, 31-row, row of tiles; warps of
32 columns inside): components that cross every column and row border
many times, teeth and stripes on the border columns and rows, a comb
whose teeth meet only through a spine across the row borders, every
pixel its own root, blobs at both ends of a row (no wrap), dense noise on
the ragged last column and row tiles, and frames whose last tile touches
the next frame's first in memory. They are made at any height (1, 33, 63
and 128 rows among those tested). The z-buffer inputs aim at the 16-CTA
cluster of `csrc/nearest_wins.cu`: a whole frame in one pixel, exact-key
ties, invalid points with garbage pixel ids, an empty frame, and points
that all land in one CTA's slice of the frame; the packed z-buffer's
(`csrc/nearest_wins_packed.cu`) add near ties, keys that differ only in
the bits its quantized key drops, at the point counts where idx_bits
steps (32,768 and 32,769) and at 131,072, and clouds with NaN and inf
coordinates and padding that go through the pixel kernel first.
"""

from __future__ import annotations

import numpy as np

TILE_COLS = 64  # csrc/components.cu kTileCols
TILE_ROWS = 32  # csrc/components.cu kTileRows
CLUSTER = 16  # csrc/nearest_wins.cu kCluster
# Past one row of tiles, `cc_frames` cuts both serpentines to their first
# columns, so that the plain sweeps that hold the kernel to them converge
# in about this many sweeps (a sweep of 64 frames of 128 rows takes
# milliseconds on the card); `cc_batch(1)` keeps the full-width serpentine.
# At one row of tiles both span the full width (~1,800 and ~9,000 sweeps
# at 32 x 1801).
SERPENTINE_SWEEPS = 1500


def _serpentine(h: int, w: int) -> np.ndarray:
    """One path: every even row, joined at alternate ends by odd rows."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def _serpentine_cut(h: int, w: int) -> np.ndarray:
    """The serpentine, past one row of tiles over the columns that a label
    crosses in SERPENTINE_SWEEPS sweeps (16 columns a sweep along a row)."""
    cols = w if h <= TILE_ROWS else min(w, 16 * (2 * SERPENTINE_SWEEPS // h - 2))
    m = np.zeros((h, w), bool)
    m[:, :cols] = _serpentine(h, cols)
    return m


def _serpentine_columns(h: int, w: int) -> np.ndarray:
    """The serpentine turned: every even column down all rows, past one row
    of tiles over the columns that a label crosses in SERPENTINE_SWEEPS
    sweeps (4 rows a sweep down a column)."""
    cols = w if h <= TILE_ROWS else min(w, 2 * SERPENTINE_SWEEPS // (h // 4 + 2))
    m = np.zeros((h, w), bool)
    m[:, :cols] = _serpentine(cols, h).T
    return m


def _comb(h: int, w: int) -> np.ndarray:
    """A spine on the last row, 1-px teeth on the columns either side of
    each warp edge (every 32 columns, the tile borders among them)."""
    m = np.zeros((h, w), bool)
    m[-1] = True
    for k in range(1, -(-w // 32)):
        m[:, 32 * k - 1 if k % 2 else 32 * k] = True
    return m


def _comb_rows(h: int, w: int) -> np.ndarray:
    """A spine down the middle column across every row border; 1-px teeth
    on the row above each border (left half), the row below it (right
    half) and every 8th row between (full width). The teeth meet only
    through the spine."""
    m = np.zeros((h, w), bool)
    rows = np.arange(h)
    m[rows % TILE_ROWS == TILE_ROWS - 1, : w // 2] = True
    m[(rows % TILE_ROWS == 0) & (rows > 0), w // 2 :] = True
    m[rows % 8 == 4] = True
    m[:, w // 2] = True
    return m


def _border_stripes(h: int, w: int) -> np.ndarray:
    """1-px stripes on both border columns: a 2-wide bar across each
    column border, nothing else."""
    cols = np.arange(w) % TILE_COLS
    return np.broadcast_to((cols == 0) | (cols == TILE_COLS - 1), (h, w)).copy()


def _row_stripes(h: int, w: int) -> np.ndarray:
    """1-px stripes on both border rows (31 / 32, 63 / 64, ...): a 2-high
    bar across each row border, nothing else."""
    rows = np.arange(h) % TILE_ROWS
    return np.broadcast_to(((rows == 0) | (rows == TILE_ROWS - 1))[:, None], (h, w)).copy()


def _ends(h: int, w: int) -> np.ndarray:
    """Blobs (the middle half of the rows) and full-height lines at columns
    0 and W-1 (two components each side, never one across the seam)."""
    m = np.zeros((h, w), bool)
    mid = slice(h // 4, 3 * h // 4)
    m[:, 0] = m[:, -1] = True
    m[mid, 2:5] = m[mid, -5:-2] = True
    m[mid, 1] = m[mid, -2] = True
    return m


def _ragged(rng, h: int, w: int) -> np.ndarray:
    """Dense noise on the last full column of tiles and the ragged last
    one."""
    m = np.zeros((h, w), bool)
    c0 = max(0, (-(-w // TILE_COLS) - 2) * TILE_COLS)
    m[:, c0:] = rng.random((h, w - c0)) < 0.6
    return m


def _ragged_rows(rng, h: int, w: int) -> np.ndarray:
    """Dense noise on the last full row of tiles and the (ragged) last
    one."""
    m = np.zeros((h, w), bool)
    r0 = max(0, (-(-h // TILE_ROWS) - 2) * TILE_ROWS)
    m[r0:] = rng.random((h - r0, w)) < 0.6
    return m


def _frame_edges(h: int, w: int) -> np.ndarray:
    """The first and last columns full and the corners set, so frame b's
    last pixel and frame b+1's first are both foreground in memory."""
    m = np.zeros((h, w), bool)
    m[:, :2] = m[:, -2:] = True
    m[-1, -TILE_COLS:] = m[0, :TILE_COLS] = True
    return m


def _frame_rows(h: int, w: int) -> np.ndarray:
    """The first and last rows full and joined by the middle column, so
    frame b's last row of tiles meets frame b+1's first along a whole row
    in memory."""
    m = np.zeros((h, w), bool)
    m[0] = m[-1] = True
    m[:, w // 2] = True
    return m


def cc_frames(seed: int = 0, height: int = 32, width: int = 1801) -> dict[str, np.ndarray]:
    """Named (H, W) bool masks, one frame each."""
    rng = np.random.default_rng(seed)
    h, w = height, width
    frames = {
        "full": np.ones((h, w), bool),
        "serpentine": _serpentine_cut(h, w),
        "serpentine_columns": _serpentine_columns(h, w),
        "comb": _comb(h, w),
        "comb_rows": _comb_rows(h, w),
        "checkerboard": (np.add.outer(np.arange(h), np.arange(w)) % 2 == 0),
        "border_stripes": _border_stripes(h, w),
        "row_stripes": _row_stripes(h, w),
        "ends": _ends(h, w),
        "ragged_last_strip": _ragged(rng, h, w),
        "ragged_last_row_tile": _ragged_rows(rng, h, w),
        "frame_edges": _frame_edges(h, w),
        "frame_rows": _frame_rows(h, w),
        "empty": np.zeros((h, w), bool),
    }
    for density in (0.05, 0.4, 0.6):
        frames[f"random_{density}"] = rng.random((h, w)) < density
    return frames


def cc_batch(batch: int, seed: int = 0, height: int = 32, width: int = 1801) -> np.ndarray:
    """(batch, H, W): the named frames in turn ("frame_edges" and then
    "frame_rows" twice in a row at the start, so each one's edge meets its
    copy), then fresh random ones; at batch 1 the full-width serpentine."""
    named = cc_frames(seed, height, width)
    twice = ["frame_edges", "frame_rows"]
    order = [k for k in twice for _ in range(2)] + [k for k in named if k not in twice]
    rng = np.random.default_rng(seed + 1)
    out = []
    for i in range(batch):
        if i < len(order):
            out.append(named[order[i]])
        else:
            out.append(rng.random((height, width)) < (0.05, 0.3, 0.55, 0.6)[i % 4])
    if batch == 1:  # one path over the full width at any height
        out = [_serpentine(height, width)]
    return np.stack(out)


CC_BATCHES = (1, 16, 64)  # batch sizes of the cc_batch cases
CC_HEIGHTS = (32, 33, 63, 64, 128)  # range-view heights of the cc_batch cases
ZBUFFER_KINDS = ("one_pixel", "ties", "garbage_ids", "all_invalid", "one_cta", "uniform")
# (batch, points per frame, kinds): each kind alone in one frame (config
# 1's shape), then the kinds in turn at the other serving shapes (config
# 3's 8, config 2's 64, config 5's 16 x 131,072) and at an odd N
ZBUFFER_SHAPES = [(1, 32768, (k,)) for k in ZBUFFER_KINDS] + [
    (8, 32768, ZBUFFER_KINDS), (64, 32768, ZBUFFER_KINDS), (16, 131072, ZBUFFER_KINDS),
    (3, 4097, ZBUFFER_KINDS)]


# the packed z-buffer's kinds: the exact one's and near ties; each kind
# alone in one frame, then all in turn at 32,769 points (idx_bits 16
# against 15 at 32,768), at the main path's 64 x 32,768 and at config 5's
# 16 x 131,072 (idx_bits 17)
PACKED_KINDS = ZBUFFER_KINDS + ("near_ties",)
PACKED_SHAPES = [(1, 32768, (k,)) for k in PACKED_KINDS] + [
    (len(PACKED_KINDS), 32769, PACKED_KINDS), (64, 32768, PACKED_KINDS),
    (16, 131072, PACKED_KINDS)]
NEAR_TIE_ULPS = 1 << 17  # key offsets below this: equal after the packed shift at N <= 131,072
# the packed kernel's grid in the cluster's shared memory: pixels on the
# CTAs' slice boundaries, every pixel occupied, the ragged last slice at 63
# rows (113,463 pixels: slices of 7,092, the last 7,083) and images past one
# cluster's shared memory (690 x 1801: bands); (batch, points per frame,
# kinds, the range view's res_v_deg)
PACKED_EDGE_SETS = [
    (2, 65536, ("slice_edges", "every_pixel"), 1.33),
    (2, 131072, ("slice_edges", "every_pixel"), 0.665),
    (4, 32768, ("slice_edges", "one_cta", "near_ties", "uniform"), 0.665),
    (2, 65536, ("slice_edges", "uniform"), 0.06),
    (1, 1310720, ("every_pixel",), 0.06),
]
BAND_SLOTS = 51964  # an H100 CTA's slots in the band path: (232,448 - 24,592 B) / 4


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
        elif kind == "near_ties":  # 97 pixels, keys a few thousand ulps apart
            pix[f] = rng.integers(0, 97, n)
            bits = rng.choice(np.float32([1.0, 2.0, 9.0]), n).view(np.int32)
            dist[f] = (bits + rng.integers(0, NEAR_TIE_ULPS, n).astype(np.int32)).view(np.float32)
        elif kind == "one_cta":
            lo = (CLUSTER - 1) * slice_
            pix[f] = rng.integers(lo, num_pixels, n)
        elif kind == "slice_edges":  # each side of every CTA's (and band CTA's) first pixel
            starts = np.concatenate([np.arange(0, num_pixels, slice_),
                                     np.arange(0, num_pixels, BAND_SLOTS), [num_pixels]])
            edges = np.unique(np.clip(starts[:, None] + np.arange(-2, 2), 0, num_pixels - 1))
            pix[f] = rng.choice(edges, n)
            bits = rng.choice(np.float32([1.0, 2.0, 9.0]), n).view(np.int32)
            dist[f] = (bits + rng.integers(0, NEAR_TIE_ULPS, n).astype(np.int32)).view(np.float32)
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
    for f in range(batch):
        if kinds[f % len(kinds)] == "every_pixel":  # the last P points cover the image
            if n < num_pixels:
                raise ValueError(f"every_pixel needs N >= P, got N={n}, P={num_pixels}")
            pix[f, n - num_pixels :] = rng.permutation(num_pixels)
            valid[f, n - num_pixels :] = True
    payload = rng.standard_normal((batch, n, 3)).astype(np.float32)
    return pix, dist.view(np.int32), valid, payload


def nan_clouds(batch: int, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(points (B, N, 4) float32, valid (B, N) bool) for a range view:
    Gaussian clouds (sd 20 m) whose second quarter repeats the first with
    x, y, z scaled by 1 + U(-1e-4, 1e-4) (the same pixel, a near-tie key),
    a NaN or an inf in one channel of 1 % of the points, and the last tenth
    of each frame masked as padding."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((batch, n, 4)) * 20).astype(np.float32)
    q = n // 4
    scale = (1.0 + rng.uniform(-1e-4, 1e-4, (batch, q, 1))).astype(np.float32)
    pts[:, q : 2 * q, :3] = pts[:, :q, :3] * scale
    b, i = np.nonzero(rng.random((batch, n)) < 0.01)
    pts[b, i, rng.integers(0, 4, len(b))] = rng.choice(np.float32([np.nan, np.inf, -np.inf]), len(b))
    valid = np.ones((batch, n), bool)
    valid[:, n - n // 10 :] = False
    return pts, valid


def pixel_edge_values() -> np.ndarray:
    """float32 coordinates at fdlibm's edges, both signs."""
    f = np.float32
    base = [0.0, 1e-45, 1e-40, 1.1754942e-38, 1.1754944e-38, 1e-30, 0.5, 1.0, 2.0, 3.0,
            1e10, 3.4e38, np.inf, np.nan]
    for b in (0.4375, 0.6875, 1.1875, 2.4375, 2.0**25, 2.0**60, 2.0**-60):
        base += [np.nextafter(f(b), f(0)), b, np.nextafter(f(b), f(np.inf))]
    v = np.array(base, np.float32)
    return np.concatenate([v, -v])


def _border_points(rng, spec, n: int) -> np.ndarray:
    """(n, 3) points whose azimuth (first half) or elevation (second half)
    lies within a few ulps of a column or row border of `spec`."""
    half = n // 2
    r = rng.uniform(2.0, 80.0, n)
    col = rng.integers(0, spec.width, half)
    az = (col + spec.x_min) * spec.res_h_rad  # atan2(-y, x) at the border
    el = np.radians(rng.uniform(-26.0, 3.0, n))
    row = rng.integers(0, spec.height, n - half)
    el[half:] = (row + spec.y_min) * spec.res_v_rad
    az = np.concatenate([az, rng.uniform(-np.pi, np.pi, n - half)])
    pts = np.stack([r * np.cos(el) * np.cos(az), -r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], axis=-1).astype(np.float32)
    nudge = rng.integers(-3, 4, (n, 3))  # a few ulps either way
    for _ in range(3):
        pts = np.where(nudge > 0, np.nextafter(pts, np.float32(np.inf)), pts)
        pts = np.where(nudge < 0, np.nextafter(pts, np.float32(-np.inf)), pts)
        nudge = nudge - np.sign(nudge)
    return pts


def pixel_fixed_points() -> np.ndarray:
    """(M, 3): every (x, y, z) of a small edge set, every (x, y) of
    `pixel_edge_values` at z = 1.5 and every (x, z) at y = 0, and
    quotients y/x one ulp either side of each fdlibm breakpoint."""
    f = np.float32
    v = pixel_edge_values()
    small = np.array([0.0, 1e-40, 1.1754944e-38, 0.4375, 1.0, 2.0, 3.4e38, np.inf, np.nan], f)
    small = np.concatenate([small, -small])
    cube = np.stack(np.meshgrid(small, small, small, indexing="ij"), -1).reshape(-1, 3)
    xx, yy = (a.ravel() for a in np.meshgrid(v, v, indexing="ij"))
    xy = np.stack([xx, yy, np.full_like(xx, 1.5)], -1)
    xz = np.stack([xx, np.zeros_like(xx), yy], -1)
    xs = np.array([2.0, -3.0, 0.75, 1e-20, -1e20], f)
    qs = np.concatenate([[np.nextafter(f(b), f(0)), f(b), np.nextafter(f(b), f(np.inf))]
                         for b in (2.0**-29, 0.4375, 0.6875, 1.1875, 2.4375, 2.0**25)])
    qx, qy = (a.ravel() for a in np.meshgrid(xs, qs, indexing="ij"))
    quot = np.stack([qx, (qy * qx).astype(f), np.full_like(qx, 1.5)], -1)
    quot = np.concatenate([quot, quot * f([1, -1, -1])])
    return np.concatenate([cube, xy, xz, quot]).astype(f)


def pixel_points(spec, batch: int = 2, n: int = 32768, channels: int = 4, seed: int = 0):
    """(points (B, N, C) float32, valid (B, N) bool) for the pixel kernel:
    each frame starts with `pixel_fixed_points` (as many as fit in half
    the frame), then border points of `spec`; a tenth invalid, the last
    512 copies of the first, and the intensity (C > 3) NaN, inf or
    subnormal at random points."""
    rng = np.random.default_rng(seed)
    fixed = pixel_fixed_points()[: n // 2]
    pts = np.empty((batch, n, channels), np.float32)
    valid = rng.random((batch, n)) > 0.1
    for b in range(batch):
        pts[b, :, :3] = np.concatenate([fixed, _border_points(rng, spec, n - len(fixed))])
        if channels > 3:
            pts[b, :, 3:] = rng.uniform(0, 1, (n, channels - 3))
            odd = rng.integers(0, n, 64)
            pts[b, odd, 3] = rng.choice(np.float32([np.nan, np.inf, -np.inf, 1e-40]), 64)
    k = min(512, n // 4)
    pts[:, n - k:] = pts[:, :k]  # duplicates: key and pixel ties
    valid[:, n - k:] = valid[:, :k]
    return pts, valid


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
