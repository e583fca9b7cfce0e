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

The label encodes' boxes (`csrc/label_encode.cu`) sit on the
360-degree seam, all round, over an image with no return, degenerate,
and ("faces") behind returns placed exactly on, and one step outside,
the direct head's dilated box faces: each such return's distance or
height is searched ulp by ulp in float32 through the plain version's
own operations (torch's float32 cos and sin of the column and the yaw,
read on the CPU) until its box-frame coordinate equals the half size,
or is the least value above it.
"""

from __future__ import annotations

import numpy as np

from tpufusion_torch._precision import bf16_round, f16_round

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


LABEL_KINDS = ("seam", "all_round", "no_returns", "degenerate", "faces")
# face_inputs' pixel cases, by code: a return on / one step outside the
# face where its ray enters or leaves the dilated box, or the top or
# bottom face, then a return inside the box
FACE_CASES = ("entry on", "entry out", "exit on", "exit out", "top on", "top out",
              "bottom on", "bottom out", "inside")


def label_inputs(spec, batch: int = 32, kind: str = "all_round", seed: int = 0, channels: int = 3):
    """(center (B, 3), size (B, 3), yaw (B,), image (B, H, W, C)) float32
    for the label encode: "seam" boxes on the 360-degree seam (their
    corners project to both ends of the image), "all_round" boxes 1-80 m
    away at any azimuth, a third nearly axis-aligned, "no_returns" those
    boxes over an image with no return (distance 0, the empty pixels'
    min_height), "degenerate" boxes of size 0, of zero length or width,
    at yaw 0 and +-pi, centers on the sensor's axis and at its origin,
    "faces" `face_inputs`' boxes and returns. The image holds distances
    0-40 m (a third empty), heights and intensities."""
    if kind == "faces":
        return face_inputs(spec, batch, seed, channels)[:4]
    rng = np.random.default_rng(seed)
    f = np.float32
    dist, ang = rng.uniform(3, 40, batch), rng.uniform(-np.pi, np.pi, batch)
    dist[::7] = rng.uniform(1, 3, len(dist[::7]))
    dist[3::7] = rng.uniform(40, 80, len(dist[3::7]))
    yaw = rng.uniform(-np.pi, np.pi, batch)
    yaw[::3] = rng.uniform(-0.05, 0.05, len(yaw[::3]))
    if kind == "seam":
        ang = np.pi - rng.uniform(-0.05, 0.05, batch)
        yaw = rng.uniform(-0.03, 0.03, batch)  # the box orbits the origin by yaw: stay on it
    center = np.stack([dist * np.cos(ang), dist * np.sin(ang), rng.uniform(-1.5, 0.5, batch)], 1)
    size = np.array([4.2, 1.6, 1.5]) + rng.uniform(-0.5, 0.5, (batch, 3))
    if kind == "degenerate":
        size[0::4] = 0.0
        size[1::4, 0] = 0.0
        size[2::4, 1] = 0.0
        yaw[0::3] = rng.choice([0.0, np.pi, -np.pi], len(yaw[0::3]))
        center[5::8, :2] = 0.0  # on the axis
        center[7::8] = 0.0  # at the origin
    shape = (batch, spec.height, spec.width)
    image = np.zeros(shape + (channels,), f)
    if kind == "no_returns":
        image[..., 1] = spec.min_height
    else:
        image[..., 0] = rng.uniform(0, 40, shape) * (rng.random(shape) > 0.3)
        image[..., 1] = rng.uniform(-2, 2, shape)
        image[..., 2:] = rng.uniform(0, 1, shape + (channels - 2,))
    return center.astype(f), size.astype(f), yaw.astype(f), image


def _box_frame(d, h, ct, st, c, s, cphys):
    """The box-frame coordinates (qx, qy, qz) of returns at distance d and
    height h on columns with cos / sin ct, st, in float32 op by op as
    `geometry/encoding.py::box_surface_mask` computes them."""
    f = np.float32
    p0, p1 = d * ct, (-d) * st
    rel0, rel1, rel2 = p0 - cphys[0], p1 - cphys[1], h - cphys[2]
    return f(c) * rel0 + f(s) * rel1, f(-s) * rel0 + f(c) * rel1, rel2


def _ulp_steps(v: np.ndarray, k: int) -> np.ndarray:
    """(n,) float32 -> (n, 2k + 1): each value and its k float32 neighbours
    either side, in order."""
    f = np.float32
    out = [v]
    lo = hi = v
    for _ in range(k):
        lo, hi = np.nextafter(lo, f(-np.inf)), np.nextafter(hi, f(np.inf))
        out = [lo] + out + [hi]
    return np.stack(out, 1)


def _pick(q: np.ndarray, target: np.ndarray, out: np.ndarray) -> np.ndarray:
    """The candidate (column of q, (n, m), ordered by ulp step) whose q is
    the target, nearest the middle, else the largest below it ("on"); or
    the least above it ("out", a row of `out`). -1 where none is."""
    m = q.shape[1]
    order = np.argsort(np.abs(np.arange(m) - m // 2), kind="stable")  # nearest the middle first
    q, big = q[:, order].astype(np.float64), np.inf
    t = target[:, None]
    on = np.where(q == t, -big, np.where(q < t, t - q, big))  # 0-ranked: exact, then nearest below
    above = np.where(q > t, q - t, big)
    key = np.where(out[:, None], above, on)
    best = key.argmin(1)
    return np.where(np.isfinite(key[np.arange(len(best)), best]), order[best], -1)


def face_inputs(spec, batch: int = 32, seed: int = 0, channels: int = 3, steps: int = 16):
    """(center, size, yaw, image, case (B, H, W) int8): boxes 5-25 m away at
    yaw 0, pi and -pi (a quarter of them on the 360-degree seam), and on
    every column whose ray crosses a box, returns cycling through
    FACE_CASES by row and column (its code in `case`, -1 elsewhere): on
    the face where the ray enters or leaves the box dilated by 0.25 m,
    or on its top or bottom face, at the float32 distance or height
    (within `steps` ulps of the exact one) whose box-frame coordinate,
    computed as the plain version computes it, equals the half size
    ("on") or is the least value above it ("out"), the other coordinates
    inside; or inside the box. Centers and sizes are multiples of 1/256,
    so the half sizes and the faces' positions are exact. The other
    pixels are label_inputs' background."""
    import torch

    from tpufusion_torch.ops.label_encode import pixel_trig

    rng = np.random.default_rng(seed)
    f = np.float32
    ct, st = (t.numpy() for t in pixel_trig(spec, "cpu")[:2])
    yaw = np.array([0.0, np.pi, -np.pi], f)[np.arange(batch) % 3]
    with torch.inference_mode():
        cy, sy = (fn(torch.from_numpy(yaw)).numpy() for fn in (torch.cos, torch.sin))
    dist = rng.uniform(5, 25, batch)
    ang = rng.uniform(-np.pi, np.pi, batch)
    seam = np.arange(batch) % 4 == 1
    ang[seam] = np.pi - yaw[seam].astype(np.float64)  # Rz(yaw) @ center at azimuth pi
    center = np.stack([dist * np.cos(ang), dist * np.sin(ang), rng.uniform(-1.5, 0.5, batch)], 1)
    size = np.array([4.2, 1.6, 1.5]) + rng.uniform(-0.5, 0.5, (batch, 3))
    center, size = (np.round(a * 256).astype(f) / f(256) for a in (center, size))
    shape = (batch, spec.height, spec.width)
    image = np.zeros(shape + (channels,), f)
    image[..., 0] = rng.uniform(0, 40, shape) * (rng.random(shape) > 0.3)
    image[..., 1] = rng.uniform(-2, 2, shape)
    image[..., 2:] = rng.uniform(0, 1, shape + (channels - 2,))
    case = np.full(shape, -1, np.int8)
    u = np.stack([ct, -st]).astype(np.float64)  # each column's ray direction in x, y
    for b in range(batch):
        c, s = cy[b], sy[b]
        cphys = np.array([c * center[b, 0] - s * center[b, 1], s * center[b, 0] + c * center[b, 1],
                          center[b, 2]], f)
        half = size[b] * f(0.5) + f(0.25)
        # q = a t + o in the box frame along each column's ray; the x and y slabs
        rot = np.array([[c, s], [-s, c]], np.float64)
        a, o = rot @ u, -(rot @ cphys[:2].astype(np.float64))
        with np.errstate(divide="ignore", invalid="ignore"):
            t1, t2 = (-half[:2, None] - o[:, None]) / a, (half[:2, None] - o[:, None]) / a
        lo, hi = np.minimum(t1, t2), np.maximum(t1, t2)
        t_in, t_out = lo.max(0), hi.min(0)
        cols = np.nonzero((t_in > 0.5) & (t_out - t_in > 1e-3))[0]
        if not len(cols):
            continue
        rr, k = np.meshgrid(np.arange(spec.height), np.arange(len(cols)), indexing="ij")
        rr, k = rr.ravel(), k.ravel()
        col, code = cols[k], (rr + k) % len(FACE_CASES)
        ti, to = t_in[col], t_out[col]
        entry, exit_ = code < 2, (code >= 2) & (code < 4)
        d = np.where(entry, ti, np.where(exit_, to, (ti + to) / 2)).astype(f)
        h = center[b, 2] + (rng.uniform(-0.7, 0.7, len(rr)) * half[2]).astype(f)
        h = np.where((code == 4) | (code == 5), center[b, 2] + half[2], h)
        h = np.where((code == 6) | (code == 7), center[b, 2] - half[2], h).astype(f)
        axis = np.where(entry, lo[:, col].argmax(0), np.where(exit_, hi[:, col].argmin(0), 2))
        xy = axis.clip(0, 1)
        q_face = a[xy, col] * np.where(entry, ti, to) + o[xy]
        sign = np.where(axis == 2, np.where(code < 6, 1.0, -1.0), np.sign(q_face)).astype(f)
        # the search: the distance on an x or y face; on the top or bottom the
        # height center z +- each of the half size's float32 neighbours
        s_ = code < 8
        on_d = axis[s_] < 2
        dd = np.where(on_d[:, None], _ulp_steps(d[s_], steps), d[s_][:, None])
        hz = center[b, 2] + sign[s_][:, None] * _ulp_steps(np.full(len(dd), half[2]), steps)
        hh = np.where(on_d[:, None], h[s_][:, None], hz)
        q = np.stack(_box_frame(dd, hh, ct[col[s_]][:, None], st[col[s_]][:, None], c, s, cphys))
        q = q[axis[s_], np.arange(len(dd))] * sign[s_][:, None]  # the face's coordinate, outward
        pick = _pick(q, half[axis[s_]], code[s_] % 2 == 1)
        n = np.arange(len(dd))
        d[s_] = np.where(pick >= 0, dd[n, pick], d[s_])
        h[s_] = np.where(pick >= 0, hh[n, pick], h[s_])
        image[b, rr, col, 0] = d
        image[b, rr, col, 1] = h
        case[b, rr, col] = code
    return center, size, yaw, image, case


# The direct decode's clusters (`csrc/decode_direct.cu`), a frame kind a
# call: "edges" clusters on columns 0-1 and W-2..W-1 and on rows 0 and
# H-1; "narrow" a bbox under 5 wide (its back-projection window, shrunk
# by 2, is empty) with the centroid empty in every other frame, beside a
# car; "fallback" a car whose centroid has no return (the nearest valid
# pixel, with exact-distance ties, in raster order); "no_window" a car
# whose shrunk window has no return (the back-projection fails) and a
# cluster with no return at all (not found); "whole" one cluster over the
# whole frame at a near-constant distance (a window of H x W pixels and
# more gated points than the fit holds in shared memory); "cars" 3-5 cars
# of random sizes. Every kind but "edges" and "cars" has fewer clusters
# than a top-4 decode has lanes, so lanes go unfound.
CLUSTER_KINDS = ("edges", "narrow", "fallback", "no_window", "whole", "cars")


def cluster_inputs(spec, kind: str = "cars", batch: int = 4, seed: int = 0,
                   channels: int = 12) -> tuple[np.ndarray, np.ndarray]:
    """(y_pred (B, H, W, channels) float32 direct-head output, image (B,
    H, W, 3) float32) for the direct decode (`CLUSTER_KINDS`). A cluster
    is a block of probabilities 0.85-1 (0-0.3 elsewhere); its returns lie
    within 1.5 m of a base distance, its heads regress l w h near (4.2,
    1.6, 1.5) and one heading (local and global sin / cos, with noise);
    the background holds returns at 3-60 m, a fifth of them empty."""
    if kind not in CLUSTER_KINDS:
        raise ValueError(f"unknown cluster kind {kind!r}: one of {CLUSTER_KINDS}")
    rng = np.random.default_rng(seed)
    f = np.float32
    h, w = spec.height, spec.width
    shape = (batch, h, w)
    image = np.zeros(shape + (3,), f)
    image[..., 0] = rng.uniform(3, 60, shape) * (rng.random(shape) > 0.2)
    image[..., 1] = rng.uniform(-1.9, 1.0, shape)
    image[..., 2] = rng.uniform(0, 1, shape)
    y = np.zeros(shape + (channels,), f)
    y[..., 1] = rng.uniform(0, 0.3, shape)
    y[..., 2:5] = rng.uniform(-2, 2, shape + (3,))
    y[..., 5:8] = np.array([4.2, 1.6, 1.5]) + rng.normal(0, 0.1, shape + (3,))
    ang = rng.uniform(-np.pi, np.pi, shape + ((channels - 8) // 2,))
    y[..., 8::2], y[..., 9::2] = np.sin(ang), np.cos(ang)

    def car(b, r0, r1, c0, c1, dist=None):
        """Positives on rows r0..r1 x columns c0..c1 (the heat mask grows
        them by 2 up and left and 1 down and right), a car's returns."""
        sl = (b, slice(r0, r1 + 1), slice(c0, c1 + 1))
        n = (r1 - r0 + 1, c1 - c0 + 1)
        y[sl + (1,)] = rng.uniform(0.85, 1.0, n)
        yaw = rng.uniform(-np.pi, np.pi, (channels - 8) // 2)
        y[sl + (slice(8, None, 2),)] = np.sin(yaw) + rng.normal(0, 0.05, n + (len(yaw),))
        y[sl + (slice(9, None, 2),)] = np.cos(yaw) + rng.normal(0, 0.05, n + (len(yaw),))
        base = rng.uniform(5, 40) if dist is None else dist
        image[sl + (0,)] = base + rng.uniform(0, 1.5, n)
        image[sl + (1,)] = rng.uniform(-1.5, 0.5, n)

    for b in range(batch):
        if kind == "edges":
            car(b, 2, 8, 2, 10)  # mask from column 0
            car(b, 12, h - 8, w - 9, w - 1)  # to column W - 1
            car(b, 2, 4, w // 3, w // 3 + 20)  # from row 0
            car(b, h - 4, h - 1, w // 2, w // 2 + 20)  # to row H - 1
        elif kind == "narrow":
            c = int(rng.integers(100, w - 200))
            car(b, 8, 18, c, c)  # a mask 4 columns wide
            if b % 2 == 0:  # its centroid empty: the mask holds rows 8-17, columns c-2..c+1
                image[b, 12:14, c - 1:c + 1, 0] = 0.0
            car(b, 6, 14, c + 60, c + 100)
        elif kind == "fallback":
            c = int(rng.integers(100, w - 200))
            car(b, 8, 20, c, c + 40)
            cy, cx = (6 + 21) // 2, (c - 2 + c + 41) // 2
            rad = 1 + b % 3
            image[b, cy - rad:cy + rad + 1, cx - rad:cx + rad + 1, 0] = 0.0
        elif kind == "no_window":
            c = int(rng.integers(100, w - 300))
            car(b, 8, 20, c, c + 40)
            image[b, 6 + 2:21 - 1, c - 2 + 2:c + 41 - 1, 0] = 0.0  # the shrunk window, empty
            car(b, 6, 12, c + 150, c + 180)
            image[b, 4:14, c + 148:c + 182, 0] = 0.0  # a cluster with no return
        elif kind == "whole":
            y[b, ..., 1] = rng.uniform(0.85, 1.0, (h, w))
            image[b, ..., 0] = 10.0 + rng.uniform(0, 0.5, (h, w))
            image[b, ..., 1] = rng.uniform(-1.0, 0.5, (h, w))
        else:
            for _ in range(int(rng.integers(3, 6))):
                rows = int(rng.integers(3, max(4, h // 2)))
                r0 = int(rng.integers(0, h - rows))
                cols = int(rng.integers(5, 80))
                c0 = int(rng.integers(0, w - cols))
                car(b, r0, r0 + rows, c0, c0 + cols - 1)
    y[..., 0] = 1.0 - y[..., 1]
    return y.astype(f), image


def cluster_decode_options(channels: int) -> dict[str, dict]:
    """Every center, fit boundary and yaw frame the direct decode kernel
    covers, as DecodeConfig fields ({name: fields}) on the shipped
    assets' thresholds (min_prob 0.8, min_bbox_area 8); the auto yaw frame
    only with a dual-codec head's 12 channels."""
    frames = ("local", "global", "auto") if channels >= 12 else ("local", "global")
    base = {"min_prob": 0.8, "min_bbox_area": 8.0}
    out = {}
    for yaw_frame in frames:
        for center in ("backproject", "geometric", "surface", "consensus", "head"):
            out[f"{center}_{yaw_frame}"] = dict(base, direct_center=center,
                                                direct_yaw_frame=yaw_frame)
        for boundary, scale in (("circle", 0.8), ("ellipse", 0.9), ("box", 1.0), ("auto", 0.9)):
            out[f"fit_{boundary}_{yaw_frame}"] = dict(
                base, direct_center="fit", direct_yaw_frame=yaw_frame, fit_boundary=boundary,
                fit_surface_scale=scale)
    out["fit_auto_box_auto" if channels >= 12 else "fit_auto_box_local"] = dict(
        base, direct_center="fit", direct_yaw_frame=frames[-1], fit_boundary="auto",
        fit_boundary_oriented="box", fit_surface_scale=1.0)
    return out


# The threshold case of the direct decode on a low-precision head: a
# probability of exactly bf16(THRESHOLD_MIN_PROB) = 0.69921875 passes
# `prob >= 0.7` where the comparison runs in bf16, as the reference's and
# torch's do; a float32 threshold (0.7f) would drop it. In float16 the
# same holds of float16(0.8) = 0.7998046875 at min_prob 0.8 (float16(0.7)
# rounds up). THRESHOLDS: the head's type -> (min_prob, the probability at
# the threshold, the step below it).
THRESHOLD_MIN_PROB = 0.7
THRESHOLD_PROB = 0.69921875  # bf16(0.7)
THRESHOLD_BELOW = 0.6953125  # the bf16 step below it
THRESHOLDS = {"bfloat16": (THRESHOLD_MIN_PROB, THRESHOLD_PROB, THRESHOLD_BELOW),
              "float16": (0.8, 0.7998046875, 0.79931640625)}


def threshold_inputs(spec, seed: int = 0, channels: int = 10, dtype: str = "bfloat16"):
    """(y_pred (2, H, W, channels) float32 holding `dtype` values, image
    (2, H, W, 3), (row, column) of the pixel): `cluster_inputs`' cars of
    one frame rounded to `dtype`, twice; an interior car pixel with a
    return is THRESHOLDS[dtype]'s probability in frame 0 and the step
    below it in frame 1, which is otherwise frame 0. At its min_prob the
    pixel counts in frame 0 only."""
    _, at, below = THRESHOLDS[dtype]
    rnd = bf16_round if dtype == "bfloat16" else f16_round
    y, image = cluster_inputs(spec, "cars", batch=1, seed=seed, channels=channels)
    y = rnd(y)
    prob = y[0, ..., 1]
    inner = np.zeros(prob.shape, bool)
    inner[3:-3, 3:-3] = True
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            inner &= np.roll(prob, (dr, dc), axis=(0, 1)) >= 0.85
    inner &= (image[0, ..., 0] > 0) & (image[0, ..., 1] > spec.min_height)
    r, c = (int(v) for v in np.argwhere(inner)[0])
    y = np.concatenate([y, y])
    image = np.concatenate([image, image])
    y[0, r, c, 1], y[1, r, c, 1] = at, below
    y[:, r, c, 0] = rnd(1.0 - y[:, r, c, 1])
    return y, image, (r, c)


# The direct decode kernel's hand-made lanes (`crafted_lanes`): the CC's
# labels and extents written by hand, so a lane's window can be one the heat
# mask never makes, and each is checked against the plain version on the
# same inputs. Even frames: a one-pixel window; two rows of 700 columns
# (the kernel cuts a window into raster slices, one a CTA of the lane's
# cluster, so these rows straddle the CTAs); a block of the frame's last 20
# rows x its full width (36,020 pixels, more than any CTA's stage and the
# first design's 4,096-point list); a lane not found. Odd frames: a 5 x 60
# car with a hole; a one-pixel cluster below min_prob (no m: not found);
# a one-pixel cluster with no return (not found); a 2 x 2 block.
CRAFTED_MIN_PROB = 0.8  # cluster_decode_options' threshold


def crafted_lanes(spec, batch: int = 2, seed: int = 0, channels: int = 12):
    """(y_pred (B, H, W, channels), image (B, H, W, 3), mask (B, H, W)
    bool, labels, min_x, max_x, min_y, max_y (B, H, W) int32, root (B, 4)
    int64, found (B, 4) bool), numpy, for `decode_direct_clusters` and its
    plain version: the lanes described above on `cluster_inputs`' "cars"
    background (whose own positives no lane's mask holds)."""
    y, image = cluster_inputs(spec, "cars", batch=batch, seed=seed, channels=channels)
    rng = np.random.default_rng(seed + 1)
    h, w = spec.height, spec.width
    flat = np.arange(h * w, dtype=np.int32).reshape(h, w)
    mask = np.zeros((batch, h, w), bool)
    labels = np.broadcast_to(flat, (batch, h, w)).copy()
    rows, cols = np.indices((h, w), dtype=np.int32)
    min_x, max_x = (np.broadcast_to(cols, (batch, h, w)).copy() for _ in range(2))
    min_y, max_y = (np.broadcast_to(rows, (batch, h, w)).copy() for _ in range(2))
    root = np.zeros((batch, 4), np.int64)
    found = np.zeros((batch, 4), bool)

    def lane(b, j, r0, r1, c0, c1, prob=(0.85, 1.0), dist=None, hole=None):
        members = np.zeros((h, w), bool)
        members[r0:r1 + 1, c0:c1 + 1] = True
        if hole is not None:
            members[hole] = False
        n = int(members.sum())
        first = int(np.flatnonzero(members.reshape(-1))[0])
        mask[b] |= members
        labels[b][members] = first
        ys, xs = np.nonzero(members)
        min_x[b].reshape(-1)[first], max_x[b].reshape(-1)[first] = xs.min(), xs.max()
        min_y[b].reshape(-1)[first], max_y[b].reshape(-1)[first] = ys.min(), ys.max()
        y[b][members, 1] = rng.uniform(*prob, n)
        y[b][members, 0] = 1.0 - y[b][members, 1]
        yaw = rng.uniform(-np.pi, np.pi, (channels - 8) // 2)
        y[b][members, 8::2] = np.sin(yaw) + rng.normal(0, 0.05, (n, len(yaw)))
        y[b][members, 9::2] = np.cos(yaw) + rng.normal(0, 0.05, (n, len(yaw)))
        base = rng.uniform(5, 40) if dist is None else dist
        image[b][members, 0] = base + rng.uniform(0, 1.5, n)
        image[b][members, 1] = rng.uniform(-1.5, 0.5, n)
        root[b, j], found[b, j] = first, True

    for b in range(batch):
        if b % 2 == 0:
            lane(b, 0, 6, 6, 17 + b, 17 + b)
            lane(b, 1, 2, 3, 300, 999)
            lane(b, 2, h - 20, h - 1, 0, w - 1, prob=(0.75, 1.0), dist=10.0)
        else:
            lane(b, 0, 4, 8, 1200, 1259, hole=(slice(5, 7), slice(1220, 1225)))
            lane(b, 1, 12, 12, 400, 400, prob=(0.5, 0.6))
            lane(b, 2, 14, 14, 500, 500)
            image[b, 14, 500, 0] = 0.0
            lane(b, 3, 20, 21, 700, 701)
    return (y.astype(np.float32), image, mask, labels, min_x, max_x, min_y, max_y, root,
            found)


# The corner vote kernel's inputs (`csrc/corner_vote.cu`, `ops/corner_vote.py`):
# a corner-head output (B, H, W, 26), its image (B, H, W, 3), lanes' bboxes
# (B, n, 4), 3D centroids (B, n, 3) and the lanes to vote (B, n; frame 1's
# first lane left out where there are two frames). A frame's positives are
# placed column by column on its lanes' windows and on one column no
# window reaches, which holds a positive on every positive row, so each
# lane's candidate set (its window's positive columns x positive rows) is
# chosen exactly; its candidates' regressions are inverted from target
# corners (a 4.2 x 1.6 x 1.5 box about the centroid, moved as the kind
# says) through the plain version's rotation in float64. "edges" windows
# clipped at column 0, column W - 1, row 0 and row H - 1, with three rows
# and a column inside the windows without a positive; "budget" totals of
# 0, 64, 65, 2048 and 2049 candidates (K 64 and 2048 each see one exactly
# at K and one at K + 1); "ties" two and three equal groups 2.5 m apart
# (tied winners) beside one clear group; "duplicates" candidates with one
# target (d2 at rounding noise: undecided pairs) and half of them so;
# "threshold" two groups exactly max_bbox_dist apart (undecided pairs at
# 25); "far" candidates beyond far_delta beside valid ones, and a lane
# with none valid; "random" uniform regressions, as a seeded FCN gives.
CORNER_KINDS = ("edges", "budget", "ties", "duplicates", "threshold", "far", "random")
_CORNER_BOX = (4.2, 1.6, 1.5)


def _box_corners(yaw: float) -> np.ndarray:
    """(8, 3) float64 corners of the 4.2 x 1.6 x 1.5 box at `yaw` about 0,
    in the order of `geometry/boxes.py::box_corners_3d`."""
    l, w, h = _CORNER_BOX
    k = np.arange(8)  # geometry/boxes.py's corner order
    x = np.where(k < 4, -1, 1) * l / 2
    y = np.where(k % 4 < 2, 1, -1) * w / 2
    z = np.where(k % 2 == 0, 1, -1) * h / 2
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([c * x - s * y, s * x + c * y, z], axis=-1)


def _regressions(targets, rows, cols, image, spec) -> np.ndarray:
    """(m, 24) float32 regressions whose decoded corners are `targets`
    (m, 8, 3) at pixels (rows, cols): c' = R^T (c - p), float64."""
    theta = (cols + spec.x_min) * spec.res_h_rad
    phi = (rows + spec.y_min) * spec.res_v_rad
    ct, st, cp, sp = np.cos(theta), np.sin(theta), np.cos(phi), np.sin(phi)
    rot = np.stack([np.stack([ct * cp, -st, ct * sp], -1),
                    np.stack([st * cp, ct, st * sp], -1),
                    np.stack([-sp, np.zeros_like(sp), cp], -1)], -2)  # (m, 3, 3)
    d, h = image[rows, cols, 0].astype(np.float64), image[rows, cols, 1].astype(np.float64)
    p3 = np.stack([d * ct, -d * st, h], -1)
    reg = np.einsum("mji,mcj->mci", rot, targets - p3[:, None])
    return reg.reshape(len(rows), 24).astype(np.float32)


def _corner_lanes(kind: str, h: int, w: int, rng) -> list[tuple]:
    """(bbox [l, t, r, b], positive columns, target style) of a frame's
    lanes; the positive columns lie inside the lane's window (margins 100
    and 2) and no other lane's."""
    def cols_in(lo, hi, m):
        return np.sort(rng.choice(np.arange(lo, hi), m, replace=False))

    def spaced(j, style, top=8, bottom=16, m=60):
        l = 150 + 350 * j
        return ([l, top, l + 40, bottom], cols_in(l - 100, l + 140, m), style)

    if kind == "edges":
        return [([2, 6, 30, 14], np.r_[0, cols_in(1, 130, 40)], "cluster"),
                ([w - 31, 6, w - 3, 14], np.r_[cols_in(w - 130, w - 1, 40), w - 1], "cluster"),
                ([650, 0, 700, 5], cols_in(550, 800, 50), "cluster"),
                ([1050, h - 6, 1100, h - 1], cols_in(950, 1200, 50), "cluster")]
    if kind == "budget":
        return [([1600, 8, 1600, 16], np.zeros(0, int), "cluster"),  # total 0
                ([1100, 0, 1100, 2], cols_in(1000, 1200, 16), "cluster"),  # 4 rows x 16
                ([1350, 0, 1350, 3], cols_in(1250, 1450, 13), "cluster"),  # 5 x 13
                ([850, 10, 850, 22], cols_in(750, 950, 128), "cluster"),  # 16 x 128
                ([100, 0, 600, 1], cols_in(0, 700, 683), "cluster")]  # 3 x 683
    if kind == "ties":
        return [spaced(0, "ties2", m=60), spaced(1, "ties3", m=60), spaced(2, "cluster")]
    if kind == "duplicates":
        return [spaced(0, "dup", m=30), spaced(1, "halfdup", m=40)]
    if kind == "threshold":
        return [spaced(0, "threshold", m=50), spaced(1, "threshold", top=4, bottom=20, m=80)]
    if kind == "far":
        return [spaced(0, "far"), spaced(1, "allfar")]
    return [spaced(j, "random", top=int(rng.integers(0, h // 2)),
                   bottom=int(rng.integers(h // 2, h)), m=int(rng.integers(20, 120)))
            for j in range(3)]


def _targets(style: str, m: int, cols_of, rng) -> np.ndarray:
    """(m, 8, 3) target corners about 0 for a lane's m candidates
    (`cols_of` (m,) each candidate's column index in the lane's list)."""
    # a heading away from +-pi/2, where the pose's l and w divide by ~cos(yaw)
    base = _box_corners(float(rng.uniform(-1.3, 1.3) + np.pi * rng.integers(0, 2)))
    t = np.repeat(base[None], m, axis=0)
    if style == "cluster":
        t += rng.normal(0, 0.15, t.shape)
        out = rng.random(m) < 0.2
        t[out] += rng.normal(0, 1.2, (int(out.sum()), 8, 3))
    elif style in ("ties2", "ties3"):
        groups = 2 if style == "ties2" else 3
        t += rng.normal(0, 0.05, t.shape)
        t[..., 0] += 2.5 * (cols_of % groups)[:, None] - 2.5
    elif style == "dup":
        pass
    elif style == "halfdup":
        t[m // 2:] += rng.normal(0, 0.15, (m - m // 2, 8, 3))
    elif style == "threshold":
        t += rng.normal(0, 1e-4, t.shape)
        t += (cols_of % 2)[:, None, None] * 5.0 / np.sqrt(24.0)
    elif style == "far":
        t += rng.normal(0, 0.15, t.shape)
        far = rng.random(m) < 0.6
        t[far, int(rng.integers(0, 8)), 0] += 10.0
    elif style == "allfar":
        t[:, :, 1] += 3.5
    return t


def corner_inputs(spec, kind: str = "ties", batch: int = 2, seed: int = 0):
    """(y_pred (B, H, W, 26) float32, image (B, H, W, 3) float32, bbox (B,
    n, 4) int64, centroid_3d (B, n, 3) float32, lanes (B, n) bool) of one
    of CORNER_KINDS at the spec's size (margins and thresholds of
    DecodeConfig's defaults)."""
    if kind not in CORNER_KINDS:
        raise ValueError(f"unknown corner kind {kind!r}: one of {CORNER_KINDS}")
    rng = np.random.default_rng(seed)
    f = np.float32
    h, w = spec.height, spec.width
    shape = (batch, h, w)
    image = np.zeros(shape + (3,), f)
    image[..., 0] = rng.uniform(3, 60, shape) * (rng.random(shape) > 0.2)
    image[..., 1] = rng.uniform(-1.9, 1.0, shape)
    image[..., 2] = rng.uniform(0, 1, shape)
    y = np.zeros(shape + (26,), f)
    y[..., 1] = rng.uniform(0, 0.3, shape)
    y[..., 2:] = rng.uniform(-3, 3, shape + (24,))
    per_frame = [_corner_lanes(kind, h, w, rng) for _ in range(batch)]
    n = len(per_frame[0])
    bbox = np.zeros((batch, n, 4), np.int64)
    centroid = np.zeros((batch, n, 3), f)
    lanes = np.ones((batch, n), bool)
    if batch > 1:
        lanes[1, 0] = False
    skip = {3, 7, h - 3} if kind == "edges" else set()
    pos_rows = np.array([r for r in range(h) if r not in skip])
    cover = w - 50  # no window reaches it
    for b, frame in enumerate(per_frame):
        y[b, pos_rows, cover, 1] = 0.9
        for j, (box, cols, style) in enumerate(frame):
            bbox[b, j] = box
            if kind == "edges" and j == 0:
                cols = cols[cols != 17]  # a window column without a positive
            y[b, rng.choice(pos_rows, len(cols)), cols, 1] = rng.uniform(0.85, 1.0, len(cols))
            r_lo, r_hi = max(box[1] - 2, 0), min(box[3] + 2, h)
            rows = pos_rows[(pos_rows >= r_lo) & (pos_rows < r_hi)]
            cc, rr = np.repeat(np.arange(len(cols)), len(rows)), np.tile(rows, len(cols))
            pix_c = cols[cc]
            mid_c = int(np.clip((box[0] + box[2]) // 2, 0, w - 1))
            theta = (mid_c + spec.x_min) * spec.res_h_rad
            dist = float(rng.uniform(8, 30))
            centroid[b, j] = (dist * np.cos(theta), -dist * np.sin(theta),
                              float(rng.uniform(-1.0, 0.5)))
            if style == "random" or not len(cc):
                continue
            targets = _targets(style, len(cc), cc, rng) + centroid[b, j].astype(np.float64)
            y[b, rr, pix_c, 2:] = _regressions(targets, rr, pix_c, image[b], spec)
    y[..., 0] = 1.0 - y[..., 1]
    return y, image, bbox, centroid, lanes


def small_float_specials() -> np.ndarray:
    """float32 values at the small formats' edges: +-0, +-inf, NaNs of
    both signs, float32's extremes and subnormals, and for each format of
    `ops/small_float.py` its largest value, the midpoint above it (the
    overflow edge) and the float32 values either side, its smallest
    subnormal, half of it and the values either side, and exact ties
    between neighbouring values of every binade (and a float32 step
    either side of each)."""
    import torch

    from tpufusion_torch.ops.small_float import FORMATS, decode

    base = [0.0, -0.0, np.inf, -np.inf, np.nan, 3.4028235e38, 1.1754944e-38, 1e-45, 1e-40,
            2.0**-127, 1.5 * 2.0**-127, 0.75 * 2.0**-127]
    vals = [np.array(base, np.float32),
            np.array([0x7F800001, 0xFFC00000, 0xFFFFFFFF, 0x7FBFFFFF, 0x00400001, 0x005FFFFF],
                     np.uint32).view(np.float32)]
    for fmt in FORMATS.values():
        codes = np.arange(1 << (fmt.ebits + fmt.mbits + fmt.signed), dtype=np.int64)
        v = decode(torch.from_numpy(codes), fmt).numpy()
        v = np.unique(v[np.isfinite(v) & (v >= 0)]).astype(np.float64)
        mids = (v[:-1] + v[1:]) / 2  # ties, exact in float32
        top = v[-1] + (v[-1] - v[-2]) / 2
        edges = np.array([*mids, top, v[0] / 2, v[1] / 2, v[-1]], np.float32)
        vals += [edges, np.nextafter(edges, np.float32(np.inf)),
                 np.nextafter(edges, np.float32(0))]
    v = np.concatenate(vals)
    return np.concatenate([v, -v])


# (B, C, H, W) cotangent shapes of the small-float backward's parity sets:
# a row of windows with uneven padding (61 columns -> 64), more than 32
# frames (windows over the batch too) and a second level of windows (a
# width over 32 x 32)
SMALL_FLOAT_BACKWARD_SHAPES = ((2, 3, 32, 61), (33, 2, 3, 40), (1, 2, 1, 1100))


def small_float_backward_inputs(shape: tuple[int, int, int, int], seed: int = 0) -> dict:
    """Cotangents and a forward's output for the small-float backward, as
    numpy, each of `shape` (B, C, H, W): "f16", float16 from every bit
    pattern in a seeded order (NaNs of both signs, infinities, +-0,
    subnormals); "f32", float32 from `small_float_inputs` (the formats'
    edges and ties, then seeded values), cycled; "typical" and "wide",
    seeded normals at scales the formats hold (a convolution's sums and
    the format's values, the latter in (B, C + 2, H, 2 W) to be read as
    the strided view [:, 1:-1, :, ::2]); "small", normals whose sums stay
    in every format's range (finite bias gradients); "saved", a forward's
    output:
    the formats' values of both signs with +-0 and NaNs of both signs."""
    rng = np.random.default_rng(seed)
    b, c, h, w = shape
    n = b * c * h * w
    patterns, values = small_float_inputs(seed)
    f16 = rng.permutation(np.resize(patterns, max(n, len(patterns))))[:n].view(np.float16)
    f32 = np.resize(values, n)
    scale = np.exp2(rng.integers(-12, 8, n)).astype(np.float32)
    typical = (rng.standard_normal(n) * scale).astype(np.float32)
    small = (rng.standard_normal(n) * scale * 2.0**-8).astype(np.float32)
    wide = (rng.standard_normal((b, c + 2, h, 2 * w)) * 4).astype(np.float32)
    saved = (rng.standard_normal(n) * 3).astype(np.float32)
    saved[rng.random(n) < 0.1] = 0.0
    saved[rng.random(n) < 0.05] = -0.0
    saved[rng.random(n) < 0.02] = np.nan
    saved[rng.random(n) < 0.02] = -np.nan
    return {"f16": f16.reshape(shape), "f32": f32.reshape(shape),
            "typical": typical.reshape(shape), "small": small.reshape(shape), "wide": wide,
            "saved": saved.reshape(shape)}


def small_float_backward_cases(shape: tuple[int, int, int, int], device, seed: int = 0
                               ) -> list[tuple]:
    """[(label, cotangents, saved, relu)] of `small_float_backward_inputs`
    as tensors on `device`: one, two and three cotangents (the FCN's
    fan-outs), float16 and float32, contiguous and a strided view, with
    and without relu; all float16 (as the FCN's) and mixed."""
    import torch

    arrays = small_float_backward_inputs(shape, seed)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}
    view = t["wide"][:, 1:-1, :, ::2]
    return [("float16 patterns", [t["f16"]], None, False),
            ("float16 patterns, relu", [t["f16"]], t["saved"], True),
            ("float32 edges + float16 patterns, relu", [t["f32"], t["f16"]], t["saved"], True),
            ("typical + strided + edges, relu", [t["typical"], view, t["f32"]], t["saved"],
             True),
            ("strided + typical", [view, t["typical"]], None, False),
            ("small + small strided, relu", [t["small"], view * 2.0**-9], t["saved"], True),
            ("small", [t["small"]], None, False),
            ("small magnitudes", [t["small"].abs()], None, False),
            ("float16: patterns + small + a strided view, relu on float16",
             [t["f16"], t["small"].half(), (view * 2.0**-9).half()], t["saved"].half(), True),
            ("float16 small, relu on float16", [t["small"].half()], t["saved"].half(), True)]


# (B, C, H, W) shapes of the bias gradient's reduce alone: an odd window
# length with uneven padding at both ends (45 -> 64 columns), windows over
# more than 32 frames, a second level along the width, one column
SMALL_FLOAT_REDUCE_SHAPES = ((3, 8, 33, 45), (35, 8, 2, 7), (1, 8, 2, 1100), (2, 8, 32, 1))


def small_float_reduce_inputs(fmt, shape: tuple[int, int, int, int], seed: int = 0):
    """Adversarial values of the format `fmt` (`small_float.SmallFloat`)
    for the bias gradient's reduce, float32 (B, C, H, W), one kind a
    channel of the 8: seeded normals; mostly zeros of both signs (the
    steps the kernel skips); values near the largest (sums that overflow);
    the smallest values (subnormals); normals with one NaN; +inf then
    -inf; every code of the format, seeded order; normals whose sum
    cancels."""
    import torch

    from tpufusion_torch.ops.small_float import decode, round_small_float

    rng = np.random.default_rng(seed)
    b, c, h, w = shape
    n = b * h * w
    codes = np.arange(1 << (fmt.ebits + fmt.mbits + fmt.signed), dtype=np.int64)
    every = decode(torch.from_numpy(codes), fmt).numpy()
    finite = every[np.isfinite(every)]
    top, tiny = np.abs(finite).max(), np.abs(finite[finite != 0]).min()
    chans = [rng.standard_normal(n),
             np.where(rng.random(n) < 0.95, np.where(rng.random(n) < 0.5, 0.0, -0.0),
                      rng.standard_normal(n)),
             top * rng.uniform(0.5, 1.0, n) * np.sign(rng.standard_normal(n)),
             tiny * rng.integers(-3, 4, n),
             rng.standard_normal(n), rng.standard_normal(n) * 4,
             rng.permutation(np.resize(every, n)),
             rng.standard_normal(n)]
    chans[4][n // 2] = np.nan
    chans[5][n // 3], chans[5][2 * n // 3] = np.inf, -np.inf
    half = n // 2
    chans[7][half: 2 * half] = -chans[7][:half]
    x = np.stack([ch.reshape(b, h, w) for ch in chans[:c]], axis=1).astype(np.float32)
    return round_small_float(torch.from_numpy(x), fmt).numpy()


def small_float_inputs(seed: int = 0, n: int = 100_000) -> tuple[np.ndarray, np.ndarray]:
    """(every float16 bit pattern (65,536, uint16), float32 values:
    `small_float_specials` and n seeded values over float32's exponent
    range, many of them near the formats' ranges)."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, n) * np.where(rng.random(n) < 0.5, -1.0, 1.0)
    wide = rng.uniform(-150, 126.9, n // 4)
    near = rng.uniform(-30, 20, n - n // 4)
    x = (mant * np.exp2(np.concatenate([wide, near]))).astype(np.float32)
    return (np.arange(1 << 16, dtype=np.uint32).astype(np.uint16),
            np.concatenate([small_float_specials(), x]))
