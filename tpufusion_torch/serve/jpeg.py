"""Baseline JPEG encoder in numpy with integer arithmetic only: the port's
counterpart of `cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, 88])`,
which the live viewer (`serve/viewer.py`) needs on a host without OpenCV.

It writes what libjpeg(-turbo) writes through OpenCV at its defaults:
baseline JFIF 1.01, the IJG tables scaled to `quality` (limited to 8-bit
entries), the standard Huffman tables, one interleaved scan, no restart
markers. A (H, W, 3) BGR frame is Y, Cb, Cr with 2x2 / 1x1 / 1x1 sampling
(4:2:0); a (H, W) or (H, W, 1) frame is one grey component. The pixel
arithmetic is libjpeg's, term for term:

  * RGB -> YCbCr in 16-bit fixed point (`jccolor.c`);
  * 2x2 chroma averages with the alternating bias 1, 2, 1, 2, ...
    (`jcsample.c::h2v2_downsample`), edges replicated first;
  * the "islow" forward DCT (`jfdctint.c`, CONST_BITS 13, PASS1_BITS 2)
    and rounded division by 8 x the quantizer (`jcdctmgr.c`);
  * dummy blocks past a luma edge hold zeros and the previous block's DC
    (`jccoefct.c`).

Since every step is exact integer arithmetic, a frame gives the same bytes
on every machine. Each step works on all blocks at once: the DCT on a
(blocks, 8, 8) array, the Huffman symbols from the nonzero coefficients'
positions, the bits expanded and packed with `np.packbits`, 0xFF bytes
stuffed with `np.insert`.
"""

from __future__ import annotations

import numpy as np

# the IJG example tables (JPEG spec K.1), natural order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, np.int64)

# the standard Huffman tables (JPEG spec K.3): code counts by length 1-16, symbols
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107" "227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728" "292a3435363738393a43444546474849"
    "4a535455565758595a63646566676869" "6a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7" "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2" "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8" "f9fa"))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "00010203110405213106124151076171" "1322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a26" "2728292a35363738393a434445464748"
    "494a535455565758595a636465666768" "696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5" "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da" "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8" "f9fa"))

# zigzag position k -> natural (row-major) index (`jpeg_natural_order`)
_ZIGZAG = np.array(sorted(range(64), key=lambda i: (
    i // 8 + i % 8, i // 8 if (i // 8 + i % 8) % 2 else i % 8)), np.int64)

_CONST_BITS, _PASS1_BITS = 13, 2


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """`jpeg_set_quality(quality, force_baseline=TRUE)`: the base table
    scaled by libjpeg's quality curve, each entry in [1, 255]; natural
    order."""
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be in [1, 100], got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman_codes(table) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codes of a (counts, symbols) table -> (code, length)
    arrays indexed by symbol (`jchuff.c::jpeg_make_c_derived_tbl`)."""
    counts, symbols = table
    code_of, size_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for sym in symbols[k:k + n]:
            code_of[sym], size_of[sym] = code, length
            code += 1
        k += n
        code <<= 1
    return code_of, size_of


_DC_CODES = (_huffman_codes(_DC_LUMA), _huffman_codes(_DC_CHROMA))
_AC_CODES = (_huffman_codes(_AC_LUMA), _huffman_codes(_AC_CHROMA))


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One pass of `jpeg_fdct_islow` along the last axis of (..., 8)."""
    c = [d[..., i] for i in range(8)]
    tmp0, tmp7 = c[0] + c[7], c[0] - c[7]
    tmp1, tmp6 = c[1] + c[6], c[1] - c[6]
    tmp2, tmp5 = c[2] + c[5], c[2] - c[5]
    tmp3, tmp4 = c[3] + c[4], c[3] - c[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0], out[4] = (tmp10 + tmp11) << _PASS1_BITS, (tmp10 - tmp11) << _PASS1_BITS
        shift = _CONST_BITS - _PASS1_BITS
    else:
        out[0], out[4] = _descale(tmp10 + tmp11, _PASS1_BITS), _descale(tmp10 - tmp11, _PASS1_BITS)
        shift = _CONST_BITS + _PASS1_BITS
    z1 = (tmp12 + tmp13) * 4433  # FIX(0.541196100)
    out[2] = _descale(z1 + tmp13 * 6270, shift)  # FIX(0.765366865)
    out[6] = _descale(z1 - tmp12 * 15137, shift)  # FIX(1.847759065)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633  # FIX(1.175875602)
    tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return np.stack(out, axis=-1)


def _quantized_blocks(plane: np.ndarray, rows: int, cols: int, qtable: np.ndarray) -> np.ndarray:
    """A component plane -> (rows, cols, 64) quantized coefficients in
    zigzag order, the plane's edges replicated out to rows x cols blocks."""
    h, w = plane.shape
    padded = np.pad(plane, ((0, rows * 8 - h), (0, cols * 8 - w)), mode="edge")
    # int32 holds every intermediate (libjpeg's SIMD DCT works in 32 bits)
    blocks = padded.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).astype(np.int32) - 128
    coef = _fdct_pass(_fdct_pass(blocks, True).swapaxes(-1, -2), False).swapaxes(-1, -2)
    coef = coef.reshape(rows, cols, 64)[..., _ZIGZAG]
    div = (qtable[_ZIGZAG] << 3)  # the islow DCT leaves a factor of 8
    mag = (np.abs(coef) + (div >> 1)) // div
    return np.where(coef < 0, -mag, mag)


def _ycbcr(bgr: np.ndarray):
    """libjpeg's fixed-point RGB -> YCbCr (SCALEBITS 16)."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))  # sums < 2**31
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16
    return y, cb, cr


def _downsample_h2v2(plane: np.ndarray, out_rows: int, out_cols: int) -> np.ndarray:
    """2x2 averages with bias 1, 2, 1, 2, ... along each output row; the
    input's last row and column replicated to even size and out_cols * 2
    columns first, the output's last row to out_rows."""
    h, w = plane.shape
    p = np.pad(plane, ((0, h % 2), (0, out_cols * 2 - w)), mode="edge")
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.arange(out_cols) % 2 + 1
    out = (s + bias) >> 2
    return np.pad(out, ((0, out_rows - out.shape[0]), (0, 0)), mode="edge")


def _mcu_blocks(frame: np.ndarray, quality: int):
    """(blocks (N, 64) in scan order, table index per block (N,), SOF0
    component bytes, quant tables)."""
    h, w = frame.shape[:2]
    luma_q, chroma_q = quant_table(_LUMA_Q, quality), quant_table(_CHROMA_Q, quality)
    if frame.ndim == 2:
        blocks = _quantized_blocks(frame, -(-h // 8), -(-w // 8), luma_q).reshape(-1, 64)
        return blocks, np.zeros(len(blocks), np.int64), bytes([1, 0x11, 0]), [luma_q]
    y, cb, cr = _ycbcr(frame)
    mr, mc = -(-h // 16), -(-w // 16)  # MCUs of 16 x 16 pixels
    ry, cy = -(-h // 8), -(-w // 8)  # real luma blocks
    yb = np.zeros((2 * mr, 2 * mc, 64), np.int64)
    yb[:ry, :cy] = _quantized_blocks(y, ry, cy, luma_q)
    if cy % 2:  # dummy column at the right: the left neighbour's DC
        yb[:ry, cy, 0] = yb[:ry, cy - 1, 0]
    if ry % 2:  # dummy row at the bottom: the DC of its MCU's top-right block
        yb[ry, :, 0] = np.repeat(yb[ry - 1, 1::2, 0], 2)
    yb = yb.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mr, mc, 4, 64)
    chroma = [_quantized_blocks(_downsample_h2v2(c, mr * 8, mc * 8), mr, mc, chroma_q)[:, :, None]
              for c in (cb, cr)]
    blocks = np.concatenate([yb, *chroma], axis=2).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mr * mc)
    sof = bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    return blocks, comp, sof, [luma_q, chroma_q]


def _exclusive_cumsum(x: np.ndarray) -> np.ndarray:
    return np.cumsum(x) - x


def _nbits(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (the JPEG magnitude category)."""
    return np.searchsorted(1 << np.arange(16), np.abs(v), side="right")


def _entropy_coded(blocks: np.ndarray, comp: np.ndarray) -> bytes:
    """Huffman-coded scan data of (N, 64) zigzag blocks, each block coded
    with table 0 (component 0) or 1 (the others), DC predicted per
    component; padded with 1-bits and 0xFF-stuffed."""
    table = np.minimum(comp, 1)
    dc = blocks[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(dc[idx], prepend=0)

    # every code of the scan as (bits, length), in order; a coefficient's
    # code carries its magnitude bits (one's complement when negative)
    def with_bits(code, size, v, nb):
        extra = np.where(v < 0, v - 1, v) & ((1 << nb) - 1)
        return (code << nb) | extra, size + nb

    def lookup(codes, t, sym):
        (c0, s0), (c1, s1) = codes
        return np.where(t == 0, c0[sym], c1[sym]), np.where(t == 0, s0[sym], s1[sym])

    nb = _nbits(diff)
    dc_val, dc_len = with_bits(*lookup(_DC_CODES, table, nb), diff, nb)

    ac = blocks[:, 1:]
    blk, pos = np.nonzero(ac)  # row-major: by block, then zigzag position
    pos = pos + 1
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.roll(pos, 1))
    run = pos - prev - 1
    zrl = run >> 4
    v = ac[blk, pos - 1]
    nb = _nbits(v)
    ac_val, ac_len = with_bits(*lookup(_AC_CODES, table[blk], ((run & 15) << 4) | nb), v, nb)
    zrl_val, zrl_len = lookup(_AC_CODES, table[blk], np.full(len(blk), 0xF0))
    last = np.zeros(len(blocks), np.int64)
    last[blk] = pos
    eob = last < 63
    eob_val, eob_len = lookup(_AC_CODES, table, np.zeros(len(blocks), np.int64))

    # slots: a block's DC, then per nonzero its ZRLs and its code, then EOB
    per_event = zrl + 1
    events_in = np.bincount(np.repeat(blk, per_event), minlength=len(blocks))
    per_block = 1 + events_in + eob
    start = _exclusive_cumsum(per_block)
    ev_before = _exclusive_cumsum(events_in)
    ev_cum = _exclusive_cumsum(per_event)
    ev_start = start[blk] + 1 + ev_cum - ev_before[blk]
    total = int(per_block.sum())
    vals, lens = np.zeros(total, np.int64), np.zeros(total, np.int64)
    vals[start], lens[start] = dc_val, dc_len
    ac_at = ev_start + zrl
    vals[ac_at], lens[ac_at] = ac_val, ac_len
    zrl_at = np.repeat(ev_start, zrl) + np.arange(int(zrl.sum())) - np.repeat(
        _exclusive_cumsum(zrl), zrl)
    vals[zrl_at], lens[zrl_at] = np.repeat(zrl_val, zrl), np.repeat(zrl_len, zrl)
    eob_at = (start + per_block - 1)[eob]
    vals[eob_at], lens[eob_at] = eob_val[eob], eob_len[eob]

    # expand to bits (most significant first), pad with ones, pack, stuff
    nbits_total = int(lens.sum())
    item = np.repeat(np.arange(total), lens)
    offset = _exclusive_cumsum(lens)
    k = lens[item] - 1 - (np.arange(nbits_total) - offset[item])
    bits = ((vals[item] >> k) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-nbits_total % 8, np.uint8)])
    data = np.packbits(bits)
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _dht(tc: int, th: int, table) -> bytes:
    counts, symbols = table
    return _segment(0xC4, bytes([(tc << 4) | th, *counts]) + bytes(symbols))


def encode_jpeg(frame: np.ndarray, quality: int = 88) -> bytes:
    """A uint8 frame, (H, W), (H, W, 1) grey or (H, W, 3) BGR, as baseline
    JPEG bytes (what cv2.imencode(".jpg", frame, [IMWRITE_JPEG_QUALITY,
    quality]) writes with libjpeg's defaults)."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8 frames, got {frame.dtype}")
    if frame.ndim == 3 and frame.shape[2] == 1:
        frame = frame[..., 0]
    if not (frame.ndim == 2 or (frame.ndim == 3 and frame.shape[2] == 3)) or min(
            frame.shape[:2]) < 1 or max(frame.shape[:2]) > 65500:
        raise ValueError(f"unencodable frame shape {frame.shape}")
    h, w = frame.shape[:2]
    blocks, comp, sof_comps, qtables = _mcu_blocks(frame, quality)
    ncomp = len(sof_comps) // 3
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out += [_segment(0xDB, bytes([i]) + q[_ZIGZAG].astype(np.uint8).tobytes())
            for i, q in enumerate(qtables)]
    out.append(_segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                        + bytes([ncomp]) + sof_comps))
    out += [_dht(0, 0, _DC_LUMA), _dht(1, 0, _AC_LUMA)]
    if ncomp == 3:
        out += [_dht(0, 1, _DC_CHROMA), _dht(1, 1, _AC_CHROMA)]
        scan = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11])
    else:
        scan = bytes([1, 1, 0x00])
    out.append(_segment(0xDA, scan + bytes([0, 63, 0])))
    out += [_entropy_coded(blocks, comp), b"\xff\xd9"]
    return b"".join(out)
