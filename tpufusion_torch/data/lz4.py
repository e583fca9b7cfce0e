"""LZ4 block + frame codec (counterpart of `tpufusion/data/lz4.py`; no
external lz4 module).

Every public function runs the native codec (`tpufusion_torch/native/`,
built at first use; there is no fallback). The pure-Python versions
below, `*_reference`, are the plain versions the tests hold the native
codec against, and the format's documentation; nothing else calls them.

ROS1 bags with `compression=lz4` chunks use roslz4's streaming format,
which is the LZ4 Frame format (magic 0x184D2204): FLG/BD descriptor,
then blocks of <u32 size><data> where the size's high bit marks an
uncompressed block, terminated by a zero EndMark. Checksums (xxHash32)
are skipped, not validated — the bag format carries its own sizes.

The block codec implements the LZ4 sequence format: per sequence a
token byte (literal-length high nibble, match-length low nibble),
255-continuation length extensions, literals, little-endian u16 match
offset, and 4-added match length. The compressor is a greedy hash-chain
matcher — not ratio-optimal, but emits valid streams for the bag writer
and test fixtures.

Used by tpufusion_torch.data.rosbag_reader for lz4 bag chunks
(the reference reads them through the rosbag C library).
"""

from __future__ import annotations

import struct

from tpufusion_torch import native

LZ4_FRAME_MAGIC = 0x184D2204
_MIN_MATCH = 4
# spec: last match must start >= 12 bytes before block end; final 5 bytes
# of a block are always literals
_MFLIMIT = 12
_LAST_LITERALS = 5


def lz4_block_decompress(src: bytes, max_size: int | None = None) -> bytes:
    """One LZ4 block; a longer output than `max_size` raises."""
    return native.lz4_block_decompress(src, max_size)


def lz4_block_decompress_reference(src: bytes, max_size: int | None = None) -> bytes:
    dst = bytearray()
    _block_into(dst, src, max_size)
    return bytes(dst)


def _block_into(dst: bytearray, src: bytes,
                max_total: int | None = None) -> None:
    """Decode one LZ4 block appending to `dst`. Match offsets may reach
    back across earlier content of `dst` (a superset of block-independent
    decoding — also handles block-linked frames, where roslz4's streaming
    writer lets matches reference the previous 64 KB block). `max_total`
    bounds len(dst) after the append."""
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("lz4: literal run past end of input")
        dst += src[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence carries no match
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("lz4: zero match offset")
        mlen = token & 0xF
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += _MIN_MATCH
        start = len(dst) - offset
        if start < 0:
            raise ValueError("lz4: match offset before output start")
        if offset >= mlen:
            dst += dst[start : start + mlen]
        else:  # overlapping copy replicates the pattern byte-by-byte
            for k in range(mlen):
                dst.append(dst[start + k])
        if max_total is not None and len(dst) > max_total:
            raise ValueError("lz4: output exceeds declared size")


def _emit_length(dst: bytearray, extra: int) -> None:
    while extra >= 255:
        dst.append(255)
        extra -= 255
    dst.append(extra)


def _emit_sequence(
    dst: bytearray, src: bytes, anchor: int, pos: int, offset: int, mlen: int
) -> None:
    lit = pos - anchor
    token_lit = min(lit, 15)
    token_m = min(mlen - _MIN_MATCH, 15)
    dst.append((token_lit << 4) | token_m)
    if token_lit == 15:
        _emit_length(dst, lit - 15)
    dst += src[anchor:pos]
    dst += struct.pack("<H", offset)
    if token_m == 15:
        _emit_length(dst, mlen - _MIN_MATCH - 15)


def lz4_block_compress(src: bytes) -> bytes:
    return native.lz4_block_compress(src)


def lz4_block_compress_reference(src: bytes) -> bytes:
    """The greedy matcher without the native one's miss acceleration: its
    blocks differ from the native ones but decode to the same bytes."""
    n = len(src)
    dst = bytearray()
    if n == 0:
        dst.append(0)  # empty block: one zero token
        return bytes(dst)
    table: dict[bytes, int] = {}
    i, anchor = 0, 0
    limit = n - _MFLIMIT
    while i < limit:
        key = src[i : i + _MIN_MATCH]
        j = table.get(key, -1)
        table[key] = i
        if 0 <= j and i - j <= 0xFFFF:
            mlen = _MIN_MATCH
            stop = n - _LAST_LITERALS
            while i + mlen < stop and src[j + mlen] == src[i + mlen]:
                mlen += 1
            _emit_sequence(dst, src, anchor, i, i - j, mlen)
            i += mlen
            anchor = i
        else:
            i += 1
    # trailing literals
    lit = n - anchor
    token_lit = min(lit, 15)
    dst.append(token_lit << 4)
    if token_lit == 15:
        _emit_length(dst, lit - 15)
    dst += src[anchor:]
    return bytes(dst)


def lz4_frame_compress(data: bytes, block_size: int = 1 << 16) -> bytes:
    return native.lz4_frame_compress(data, block_size)


def lz4_frame_compress_reference(data: bytes, block_size: int = 1 << 16) -> bytes:
    out = bytearray(struct.pack("<I", LZ4_FRAME_MAGIC))
    flg = (1 << 6) | (1 << 5)  # version 01, block-independent, no checksums
    bd = 0x40  # block max size id 4 (64 KB)
    out += bytes([flg, bd])
    # header checksum byte: readers (incl. ours) skip it; xxh32 not computed
    out.append(0)
    for lo in range(0, max(len(data), 1), block_size):
        block = data[lo : lo + block_size]
        comp = lz4_block_compress_reference(block)
        if len(comp) < len(block):
            out += struct.pack("<I", len(comp)) + comp
        else:
            out += struct.pack("<I", len(block) | 0x80000000) + block
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)


def lz4_frame_decompress(data: bytes,
                         expected_size: int | None = None) -> bytes:
    """Decode a whole lz4 bag chunk. `expected_size` is the chunk
    record's declared uncompressed size: the native decoder allocates the
    output once and hard-bounds it (a lying header errors instead of
    allocating unbounded)."""
    return native.lz4_frame_decompress(data, expected_size)


def lz4_frame_decompress_reference(data: bytes,
                                   expected_size: int | None = None) -> bytes:
    if len(data) < 7:
        raise ValueError("lz4 frame too short")
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != LZ4_FRAME_MAGIC:
        raise ValueError(f"bad lz4 frame magic 0x{magic:08x}")
    flg = data[4]
    if flg >> 6 != 1:
        raise ValueError(f"unsupported lz4 frame version {flg >> 6}")
    block_checksum = (flg >> 4) & 1
    content_size = (flg >> 3) & 1
    pos = 6  # magic + FLG + BD
    if content_size:
        pos += 8
    pos += 1  # header checksum (not validated)
    out = bytearray()
    while pos + 4 <= len(data):
        (bsize,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if bsize == 0:
            break  # EndMark; content checksum may follow — ignored
        is_raw = bsize >> 31
        bsize &= 0x7FFFFFFF
        block = data[pos : pos + bsize]
        if len(block) != bsize:
            raise ValueError("lz4: truncated block")
        pos += bsize
        if is_raw:
            out += block
        else:
            _block_into(out, block, expected_size)
        if expected_size is not None and len(out) > expected_size:
            raise ValueError("lz4: output exceeds declared size")
        if block_checksum:
            pos += 4
    return bytes(out)
