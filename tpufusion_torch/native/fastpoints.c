/* fastpoints — the host codec of the bag reader, behind a plain C interface.
 *
 * The function bodies of tpufusion/native/fastpoints.c (the fused
 * PointCloud2 field unpack and the LZ4 block / frame codec) without the
 * CPython C API: no Python.h, every output buffer is owned by the caller,
 * and every function returns 0 or one of the FP_ERR_* codes below, which
 * the ctypes wrapper (tpufusion_torch/native/__init__.py) turns into the
 * exception and message the reference's extension raises. Built with
 * `cc -O3 -shared -fPIC` at first use; there is no fallback.
 *
 * An output capacity is a hard bound: a decoder that would write past it
 * stops with FP_ERR_OUTPUT_FULL. The wrapper passes a declared size (the
 * bag chunk record's) as the capacity, so a crafted high-expansion stream
 * errors out instead of allocating; without one it grows the buffer and
 * decodes again.
 */

#include <stdint.h>
#include <string.h>

enum {
  FP_OK = 0,
  FP_ERR_TOO_MANY_FIELDS = 1,     /* nf > FP_MAX_FIELDS */
  FP_ERR_FIELD_EXCEEDS_STEP = 2,  /* a field's offset + size > point_step */
  FP_ERR_DATA_SHORT = 3,          /* len < n * point_step */
  FP_ERR_TRUNC_LITERAL_LEN = 4,
  FP_ERR_LITERAL_PAST_END = 5,
  FP_ERR_OUTPUT_FULL = 6,         /* the output capacity would be exceeded */
  FP_ERR_TRUNC_MATCH_OFFSET = 7,
  FP_ERR_INVALID_OFFSET = 8,
  FP_ERR_TRUNC_MATCH_LEN = 9,
  FP_ERR_FRAME_SHORT = 10,
  FP_ERR_FRAME_MAGIC = 11,
  FP_ERR_FRAME_VERSION = 12,
  FP_ERR_TRUNC_BLOCK = 13,
  FP_ERR_BLOCK_SIZE = 14,         /* block_size <= 0 */
};

#define FP_MAX_FIELDS 16

/* PointField datatype codes (sensor_msgs/PointField) */
enum {
  PF_INT8 = 1, PF_UINT8 = 2, PF_INT16 = 3, PF_UINT16 = 4,
  PF_INT32 = 5, PF_UINT32 = 6, PF_FLOAT32 = 7, PF_FLOAT64 = 8
};

static inline float read_field(const uint8_t *p, int code) {
  switch (code) {
    case PF_INT8:    return (float)*(const int8_t *)p;
    case PF_UINT8:   return (float)*(const uint8_t *)p;
    case PF_INT16:   { int16_t v;  memcpy(&v, p, 2); return (float)v; }
    case PF_UINT16:  { uint16_t v; memcpy(&v, p, 2); return (float)v; }
    case PF_INT32:   { int32_t v;  memcpy(&v, p, 4); return (float)v; }
    case PF_UINT32:  { uint32_t v; memcpy(&v, p, 4); return (float)v; }
    case PF_FLOAT32: { float v;    memcpy(&v, p, 4); return v; }
    case PF_FLOAT64: { double v;   memcpy(&v, p, 8); return (float)v; }
    default:         return 0.0f;
  }
}

/* n points of point_step bytes -> out (n, nf) float32 rows; offset < 0
 * marks an absent field (a NaN column). */
int fp_unpack(const uint8_t *data, int64_t len, int64_t n, int64_t point_step,
              const int64_t *offsets, const int32_t *codes, int32_t nf,
              float *out) {
  static const int field_size[9] = {0, 1, 1, 2, 2, 4, 4, 4, 8};
  if (nf > FP_MAX_FIELDS) return FP_ERR_TOO_MANY_FIELDS;
  for (int32_t j = 0; j < nf; j++) {
    if (offsets[j] >= 0 &&
        (codes[j] < 1 || codes[j] > 8 ||
         offsets[j] + field_size[codes[j]] > point_step))
      return FP_ERR_FIELD_EXCEEDS_STEP;
  }
  if (n * point_step > len) return FP_ERR_DATA_SHORT;
  const float nanf_ = __builtin_nanf("");
  for (int64_t i = 0; i < n; i++) {
    const uint8_t *row = data + i * point_step;
    float *dst = out + i * nf;
    for (int32_t j = 0; j < nf; j++)
      dst[j] = offsets[j] < 0 ? nanf_ : read_field(row + offsets[j], codes[j]);
  }
  return FP_OK;
}

/* Decode one LZ4 block, appending to dst[*len:cap]. Match offsets may
 * reach back across earlier blocks in the same output (a superset of
 * block-independent streams; also decodes block-linked frames). */
static int lz4_block_into(const uint8_t *src, int64_t n, uint8_t *dst,
                          int64_t cap, int64_t *len) {
  int64_t i = 0, o = *len;
  int err = FP_OK;
  while (i < n) {
    unsigned token = src[i++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (i >= n) { err = FP_ERR_TRUNC_LITERAL_LEN; goto done; }
        b = src[i++];
        lit += b;
      } while (b == 255);
    }
    if (i + lit > n) { err = FP_ERR_LITERAL_PAST_END; goto done; }
    if (o + lit > cap) { err = FP_ERR_OUTPUT_FULL; goto done; }
    memcpy(dst + o, src + i, lit);
    o += lit;
    i += lit;
    if (i >= n) break; /* the last sequence has no match */

    if (i + 2 > n) { err = FP_ERR_TRUNC_MATCH_OFFSET; goto done; }
    int64_t off = src[i] | ((int64_t)src[i + 1] << 8);
    i += 2;
    if (off == 0 || off > o) { err = FP_ERR_INVALID_OFFSET; goto done; }
    int64_t mlen = token & 15;
    if (mlen == 15) {
      unsigned b;
      do {
        if (i >= n) { err = FP_ERR_TRUNC_MATCH_LEN; goto done; }
        b = src[i++];
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (o + mlen > cap) { err = FP_ERR_OUTPUT_FULL; goto done; }
    if (off >= mlen) {
      memcpy(dst + o, dst + o - off, mlen);
      o += mlen;
    } else {
      /* overlapping match: RLE-style byte copy */
      for (int64_t k = 0; k < mlen; k++, o++) dst[o] = dst[o - off];
    }
  }
done:
  *len = o;
  return err;
}

/* One LZ4 block -> dst[0:*out_len]. */
int fp_lz4_block_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                            int64_t cap, int64_t *out_len) {
  *out_len = 0;
  return lz4_block_into(src, n, dst, cap, out_len);
}

#define LZ4_FRAME_MAGIC 0x184D2204u

/* A roslz4 / LZ4-Frame stream: magic, FLG/BD, optional content size, the
 * header-checksum byte (skipped), then <u32 size><block> records (high bit
 * = stored raw) until the zero EndMark. Checksums are not validated. */
int fp_lz4_frame_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                            int64_t cap, int64_t *out_len) {
  *out_len = 0;
  if (n < 7) return FP_ERR_FRAME_SHORT;
  uint32_t magic;
  memcpy(&magic, src, 4);
  if (magic != LZ4_FRAME_MAGIC) return FP_ERR_FRAME_MAGIC;
  unsigned flg = src[4];
  if ((flg >> 6) != 1) return FP_ERR_FRAME_VERSION;
  int block_checksum = (flg >> 4) & 1;
  int64_t pos = 6;              /* magic + FLG + BD */
  if ((flg >> 3) & 1) pos += 8; /* content size */
  pos += 1;                     /* header checksum byte (not validated) */
  while (pos + 4 <= n) {
    uint32_t bsize;
    memcpy(&bsize, src + pos, 4);
    pos += 4;
    if (bsize == 0) break; /* EndMark; a content checksum is ignored */
    int is_raw = bsize >> 31;
    bsize &= 0x7FFFFFFFu;
    if (pos + (int64_t)bsize > n) return FP_ERR_TRUNC_BLOCK;
    if (is_raw) {
      if (*out_len + (int64_t)bsize > cap) return FP_ERR_OUTPUT_FULL;
      memcpy(dst + *out_len, src + pos, bsize);
      *out_len += bsize;
    } else {
      int err = lz4_block_into(src + pos, bsize, dst, cap, out_len);
      if (err) return err;
    }
    pos += bsize;
    if (block_checksum) pos += 4;
  }
  return FP_OK;
}

/* ---- the greedy block compressor (hash-table matcher): the last 5
 * bytes are literals, no match starts in the final 12. */

#define LZ4_HASH_LOG 14
#define LZ4_MFLIMIT 12
#define LZ4_LAST_LITERALS 5

static inline uint32_t lz4_hash4(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return (v * 2654435761u) >> (32 - LZ4_HASH_LOG);
}

static void emit_length(uint8_t *dst, int64_t *dl, int64_t extra) {
  while (extra >= 255) {
    dst[(*dl)++] = 255;
    extra -= 255;
  }
  dst[(*dl)++] = (uint8_t)extra;
}

/* The worst-case compressed size of n bytes: what dst must hold. */
int64_t fp_lz4_block_bound(int64_t n) { return n + n / 255 + 16; }

static int64_t block_compress(const uint8_t *src, int64_t n, uint8_t *dst) {
  int64_t dl = 0;
  if (n == 0) {
    dst[dl++] = 0; /* empty block: one zero token */
    return dl;
  }
  int32_t table[1 << LZ4_HASH_LOG];
  for (int64_t k = 0; k < (1 << LZ4_HASH_LOG); k++) table[k] = -1;
  int64_t i = 0, anchor = 0;
  int64_t limit = n - LZ4_MFLIMIT;
  /* miss acceleration: on low-match data (float noise) advance by a
   * growing stride instead of 1, the LZ4-fast scheme */
  int64_t misses = 0;
  while (i < limit) {
    uint32_t h = lz4_hash4(src + i);
    int64_t j = table[h];
    table[h] = (int32_t)i;
    if (j >= 0 && i - j <= 0xFFFF && memcmp(src + j, src + i, 4) == 0) {
      misses = 0;
      int64_t mlen = 4;
      int64_t stop = n - LZ4_LAST_LITERALS;
      while (i + mlen < stop && src[j + mlen] == src[i + mlen]) mlen++;
      int64_t lit = i - anchor;
      int64_t token_lit = lit < 15 ? lit : 15;
      int64_t token_m = (mlen - 4) < 15 ? (mlen - 4) : 15;
      dst[dl++] = (uint8_t)((token_lit << 4) | token_m);
      if (token_lit == 15) emit_length(dst, &dl, lit - 15);
      memcpy(dst + dl, src + anchor, lit);
      dl += lit;
      int64_t off = i - j;
      dst[dl++] = (uint8_t)(off & 0xFF);
      dst[dl++] = (uint8_t)(off >> 8);
      if (token_m == 15) emit_length(dst, &dl, mlen - 4 - 15);
      i += mlen;
      anchor = i;
    } else {
      i += 1 + (misses++ >> 6);
    }
  }
  int64_t lit = n - anchor; /* trailing literals */
  int64_t token_lit = lit < 15 ? lit : 15;
  dst[dl++] = (uint8_t)(token_lit << 4);
  if (token_lit == 15) emit_length(dst, &dl, lit - 15);
  memcpy(dst + dl, src + anchor, lit);
  dl += lit;
  return dl;
}

/* One LZ4 block of src[0:n]; dst holds fp_lz4_block_bound(n) bytes. */
int fp_lz4_block_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                          int64_t cap, int64_t *out_len) {
  *out_len = 0;
  if (cap < fp_lz4_block_bound(n)) return FP_ERR_OUTPUT_FULL;
  *out_len = block_compress(src, n, dst);
  return FP_OK;
}

/* The worst-case frame of n bytes in blocks of bs: header, a u32 and the
 * raw payload a block, the EndMark. */
int64_t fp_lz4_frame_bound(int64_t n, int64_t bs) {
  int64_t nblocks = n ? (n + bs - 1) / bs : 1;
  return 7 + nblocks * (4 + bs) + 4 + 64;
}

/* The frame layout of the reference's writer: version-01 FLG with the
 * block-independent bit, BD id 4, a zero header-checksum byte (readers
 * skip it), a block the smaller of compressed and raw, a zero EndMark.
 * scratch holds fp_lz4_block_bound(bs) bytes. */
int fp_lz4_frame_compress(const uint8_t *src, int64_t n, int64_t bs,
                          uint8_t *dst, int64_t cap, uint8_t *scratch,
                          int64_t *out_len) {
  *out_len = 0;
  if (bs <= 0) return FP_ERR_BLOCK_SIZE;
  if (cap < fp_lz4_frame_bound(n, bs)) return FP_ERR_OUTPUT_FULL;
  int64_t dl = 0;
  uint32_t magic = LZ4_FRAME_MAGIC;
  memcpy(dst + dl, &magic, 4);
  dl += 4;
  dst[dl++] = (1 << 6) | (1 << 5); /* version 01, block-independent */
  dst[dl++] = 0x40;                /* block max size id 4 (64 KB) */
  dst[dl++] = 0;                   /* header checksum placeholder */
  int64_t lo = 0;
  do {
    int64_t blen = (n - lo) < bs ? (n - lo) : bs;
    int64_t clen = block_compress(src + lo, blen, scratch);
    if (clen < blen) {
      uint32_t sz = (uint32_t)clen;
      memcpy(dst + dl, &sz, 4);
      dl += 4;
      memcpy(dst + dl, scratch, clen);
      dl += clen;
    } else {
      uint32_t sz = (uint32_t)blen | 0x80000000u;
      memcpy(dst + dl, &sz, 4);
      dl += 4;
      memcpy(dst + dl, src + lo, blen);
      dl += blen;
    }
    lo += bs;
  } while (lo < n);
  memset(dst + dl, 0, 4); /* EndMark */
  dl += 4;
  *out_len = dl;
  return FP_OK;
}
