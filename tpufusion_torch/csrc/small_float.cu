// The small-float rounding of the FCN for Hopper (sm_90a): a
// convolution's epilogue and the direct casts, in one pass each, bit for
// bit their plain PyTorch versions
// (tpufusion_torch/ops/small_float.py::conv_epilogue_reference and
// round_small_float).
//
// Ports no TPU kernel. The JAX package leaves these roundings to XLA:
// flax casts the input, kernel and bias to the format
// (promote_dtype), and XLA's optimized HLO for a convolution in the
// format rounds its float32 result to float16 and then to the format,
// adds the bias in float16 and rounds the sum to the format, then applies
// relu. Per element of y, a convolution's raw output (NCHW):
//
//   epilogue  r = fmt(h(y)); s = fmt(h(r + fmt(bias[c]))); relu?(s)
//   cast      fmt(x), written as values or as the format's codes
//
// h is the float16 rounding where the format goes through float16
// (every format but float8_e8m0fnu); relu(s) is max(s, fmt(0)) with NaN
// propagating (fmt(0) is a NaN in float8_e8m0fnu, which has no zero), and
// -0 gives +0. NaNs follow x86, whose rules XLA's CPU code (the
// reference) computes by: a NaN of the convolution enters as the
// default NaN (negative; cuDNN makes it positive), r + b returns r's
// NaN, else b's, and inf - inf the default NaN; every other step keeps
// a NaN's sign. The format's parameters arrive as a struct (`Fmt`, from
// small_float.py's table): the kernels branch on its fields, never on a
// name. fmt() is ml_dtypes' conversion, computed on float32's bits with
// integer ops: round to nearest, ties to even on the significand
// (float8_e8m0fnu's is its implicit bit alone, so its ties go up, and
// float32 subnormals, whose implicit bit is 0, round down), subnormals
// kept, NaN, infinity and overflow as the format says. Built without
// -ftz or fast math, so subnormals survive.
//
// What bounds it on the H100: bytes. The epilogue reads y (float32 or
// float16) and writes the values once (float32 or float16); at the
// shipped asset's 64 x 32 x 1801 batch the eight convolutions' outputs
// hold 92.5 M elements before the crops: float32 in and out is 740 MB,
// 221 us at 3.35 TB/s; float16 in and out (the FCN's float16
// convolutions), 370 MB, 110 us. The rounding is integer work, twice an
// element: done element by element it is bound by the card's integer
// rate (1.09 ms for those elements, 10 % of the byte bound). So a
// float16 y, the main path's, goes through two tables instead
// (epilogue_table_kernel): every float16 pattern's code (64 KB, built
// once a format and device by table_kernel, staged into each CTA's shared
// memory) and each code's output for the row's channel (computed by the
// CTA when its row changes), eight elements a thread a step in 16-byte
// loads and stores where a row's length allows (the FCN's 32 rows make it
// a multiple of eight). A float32 y (float8_e8m0fnu, whose values
// float16 cannot hold) takes the element-wise kernel: a CTA a (frame,
// channel) row, its threads striding the row, kUnroll elements in flight.
//
// The direct cast (cast_kernel) is bound by bytes too: at the input
// cast of 64 x 3 x 32 x 1804 float32 values into float16, 66.5 MB, 19.9 us
// at 3.35 TB/s. Its first design, a grid-stride loop of one element an
// iteration through the integer encode and decode, ran at the card's
// integer rate (96.6 us, 4.2x x.to(torch.float8_e4m3fn); PERF.md). The
// FCN's input is NHWC in memory and its convolutions take NCHW, so the
// cast is a tiled transpose: a CTA reads a tile of the channels-last
// input in 16-byte vectors into shared memory, converts it two elements a
// thread into the channels' planes in shared memory, and writes the
// planes in 16-byte vectors (a contiguous input is the one-channel case).
// float8_e4m3fn and float8_e5m2 round in Hopper's conversion
// (cvt.rn.satfinite.e4m3x2 / e5m2x2.f32, two elements an instruction, and
// cvt.rn.f16x2.e4m3x2 / e5m2x2 back), which is ml_dtypes' round to nearest
// even but saturates: NaN and overflow (e4m3fn past 464: NaN; e5m2 from
// 61440: infinity) are a select on the input. The other seven formats keep
// the integer encode, their values read from a 256-entry table in shared
// memory.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTable = 1 << 16;  // float16 bit patterns
constexpr int kChunk = 8192;  // elements of a row a CTA takes at a time
constexpr int kTableSmem = kTable + 256 * 4;  // the code table and a row's values

struct Fmt {
  int ebits, mbits, bias, sign_bit, neg_zero, subnormals, max_code, has_nan,
      nan_code, nan_signed, inf_code, overflow;  // overflow: 0 inf, 1 nan, 2 saturate
};

__device__ __forceinline__ uint32_t encode(float x, const Fmt& f) {
  uint32_t bits = __float_as_uint(x);
  bool neg = bits >> 31;
  uint32_t a = bits & 0x7FFFFFFFu;
  uint32_t sign = neg ? (uint32_t)f.sign_bit : 0u;
  uint32_t nan_code = (uint32_t)f.nan_code ^ (f.nan_signed ? sign : 0u);
  if (a > 0x7F800000u) return nan_code;
  uint32_t over = f.overflow == 0 ? ((uint32_t)f.inf_code | sign)
                  : f.overflow == 1 ? nan_code
                                    : ((uint32_t)f.max_code | sign);
  if (a == 0x7F800000u) return over;
  if (f.sign_bit == 0 && (neg || a == 0)) return nan_code;  // no negatives, no zero
  uint32_t code = 0;
  if (a != 0 && f.subnormals) {
    int e;
    uint32_t m24;  // the significand in [2^23, 2^24), x = m24 2^(e - 23)
    if (a >= 0x800000u) {
      e = (int)(a >> 23) - 127;
      m24 = (a & 0x7FFFFFu) | 0x800000u;
    } else {
      int lz = __clz(a) - 8;
      m24 = a << lz;
      e = -126 - lz;
    }
    int emin = 1 - f.bias;
    int t = max(e, emin);  // the exponent the result is quantised at
    int shift = min(23 - f.mbits + t - e, 30);
    uint32_t odd = (m24 >> shift) & 1u;
    uint32_t q = (m24 + (1u << (shift - 1)) - 1u + odd) >> shift;
    code = ((uint32_t)(t - emin) << f.mbits) + q;
  } else if (a != 0) {  // float32's exponent field
    int shift = 23 - f.mbits;
    uint32_t lsb = ((a | (a >= 0x800000u ? 0x800000u : 0u)) >> shift) & 1u;
    code = (a + (1u << (shift - 1)) - 1u + lsb) >> shift;
  }
  if (code > (uint32_t)f.max_code) return over;
  if (f.sign_bit == 0) return code;
  return (code == 0 && !f.neg_zero) ? 0u : (code | sign);
}

__device__ __forceinline__ float nan_of(bool neg) {
  return __uint_as_float(neg ? 0xFFC00000u : 0x7FC00000u);
}

__device__ __forceinline__ float decode(uint32_t c, const Fmt& f) {
  uint32_t sb = (uint32_t)f.sign_bit;
  uint32_t mag = c & ~sb;
  bool neg = (c & sb) != 0;
  if (f.has_nan && ((mag > (uint32_t)f.max_code && (int)mag != f.inf_code) ||
                    (int)c == f.nan_code))
    return nan_of(f.nan_signed && neg);
  uint32_t bits;
  if ((int)mag == f.inf_code) {
    bits = 0x7F800000u;
  } else {
    uint32_t field = mag >> f.mbits, m = mag & ((1u << f.mbits) - 1u);
    if (field == 0 && f.subnormals) {  // m 2^(1 - bias - mbits), exact
      bits = __float_as_uint((float)m * __uint_as_float((uint32_t)(128 - f.bias - f.mbits) << 23));
    } else {
      int fe = (int)field - f.bias + 127;
      uint32_t sig = 0x800000u | (m << (23 - f.mbits));
      bits = fe >= 1 ? (((uint32_t)fe << 23) | (sig & 0x7FFFFFu)) : (sig >> (1 - fe));
    }
  }
  return __uint_as_float(bits | (neg ? 0x80000000u : 0u));
}

// float16 rounding, NaN passed through with its sign
__device__ __forceinline__ float h16(float x) {
  return isnan(x) ? x : __half2float(__float2half_rn(x));
}

__device__ __forceinline__ float load(const float* p, int64_t i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __half* p, int64_t i) {
  unsigned short b = __half_as_ushort(p[i]);  // a NaN: a quiet NaN of its sign
  if ((b & 0x7FFFu) > 0x7C00u) return nan_of(b & 0x8000u);
  return __half2float(p[i]);
}

__device__ __forceinline__ void store(float* p, int64_t i, float v, uint32_t) { p[i] = v; }
__device__ __forceinline__ void store(__half* p, int64_t i, float v, uint32_t) {
  p[i] = isnan(v) ? __ushort_as_half((unsigned short)(signbit(v) ? 0xFE00u : 0x7E00u))
                  : __float2half_rn(v);  // exact: the value is the format's
}
__device__ __forceinline__ void store(uint8_t* p, int64_t i, float, uint32_t code) {
  p[i] = (uint8_t)code;
}

// eight values to 16-byte aligned outputs
__device__ __forceinline__ void store8(float* p, int64_t i, const float* v) {
  ((float4*)(p + i))[0] = make_float4(v[0], v[1], v[2], v[3]);
  ((float4*)(p + i))[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__half* p, int64_t i, const float* v) {
  uint4 w;
  unsigned short* h = (unsigned short*)&w;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    __half x;
    store(&x, 0, v[e], 0u);
    h[e] = __half_as_ushort(x);
  }
  *(uint4*)(p + i) = w;
}

__device__ __forceinline__ float round_fmt(float x, const Fmt& f, bool via) {
  return decode(encode(via ? h16(x) : x, f), f);
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads) epilogue_kernel(
    const In* __restrict__ y, const float* __restrict__ bias, Out* __restrict__ out,
    int rows, int channels, int hw, Fmt f, int via_f16, int relu) {
  bool via = via_f16 != 0;
  float zero = decode(encode(0.0f, f), f);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    float b = round_fmt(bias[row % channels], f, false);
    int64_t base = (int64_t)row * hw;
    int step = kThreads * gridDim.x;
    for (int j0 = blockIdx.x * kThreads + threadIdx.x; j0 < hw; j0 += step * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int j = j0 + u * step;
        v[u] = j < hw ? load(y, base + j) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int j = j0 + u * step;
        if (j >= hw) break;
        float r = round_fmt(isnan(v[u]) ? nan_of(true) : v[u], f, via);
        float sum = __fadd_rn(r, b);
        if (isnan(sum)) sum = isnan(r) ? r : isnan(b) ? b : nan_of(true);
        float s = round_fmt(sum, f, via);
        if (relu) s = isnan(zero) ? zero : (s > 0.0f || isnan(s)) ? s : zero;
        store(out, base + j, s, 0u);
      }
    }
  }
}

// The float16 input's codes: for every float16 bit pattern, the code of
// fmt(y) (a NaN as the default NaN), the epilogue's first rounding.
__global__ void __launch_bounds__(kThreads) table_kernel(Fmt f, uint8_t* __restrict__ table) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= kTable) return;
  __half h = __ushort_as_half((unsigned short)i);
  float v = __hisnan(h) ? nan_of(true) : __half2float(h);
  table[i] = (uint8_t)encode(v, f);
}

// The epilogue of a float16 y in a format that goes through float16: the
// first rounding is the code table (in shared memory), the rest depends
// on the code and the channel alone, so a (frame, channel) row's 2^bits
// outputs are computed once into shared memory and each element is two
// lookups. Each CTA takes a contiguous run of kChunk-element pieces of
// rows, so it rebuilds the value table about once a row.
template <typename Out>
__global__ void __launch_bounds__(kThreads) epilogue_table_kernel(
    const __half* __restrict__ y, const float* __restrict__ bias,
    const uint8_t* __restrict__ table, Out* __restrict__ out, int rows, int channels, int hw,
    int64_t per_cta, Fmt f, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* codes = smem;
  float* values = (float*)(smem + kTable);
  for (int i = threadIdx.x; i < kTable / 16; i += kThreads)
    ((uint4*)codes)[i] = __ldg((const uint4*)table + i);
  float zero = decode(encode(0.0f, f), f);
  int ncodes = 1 << (f.ebits + f.mbits + (f.sign_bit ? 1 : 0));
  int pieces = (hw + kChunk - 1) / kChunk;
  bool vec = hw % 8 == 0 && ((uintptr_t)y % 16) == 0 && ((uintptr_t)out % 16) == 0;
  int64_t first = (int64_t)blockIdx.x * per_cta;
  int64_t last = min(first + per_cta, (int64_t)rows * pieces);
  int cur = -1;
  for (int64_t it = first; it < last; ++it) {
    int row = (int)(it / pieces);
    if (row != cur) {  // uniform across the CTA
      __syncthreads();
      float b = round_fmt(bias[row % channels], f, false);
      for (int c = threadIdx.x; c < ncodes; c += kThreads) {
        float r = decode((uint32_t)c, f);
        float sum = __fadd_rn(r, b);
        if (isnan(sum)) sum = isnan(r) ? r : isnan(b) ? b : nan_of(true);
        float s = round_fmt(sum, f, true);
        if (relu) s = isnan(zero) ? zero : (s > 0.0f || isnan(s)) ? s : zero;
        values[c] = s;
      }
      __syncthreads();
      cur = row;
    }
    int64_t base = (int64_t)row * hw;
    int j0 = (int)(it % pieces) * kChunk, end = min(j0 + kChunk, hw);
    if (vec) {  // 8 elements a thread a step: 16-byte loads, kUnroll in flight
      for (int j = j0 + threadIdx.x * 8; j < end; j += kThreads * 8 * kUnroll) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          int k = j + u * kThreads * 8;
          if (k < end) v[u] = __ldg((const uint4*)(y + base + k));
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          int k = j + u * kThreads * 8;
          if (k >= end) break;
          const unsigned short* h = (const unsigned short*)&v[u];
          float o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = values[codes[h[e]]];
          store8(out, base + k, o);
        }
      }
      continue;
    }
    for (int j = j0 + threadIdx.x; j < end; j += kThreads * kUnroll) {
      unsigned short v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int k = j + u * kThreads;
        v[u] = k < end ? __half_as_ushort(y[base + k]) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int k = j + u * kThreads;
        if (k < end) store(out, base + k, values[codes[v[u]]], 0u);
      }
    }
  }
}

// ---- the direct cast ------------------------------------------------------

constexpr int kCastTile = 4096;  // input elements a CTA stages at a time
enum CastMode { kGeneric = 0, kE4M3 = 1, kE5M2 = 2 };  // which conversion rounds

// a staged element as float32 (a float16 NaN: a quiet NaN of its sign, as `load`)
__device__ __forceinline__ float staged(float v) { return v; }
__device__ __forceinline__ float staged(__half v) {
  unsigned short b = __half_as_ushort(v);
  return (b & 0x7FFFu) > 0x7C00u ? nan_of(b & 0x8000u) : __half2float(v);
}

// two float32 -> two codes of float8_e4m3fn or float8_e5m2 in Hopper's
// conversion (lo in the low byte), saturating
template <int Mode>
__device__ __forceinline__ uint32_t cvt_pair(float lo, float hi) {
  unsigned short r;
  if (Mode == kE4M3)
    asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;" : "=h"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;" : "=h"(r) : "f"(hi), "f"(lo));
  return r;
}

// two codes (lo in the low byte) -> their values as two float16 (exact)
template <int Mode>
__device__ __forceinline__ uint32_t cvt_back(uint32_t pair) {
  uint32_t r;
  unsigned short a = (unsigned short)pair;
  if (Mode == kE4M3)
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(r) : "h"(a));
  else
    asm("cvt.rn.f16x2.e5m2x2 %0, %1;" : "=r"(r) : "h"(a));
  return r;
}

// two elements' codes and values: Hopper's conversion with ml_dtypes' NaN
// and overflow selected in, or the integer encode and the value table
template <int Mode>
__device__ __forceinline__ void convert2(const float x[2], uint32_t c[2], float v[2],
                                         const Fmt& f, const float* values) {
  if (Mode == kGeneric) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      c[k] = encode(x[k], f);
      v[k] = values[c[k]];
    }
    return;
  }
  uint32_t pair = cvt_pair<Mode>(x[0], x[1]);
  uint32_t halves = cvt_back<Mode>(pair);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    uint32_t bits = __float_as_uint(x[k]), sign = bits >> 31, a = bits & 0x7FFFFFFFu;
    uint32_t code = (pair >> (8 * k)) & 0xFFu;
    float val = __half2float(__ushort_as_half((unsigned short)(halves >> (16 * k))));
    // ml_dtypes: a NaN keeps its sign; e4m3fn overflows (past 464, its
    // midpoint to 480) to NaN, e5m2 (from 61440, its midpoint to 65536,
    // ties to even) to infinity
    bool over = Mode == kE4M3 ? a > 0x43E80000u : a >= 0x47700000u;
    if (a > 0x7F800000u) {
      code = (uint32_t)f.nan_code ^ (sign << 7);
      val = nan_of(sign);
    } else if (over) {
      code = Mode == kE4M3 ? ((uint32_t)f.nan_code | (sign << 7)) : (0x7Cu | (sign << 7));
      val = Mode == kE4M3 ? nan_of(sign) : __uint_as_float(0x7F800000u | (sign << 31));
    }
    c[k] = code;
    v[k] = val;
  }
}

// `bytes` bytes from shared memory to global memory, 16 at a time where
// `vec` (both 16-byte aligned), the rest one at a time
__device__ __forceinline__ void copy_out(unsigned char* dst, const unsigned char* src,
                                         int bytes, int vec) {
  int nv = vec ? bytes / 16 : 0;
  for (int i = threadIdx.x; i < nv; i += kThreads) ((uint4*)dst)[i] = ((const uint4*)src)[i];
  for (int i = nv * 16 + threadIdx.x; i < bytes; i += kThreads) dst[i] = src[i];
}

// x (B, N, C) -> out (B, C, N): a channels-last tensor (the FCN's NHWC
// input, N = H W) cast into its channels-first layout, a contiguous one
// with B = C = 1. A CTA takes tiles of T places along N of one b (T * C
// <= kCastTile), grid-stride: (A) the tile's T * C contiguous inputs,
// fetched into registers in 16-byte vectors while the last tile was
// converted, go to shared memory; (B) they are converted two a thread at a
// time, lanes along N (a stride of C elements in shared memory: no bank
// conflicts for an odd C), into C planes of T outputs in shared memory;
// (C) each plane is written to its place in out in 16-byte vectors. `vec`
// (the launch's check) says every tile's input and output runs start
// 16-byte aligned; without it every access is one element.
template <typename In, typename Out, int Mode>
__global__ void __launch_bounds__(kThreads) cast_kernel(
    const In* __restrict__ x, Out* __restrict__ out, int B, int64_t N, int C, int T, Fmt f,
    int vec) {
  constexpr int kPer = kCastTile * (int)sizeof(In) / 16 / kThreads;  // vectors a thread a tile
  __shared__ __align__(16) In tile_in[kCastTile];
  __shared__ __align__(16) Out tile_out[kCastTile];
  __shared__ float values[256];  // the generic path's code -> value
  if (Mode == kGeneric) {
    int ncodes = 1 << (f.ebits + f.mbits + (f.sign_bit ? 1 : 0));
    for (int c = threadIdx.x; c < ncodes; c += kThreads) values[c] = decode((uint32_t)c, f);
  }
  int64_t per_b = (N + T - 1) / T, tiles = (int64_t)B * per_b;
  uint4 next[kPer];
  auto fetch = [&](int64_t tile) {  // the tile's whole vectors into `next`
    int64_t b = tile / per_b, n0 = (tile - b * per_b) * T;
    int nv = (int)min((int64_t)T, N - n0) * C * (int)sizeof(In) / 16;
    const uint4* src = (const uint4*)(x + (b * N + n0) * C);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (threadIdx.x + k * kThreads < nv) next[k] = __ldg(src + threadIdx.x + k * kThreads);
  };
  if (vec && blockIdx.x < tiles) fetch(blockIdx.x);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int64_t b = tile / per_b, n0 = (tile - b * per_b) * T;
    int t = (int)min((int64_t)T, N - n0), cnt = t * C;
    const In* src = x + (b * N + n0) * C;
    int nv = vec ? cnt * (int)sizeof(In) / 16 : 0;
    __syncthreads();  // the last tile's planes are out (and the value table in)
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (threadIdx.x + k * kThreads < nv) ((uint4*)tile_in)[threadIdx.x + k * kThreads] = next[k];
    for (int i = nv * 16 / (int)sizeof(In) + threadIdx.x; i < cnt; i += kThreads)
      tile_in[i] = src[i];
    __syncthreads();
    if (vec && tile + gridDim.x < tiles) fetch(tile + gridDim.x);  // in flight during (B), (C)
    for (int c = 0; c < C; ++c)
      for (int j = threadIdx.x; j < t; j += 2 * kThreads) {
        int j2 = j + kThreads;
        float xs[2] = {staged(tile_in[j * C + c]), j2 < t ? staged(tile_in[j2 * C + c]) : 0.0f};
        uint32_t cs[2];
        float vs[2];
        convert2<Mode>(xs, cs, vs, f, values);
        store(tile_out, c * t + j, vs[0], cs[0]);
        if (j2 < t) store(tile_out, c * t + j2, vs[1], cs[1]);
      }
    __syncthreads();
    for (int c = 0; c < C; ++c)
      copy_out((unsigned char*)(out + (b * C + c) * N + n0),
               (const unsigned char*)(tile_out + c * t), t * (int)sizeof(Out), vec);
  }
}

// ---- backward ----------------------------------------------------------
//
// The epilogue's gradient, one wrapper call a layer (small_float.py,
// conv_epilogue_backward_reference): up to kMaxGrads cotangents of the
// layer's output g_i (raw convolution results or the format's values, any
// strides) are rounded r(t) = fmt(h(t)) and summed in order, each sum
// rounded, relu selects the sum where the forward's value is > 0 (else
// fmt(0)), and the result is written in the carrier; the bias gradient
// reduces it over batch, height and width in XLA's order
// (xla_sum_levels: windows of 32 along each dimension over 32, padded
// evenly, again until none is, each window row-major), every partial sum
// rounded to the format, from fmt(0) (a NaN in float8_e8m0fnu, as XLA's
// initial 0 converted). Each step of that reduce is one lookup of
// fmt(h(acc + x)) in the format's add table (codes x codes, built once a
// format and device by add_table_kernel), staged into shared memory.
// With one cotangent, no relu and no bias it is the no-bias rounding of a
// dgrad or wgrad, fmt(h(g)). The reduce alone (tf_small_float_bias_grad)
// also takes any values of the format with their strides: a mesh's block
// of a layer's cotangent (models/fcn.py).
//
// What bounds it on the H100: not bytes. The cotangent pass reads each
// cotangent and the forward's value once and writes the result (at a
// train step of the asset at 32 x 32 x 1801, 46 M elements in 8 layers:
// 0.094 ms of bytes), integer arithmetic on registers at full occupancy.
// The reduce is a chain of dependent steps: XLA's first window at 32
// frames is 32 x 32 x 32 elements, 32,768 steps in order, and the asset's
// layers give only 96-570 such chains. The first design walked each chain
// in one thread (~75 cycles a step, 1.2-1.4 ms a layer whatever the
// card's width; 10.3 ms a step, PERF.md). The format's addition is not
// associative, but each step is a map acc -> add[acc][x] on the format's
// <= 256 codes, and maps compose. So each chain is cut into segments
// that run side by side, a warp a segment, each carrying every possible
// start code to its end code (the enumerative method of Mytkowicz,
// Musuvathi and Schulte, "Data-parallel finite-state machines", ASPLOS
// 2014): lane l holds the codes that started as l, l + 32, ...; every
// step, every lane looks up its codes' successors in the row of x, the
// table laid out x-major (add[x][acc]) so the lanes of a warp read
// neighbouring bytes. The start codes do not merge on the asset's
// cotangents (a chain's large codes are fixed points of its small steps:
// 255.7-256 of 256 still distinct at a segment's end on an H100, PERF.md),
// so a step costs n lookups where the chain's cost one: 256 for the
// 8-bit formats. Adding 0 maps every code to itself but -0, which no
// chain holds (it starts at +0 and a sum of the format's values is -0
// only from -0 + -0), so zero steps are skipped, and on the asset all but
// 0-0.007 % of the steps are zeros: what a segment waits for is its
// rows' loads. So a warp loads kSegRows rows at a time, a lane a place
// along w, the next kSegRows in flight while these are walked, and walks
// only a row's nonzero steps (a ballot). A second kernel then composes
// each chain's segment maps in order from fmt(0), and its last CTA runs
// the later levels. The result is the serial chain's code, bit for bit,
// with XLA's windows and padding unchanged.

constexpr int kMaxGrads = 3;
constexpr int kMaxLevels = 8;
constexpr int kMaxCodes = 256;
constexpr int kWindow = 32;  // XLA's window along a dimension (small_float.py XLA_WINDOW)

struct Grads {
  const void* p[kMaxGrads];
  int kind[kMaxGrads];  // 0 float32, 1 float16
  long long s[kMaxGrads][4];  // element strides over (B, C, H, W)
  int n;
};

struct Levels {
  int v[kMaxLevels][3][3];  // a level's (window, count, low padding) over (B, H, W)
  int n;
};

__device__ __forceinline__ float load_kind(const void* p, int kind, int64_t i) {
  return kind == 0 ? load((const float*)p, i) : load((const __half*)p, i);
}

__device__ __forceinline__ float nan_add(float a, float b) {
  float s = __fadd_rn(a, b);
  if (isnan(s)) s = isnan(a) ? a : isnan(b) ? b : nan_of(true);
  return s;
}

// the cotangent of the convolution's output at (b, c, h, w), flat index i
__device__ __forceinline__ float cotangent(const Grads& g, const void* saved, int saved_kind,
                                           int relu, int b, int c, int h, int w, int64_t i,
                                           const Fmt& f, bool via, float zero) {
  float acc = 0.0f;
  for (int k = 0; k < g.n; ++k) {
    int64_t off = b * g.s[k][0] + c * g.s[k][1] + h * g.s[k][2] + w * g.s[k][3];
    float t = round_fmt(load_kind(g.p[k], g.kind[k], off), f, via);
    acc = k == 0 ? t : round_fmt(nan_add(acc, t), f, via);
  }
  if (relu) acc = load_kind(saved, saved_kind, i) > 0.0f ? acc : zero;
  return acc;
}

// the add table, x-major: table[x * ncodes + acc] = fmt(h(acc + x)), acc
// the first operand (x86's NaN rule takes the first NaN)
__global__ void __launch_bounds__(kThreads) add_table_kernel(Fmt f, int via, int ncodes,
                                                             uint8_t* __restrict__ table) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= ncodes * ncodes) return;
  int x = i / ncodes, acc = i % ncodes;
  float s = nan_add(decode((uint32_t)acc, f), decode((uint32_t)x, f));
  table[i] = (uint8_t)encode(via ? h16(s) : s, f);
}

constexpr int kBwdUnroll = 4;  // elements of pass 1 a thread has in flight

// Pass 1: the cotangent, element by element, into `out`, which the
// reduce reads. Integer arithmetic on registers alone, so every SM holds
// as many threads as it can: the pass is bound by its loads' latency,
// kBwdUnroll elements in flight a thread.
template <typename Out>
__global__ void __launch_bounds__(kThreads) backward_kernel(
    Grads g, const void* __restrict__ saved, int saved_kind, int relu, Out* __restrict__ out,
    int B, int C, int H, int W, Fmt f, int via_f16) {
  bool via = via_f16 != 0;
  float zero = decode(encode(0.0f, f), f);
  unsigned n = (unsigned)B * C * H * W;  // < 2^31: 32-bit index arithmetic
  unsigned step = gridDim.x * kThreads;
  for (unsigned i0 = blockIdx.x * kThreads + threadIdx.x; i0 < n; i0 += step * kBwdUnroll) {
    float v[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      unsigned i = i0 + u * step;
      if (i >= n) break;
      unsigned q = i / W, w = i - q * W, r = q / H, h = q - r * H, b = r / C, c = r - b * C;
      v[u] = cotangent(g, saved, saved_kind, relu, b, c, h, w, i, f, via, zero);
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      unsigned i = i0 + u * step;
      if (i >= n) break;
      store(out, i, v[u], 0u);
    }
  }
}

// Pass 2 of the bias gradient: its reduce. A chain is a (channel,
// first-level window); its elements are the window's (b, h) rows in
// order, each at most kWindow values along w. `segments` cuts a chain's
// rows into that many runs; a warp takes one and writes its map (every
// start code's end code) to maps[(chain * segments + segment) * ncodes].
struct Values {
  const void* p;
  int kind;  // 0 float32, 1 float16
  long long s[4];  // element strides over (B, C, H, W)
};

// chain `chain`'s first-level window: [lo, hi) along (B, H, W)
__device__ __forceinline__ void window_of(const Levels& lv, int chain, int n0, int B, int H,
                                          int W, int* c, int lo[3], int hi[3]) {
  const int(*l0)[3] = lv.v[0];
  *c = chain / n0;
  int j = chain % n0;
  int start[3] = {j / (l0[2][1] * l0[1][1]), (j / l0[2][1]) % l0[1][1], j % l0[2][1]};
  int dims[3] = {B, H, W};
  for (int d = 0; d < 3; ++d) {
    lo[d] = max(start[d] * l0[d][0] - l0[d][2], 0);
    hi[d] = min(start[d] * l0[d][0] - l0[d][2] + l0[d][0], dims[d]);
  }
}

constexpr int kSegWarps = 8;  // warps (segments) a CTA
constexpr int kSegRows = 8;  // rows of a segment a warp loads at a time
constexpr int kMaxStates = kMaxCodes / 32;  // start codes a lane carries

__global__ void __launch_bounds__(32 * kSegWarps) segment_kernel(
    Values g, int B, int C, int H, int W, Levels lv, const uint8_t* __restrict__ add_table,
    uint8_t* __restrict__ maps, int segments, Fmt f) {
  extern __shared__ __align__(16) unsigned char smem[];
  int ncodes = 1 << (f.ebits + f.mbits + (f.sign_bit ? 1 : 0));
  int shift = f.ebits + f.mbits + (f.sign_bit ? 1 : 0);
  int tsize = ncodes * ncodes;
  for (int i = threadIdx.x; i < tsize / 16; i += blockDim.x)
    ((uint4*)smem)[i] = __ldg((const uint4*)add_table + i);
  for (int i = tsize / 16 * 16 + threadIdx.x; i < tsize; i += blockDim.x)
    smem[i] = __ldg(add_table + i);
  __syncthreads();
  const uint8_t* add = smem;
  const int(*l0)[3] = lv.v[0];
  int n0 = l0[0][1] * l0[1][1] * l0[2][1];
  int lane = threadIdx.x & 31;
  int item = blockIdx.x * kSegWarps + (threadIdx.x >> 5);
  if (item >= C * n0 * segments) return;
  int chain = item / segments, seg = item % segments;
  int c, lo[3], hi[3];
  window_of(lv, chain, n0, B, H, W, &c, lo, hi);
  int nh = hi[1] - lo[1], rows = (hi[0] - lo[0]) * nh, len = hi[2] - lo[2];
  int per = (rows + segments - 1) / segments;
  int r0 = min(seg * per, rows), r1 = min(r0 + per, rows);
  int st[kMaxStates];
#pragma unroll
  for (int i = 0; i < kMaxStates; ++i) st[i] = i * 32 + lane;
  // the format's zeros: adding one maps every code a chain can hold to itself
  int zero0 = f.subnormals ? 0 : -1, zero1 = f.subnormals && f.neg_zero ? f.sign_bit : -1;
  const char* base = (const char*)g.p;
  // kSegRows rows' values a lane (its place along w), the next kSegRows
  // loaded while these are walked
  auto fetch = [&](int r, float v[kSegRows]) {
#pragma unroll
    for (int k = 0; k < kSegRows; ++k) {
      v[k] = 0.0f;
      if (r + k < r1 && lane < len) {
        int b = lo[0] + (r + k) / nh, h = lo[1] + (r + k) % nh;
        int64_t off = b * g.s[0] + c * g.s[1] + h * g.s[2] + (lo[2] + lane) * g.s[3];
        v[k] = g.kind == 0 ? load((const float*)base, off) : load((const __half*)base, off);
      }
    }
  };
  float cur[kSegRows], nxt[kSegRows];
  fetch(r0, cur);
  for (int r = r0; r < r1; r += kSegRows) {
    if (r + kSegRows < r1) fetch(r + kSegRows, nxt);
#pragma unroll
    for (int k = 0; k < kSegRows; ++k) {
      if (r + k >= r1) break;
      int x = (int)encode(cur[k], f);
      // the row's nonzero steps, in order along w
      unsigned steps = __ballot_sync(0xFFFFFFFFu, lane < len && x != zero0 && x != zero1);
      while (steps) {
        int xe = __shfl_sync(0xFFFFFFFFu, x, __ffs(steps) - 1);
        steps &= steps - 1;
        const uint8_t* row = add + (xe << shift);
#pragma unroll
        for (int i = 0; i < kMaxStates; ++i)
          if (i * 32 < ncodes) st[i] = row[st[i] & (ncodes - 1)];
      }
    }
#pragma unroll
    for (int k = 0; k < kSegRows; ++k) cur[k] = nxt[k];
  }
  uint8_t* m = maps + (int64_t)item * ncodes;
#pragma unroll
  for (int i = 0; i < kMaxStates; ++i)
    if (i * 32 + lane < ncodes) m[i * 32 + lane] = (uint8_t)st[i];
}

// Each chain's segment maps composed in order from the reduce's initial
// fmt(0), a thread a chain, into scratch; the last CTA to finish (a
// ticket on `counter`, reset at its end) runs the later levels, a thread
// a channel, ping-ponging between the two halves of scratch.
__global__ void __launch_bounds__(kThreads) compose_kernel(
    int C, float* __restrict__ bias_grad, Levels lv, const uint8_t* __restrict__ add_table,
    const uint8_t* __restrict__ maps, int segments, int* __restrict__ scratch,
    int* __restrict__ counter, Fmt f) {
  int ncodes = 1 << (f.ebits + f.mbits + (f.sign_bit ? 1 : 0));
  int init = (int)encode(0.0f, f);  // the reduce's initial fmt(0)
  const int(*l0)[3] = lv.v[0];
  int n0 = l0[0][1] * l0[1][1] * l0[2][1];
  int chain = blockIdx.x * kThreads + threadIdx.x;
  if (chain < C * n0) {
    int acc = init;
    const uint8_t* m = maps + (int64_t)chain * segments * ncodes;
    for (int j = 0; j < segments; ++j) acc = __ldg(m + (int64_t)j * ncodes + acc);
    scratch[chain] = acc;
  }
  __threadfence();
  __syncthreads();
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  if (ticket != (int)gridDim.x - 1) return;
  __threadfence();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    int dims[3] = {l0[0][1], l0[1][1], l0[2][1]};
    const int* in = scratch + (int64_t)c * n0;
    int* buf[2] = {scratch + (int64_t)C * n0 + (int64_t)c * n0, scratch + (int64_t)c * n0};
    for (int k = 1; k < lv.n; ++k) {
      const int(*L)[3] = lv.v[k];
      int* o = buf[(k - 1) & 1];
      int cnt = L[0][1] * L[1][1] * L[2][1];
      for (int j = 0; j < cnt; ++j) {
        int jw = j % L[2][1], jh = (j / L[2][1]) % L[1][1], jb = j / (L[2][1] * L[1][1]);
        int start[3] = {jb, jh, jw}, lo[3], hi[3];
        for (int d = 0; d < 3; ++d) {
          lo[d] = max(start[d] * L[d][0] - L[d][2], 0);
          hi[d] = min(start[d] * L[d][0] - L[d][2] + L[d][0], dims[d]);
        }
        int acc = init;
        for (int b = lo[0]; b < hi[0]; ++b)
          for (int h = lo[1]; h < hi[1]; ++h)
            for (int w = lo[2]; w < hi[2]; ++w)
              acc = add_table[__ldcg(in + ((int64_t)b * dims[1] + h) * dims[2] + w) * ncodes +
                              acc];
        o[j] = acc;
      }
      in = o;
      dims[0] = L[0][1], dims[1] = L[1][1], dims[2] = L[2][1];
    }
    bias_grad[c] = decode((uint32_t)__ldcg(in), f);
  }
  if (threadIdx.x == 0) *counter = 0;
}

int grid_for(int64_t n, int per_block);

template <typename Out>
int launch_backward(const Grads& g, const void* saved, int saved_kind, int relu, void* out,
                    int B, int C, int H, int W, const Fmt& f, int via_f16, cudaStream_t s) {
  int64_t n = (int64_t)B * C * H * W;
  int blocks = grid_for(n, kThreads * kBwdUnroll);
  backward_kernel<Out><<<blocks, kThreads, 0, s>>>(g, saved, saved_kind, relu, (Out*)out, B, C, H,
                                                   W, f, via_f16);
  return (int)cudaGetLastError();
}

int launch_reduce(const Values& g, int B, int C, int H, int W, float* bias_grad,
                  const Levels& lv, const uint8_t* table, uint8_t* maps, int segments,
                  int* scratch, int* counter, const Fmt& f, cudaStream_t s) {
  int ncodes = 1 << (f.ebits + f.mbits + (f.sign_bit ? 1 : 0));
  int smem = ncodes * ncodes;
  int err = (int)cudaFuncSetAttribute(segment_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  int n0 = lv.v[0][0][1] * lv.v[0][1][1] * lv.v[0][2][1];
  int64_t items = (int64_t)C * n0 * segments;
  segment_kernel<<<(int)((items + kSegWarps - 1) / kSegWarps), 32 * kSegWarps, smem, s>>>(
      g, B, C, H, W, lv, table, maps, segments, f);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  compose_kernel<<<(C * n0 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      C, bias_grad, lv, table, maps, segments, scratch, counter, f);
  return (int)cudaGetLastError();
}

Fmt fmt_of(const int* p) {
  return Fmt{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11]};
}

int grid_for(int64_t n, int per_block) {
  int64_t g = (n + per_block - 1) / per_block;
  return (int)(g < 1 ? 1 : g > 65535 ? 65535 : g);
}

template <typename In, typename Out>
int launch_epilogue(const void* y, const float* bias, void* out, int rows, int channels,
                    int hw, const Fmt& f, int via_f16, int relu, cudaStream_t s) {
  dim3 grid(grid_for(hw, kThreads * kUnroll), rows < 65535 ? rows : 65535);
  epilogue_kernel<In, Out><<<grid, kThreads, 0, s>>>((const In*)y, bias, (Out*)out, rows,
                                                    channels, hw, f, via_f16, relu);
  return (int)cudaGetLastError();
}

template <typename Out>
int launch_table_epilogue(const void* y, const float* bias, const uint8_t* table, void* out,
                          int rows, int channels, int hw, const Fmt& f, int relu,
                          cudaStream_t s) {
  int err = (int)cudaFuncSetAttribute(epilogue_table_kernel<Out>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, kTableSmem);
  if (err != 0) return err;
  int dev, sms;
  if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return err;
  int64_t items = (int64_t)rows * ((hw + kChunk - 1) / kChunk);
  int64_t ctas = items < 3 * sms ? items : 3 * sms;  // three CTAs' tables fit an SM
  int64_t per_cta = (items + ctas - 1) / ctas;
  ctas = (items + per_cta - 1) / per_cta;
  epilogue_table_kernel<Out><<<(int)ctas, kThreads, kTableSmem, s>>>(
      (const __half*)y, bias, table, (Out*)out, rows, channels, hw, per_cta, f, relu);
  return (int)cudaGetLastError();
}

// which conversion rounds `f`: Hopper's for float8_e4m3fn and float8_e5m2
// (small_float.py FORMATS' parameters), the integer encode otherwise
int cast_mode(const Fmt& f) {
  if (f.ebits == 4 && f.mbits == 3 && f.bias == 7 && f.sign_bit == 0x80 && f.neg_zero &&
      f.subnormals && f.max_code == 0x7E && f.has_nan && f.nan_code == 0x7F && f.nan_signed &&
      f.overflow == 1)
    return kE4M3;
  if (f.ebits == 5 && f.mbits == 2 && f.bias == 15 && f.sign_bit == 0x80 && f.neg_zero &&
      f.subnormals && f.max_code == 0x7B && f.has_nan && f.nan_code == 0x7E && f.nan_signed &&
      f.inf_code == 0x7C && f.overflow == 0)
    return kE5M2;
  return kGeneric;
}

template <typename In, typename Out>
int launch_cast(const void* x, void* out, int B, int64_t N, int C, const Fmt& f,
                cudaStream_t s) {
  // whole 16-byte vectors: every tile starts at a multiple of 16 places
  // (T is one), so N must be too unless there is one plane
  int vec = ((uintptr_t)x % 16) == 0 && ((uintptr_t)out % 16) == 0 &&
            (N % 16 == 0 || (B == 1 && C == 1));
  int T = kCastTile / C / 16 * 16;
  int64_t tiles = (int64_t)B * ((N + T - 1) / T);
  int mode = cast_mode(f);
  auto kernel = mode == kE4M3   ? cast_kernel<In, Out, kE4M3>
                : mode == kE5M2 ? cast_kernel<In, Out, kE5M2>
                                : cast_kernel<In, Out, kGeneric>;
  // the resident CTAs, each taking an even share of the tiles
  int dev, sms, per_sm, err;
  if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) != 0)
    return err;
  int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  int64_t rounds = (tiles + resident - 1) / resident;
  int blocks = (int)((tiles + rounds - 1) / rounds);
  kernel<<<blocks, kThreads, 0, s>>>((const In*)x, (Out*)out, B, N, C, T, f, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// y (rows = B * C, hw) float32 (in_kind 0) or float16 (1), bias (C,)
// float32 -> out (rows, hw) float32 (out_kind 0) or float16 (1).
// params: N_PARAMS ints on the host (small_float.py SmallFloat.params).
// A float16 y in a format that goes through float16 takes the table
// kernel: `table` holds the format's code table (kTable bytes on the
// device), which a launch of table_kernel writes first where
// `build_table` is set; any other y the element-wise kernel.
extern "C" int tf_small_float_epilogue(const void* y, int in_kind, const void* bias, void* out,
                                       int out_kind, int rows, int channels, int hw,
                                       const int* params, int via_f16, int relu, void* table,
                                       int build_table, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0 || hw <= 0) return (int)cudaGetLastError();
  if (channels <= 0 || (int64_t)rows * hw >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  Fmt f = fmt_of(params);
  const float* b = (const float*)bias;
  if (in_kind == 1 && via_f16 && table != nullptr && (out_kind == 0 || out_kind == 1)) {
    if (build_table) {
      table_kernel<<<kTable / kThreads, kThreads, 0, s>>>(f, (uint8_t*)table);
      int err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
    if (out_kind == 0)
      return launch_table_epilogue<float>(y, b, (const uint8_t*)table, out, rows, channels, hw,
                                          f, relu, s);
    return launch_table_epilogue<__half>(y, b, (const uint8_t*)table, out, rows, channels, hw,
                                         f, relu, s);
  }
  if (in_kind == 0 && out_kind == 0)
    return launch_epilogue<float, float>(y, b, out, rows, channels, hw, f, via_f16, relu, s);
  if (in_kind == 0 && out_kind == 1)
    return launch_epilogue<float, __half>(y, b, out, rows, channels, hw, f, via_f16, relu, s);
  if (in_kind == 1 && out_kind == 0)
    return launch_epilogue<__half, float>(y, b, out, rows, channels, hw, f, via_f16, relu, s);
  if (in_kind == 1 && out_kind == 1)
    return launch_epilogue<__half, __half>(y, b, out, rows, channels, hw, f, via_f16, relu, s);
  return (int)cudaErrorInvalidValue;
}

// x (B, N, C) float32 (in_kind 0) or float16 (1), contiguous -> out
// (B, C, N) float32 (out_kind 0), float16 (1) or the format's codes as
// uint8 (2): a contiguous tensor with B = C = 1, N its size; a
// channels-last (NHWC) one with N = H W. C <= kCastTile / 16.
extern "C" int tf_small_float_cast(const void* x, int in_kind, void* out, int out_kind, int B,
                                   long long N, int C, const int* params, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((int64_t)B * N * C <= 0) return (int)cudaGetLastError();
  if (B < 1 || C < 1 || C > kCastTile / 16) return (int)cudaErrorInvalidValue;
  Fmt f = fmt_of(params);
  if (in_kind == 0 && out_kind == 0) return launch_cast<float, float>(x, out, B, N, C, f, s);
  if (in_kind == 0 && out_kind == 1) return launch_cast<float, __half>(x, out, B, N, C, f, s);
  if (in_kind == 0 && out_kind == 2) return launch_cast<float, uint8_t>(x, out, B, N, C, f, s);
  if (in_kind == 1 && out_kind == 0) return launch_cast<__half, float>(x, out, B, N, C, f, s);
  if (in_kind == 1 && out_kind == 1) return launch_cast<__half, __half>(x, out, B, N, C, f, s);
  if (in_kind == 1 && out_kind == 2) return launch_cast<__half, uint8_t>(x, out, B, N, C, f, s);
  return (int)cudaErrorInvalidValue;
}

namespace {

// levels (n_levels x 3 x 3 ints on the host) into `lv`, and the add table
// built first where `build_table`; false on bad arguments
int reduce_setup(const int* levels, int n_levels, void* table, int build_table, const Fmt& f,
                 int via_f16, Levels* lv, cudaStream_t s) {
  int ncodes = 1 << (f.ebits + f.mbits + (f.sign_bit ? 1 : 0));
  if (ncodes > kMaxCodes || n_levels < 1 || n_levels > kMaxLevels || table == nullptr ||
      levels[2 * 3] > kWindow)  // the first level's window along W: a warp's row
    return (int)cudaErrorInvalidValue;
  lv->n = n_levels;
  for (int k = 0; k < n_levels; ++k)
    for (int d = 0; d < 3; ++d)
      for (int e = 0; e < 3; ++e) lv->v[k][d][e] = levels[(k * 3 + d) * 3 + e];
  if (build_table) {
    int cells = ncodes * ncodes;
    add_table_kernel<<<(cells + kThreads - 1) / kThreads, kThreads, 0, s>>>(f, via_f16, ncodes,
                                                                            (uint8_t*)table);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace

// The epilogue's backward. grads: n_grads (1..3) host pointers to device
// tensors of (B, C, H, W) float32 (kind 0) or float16 (1) with element
// strides `strides` (4 a tensor); saved: the forward's output (or the sum
// relu took), contiguous, where relu; out (B, C, H, W) contiguous float32
// (out_kind 0) or float16 (1). bias_grad (C,) float32, or null for the
// no-bias rounding; with it levels (n_levels x 3 x 3 ints on the host,
// small_float.py xla_sum_levels), the format's add table on the device
// (x-major, written first where build_table), maps (C x the first
// level's windows x segments x the format's codes bytes), segments (the
// runs a chain is cut into), scratch (2 C x the first level's windows
// ints) and counter (one int, 0 between launches). Three kernels: the
// cotangent (pass 1), then, with a bias gradient, its reduce over `out`:
// the segments' maps, their composition and the later levels (pass 2).
extern "C" int tf_small_float_backward(const void* const* grads, const int* kinds,
                                       const long long* strides, int n_grads, const void* saved,
                                       int saved_kind, int relu, void* out, int out_kind, int B,
                                       int C, int H, int W, float* bias_grad, const int* levels,
                                       int n_levels, void* table, int build_table, void* maps,
                                       int segments, void* scratch, void* counter,
                                       const int* params, int via_f16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_grads < 1 || n_grads > kMaxGrads || (relu && saved == nullptr) ||
      (out_kind != 0 && out_kind != 1))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * C * H * W <= 0) return (int)cudaGetLastError();
  if ((int64_t)B * C * H * W >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  Fmt f = fmt_of(params);
  Grads g{};
  g.n = n_grads;
  for (int k = 0; k < n_grads; ++k) {
    g.p[k] = grads[k];
    g.kind[k] = kinds[k];
    for (int d = 0; d < 4; ++d) g.s[k][d] = strides[4 * k + d];
  }
  Levels lv{};
  if (bias_grad != nullptr) {
    if (maps == nullptr || segments < 1 || scratch == nullptr || counter == nullptr)
      return (int)cudaErrorInvalidValue;
    int err = reduce_setup(levels, n_levels, table, build_table, f, via_f16, &lv, s);
    if (err != 0) return err;
  }
  int err = out_kind == 0
                ? launch_backward<float>(g, saved, saved_kind, relu, out, B, C, H, W, f,
                                         via_f16, s)
                : launch_backward<__half>(g, saved, saved_kind, relu, out, B, C, H, W, f,
                                          via_f16, s);
  if (err != 0 || bias_grad == nullptr) return err;
  Values v{out, out_kind, {(long long)C * H * W, (long long)H * W, W, 1}};
  return launch_reduce(v, B, C, H, W, bias_grad, lv, (const uint8_t*)table, (uint8_t*)maps,
                       segments, (int*)scratch, (int*)counter, f, s);
}

// The bias gradient's reduce alone: values (B, C, H, W) float32 (kind 0)
// or float16 (1) holding the format's values, element strides `strides`
// (4) -> bias_grad (C,) float32; the other arguments as the backward's.
extern "C" int tf_small_float_bias_grad(const void* values, int kind, const long long* strides,
                                        int B, int C, int H, int W, float* bias_grad,
                                        const int* levels, int n_levels, void* table,
                                        int build_table, void* maps, int segments,
                                        void* scratch, void* counter, const int* params,
                                        int via_f16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((kind != 0 && kind != 1) || bias_grad == nullptr || maps == nullptr || segments < 1 ||
      scratch == nullptr || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * C * H * W <= 0) return (int)cudaGetLastError();
  Fmt f = fmt_of(params);
  Levels lv{};
  int err = reduce_setup(levels, n_levels, table, build_table, f, via_f16, &lv, s);
  if (err != 0) return err;
  Values v{values, kind, {strides[0], strides[1], strides[2], strides[3]}};
  return launch_reduce(v, B, C, H, W, bias_grad, lv, (const uint8_t*)table, (uint8_t*)maps,
                       segments, (int*)scratch, (int*)counter, f, s);
}
