// The range view's pixel arithmetic for Hopper (sm_90a), bit for bit eager
// JAX's on the CPU: one thread a point (or a box corner), one pass.
//
// Ports no TPU kernel. The JAX package computes this in XLA, outside
// Pallas: tpufusion/geometry/range_view.py::project_to_pixels and
// _frame_pixels_keys (the Pallas z-buffer's inputs), and
// tpufusion/geometry/boxes.py::project_2d (the label encode's and the
// rects' pixel map). The port's own kernel, so that the card's pixels are
// the reference's:
//
//   l2  = sqrt((x*x + y*y) + z*z)
//   col = trunc(atan2(-y, x) / res_h - x_min)   mod W
//   row = y_max - (trunc(asin(l2 > 0 ? z / max(l2, 1e-12) : 0) / res_v
//                        - y_min) mod H)
//
// with the reference's own float32 arithmetic (tpufusion_torch/ops/
// libm_f32.py, the plain version, says where each piece comes from):
// glibc 2.36's fdlibm atan2f / atanf (e_atan2f.c, s_atanf.c), XLA's asin
// expansion t = atan2(x, 1 + sqrt((1 - x) * (1 + x))), t + t, IEEE
// division by the float32 resolutions, and XLA's CPU flush of subnormal
// operands and results. Every float op is a PTX `.rn.ftz` instruction:
// round to nearest, subnormals flushed to a zero of their sign, and never
// fused into an FMA (an explicit rounding modifier forbids the
// contraction whatever nvcc's flags). No atan2f / asinf / reciprocal.
// fdlibm's integer tests read the operands' bits as they came.
//
// tf_project_points: (B*N, C >= 3) float32 points [+ valid] -> pixel id
// (int32), key (the L2 norm's bits), ok (all C channels finite, and
// valid), payload (sqrt(x*x + y*y), z, intensity); a point that is not ok
// gets pixel 0, key INT32_MAX and a zero payload. tf_project_2d: (x, y,
// z) -> (col, row), the row clamped to [0, y_max] and flipped, the column
// not wrapped.
//
// What bounds it on the H100: bytes. At 64 x 32,768 points of 4 channels
// it reads 16 B and a valid byte a point and writes 21 B (79.7 MB, 23.8 us
// at 3.35 TB/s); fdlibm's ~150 float ops a point are under 5 us at the
// card's float32 rate. Design: the simplest one that moves each byte
// once, a grid-stride loop, a point's four channels in one 16-byte load
// where the rows allow it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float fadd(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fsub(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fmul(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fdiv(float a, float b) {
  float r;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fsqrt(float a) {
  float r;
  asm("sqrt.rn.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ float bitsf(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ float fneg(float a) {  // the sign bit flipped, no flush
  return __int_as_float(__float_as_int(a) ^ (int)0x80000000u);
}
__device__ __forceinline__ float fabs_bits(float a) {
  return __int_as_float(__float_as_int(a) & 0x7fffffff);
}

// s_atanf.c's tables and e_atan2f.c's constants, as the float32 bits the
// C source compiles to (aT[0]'s literal is 0x3eaaaaab, not its comment's
// 0x3eaaaaaa), and the constants the C code returns as float32 sums.
__constant__ uint32_t kAtanHi[4] = {0x3eed6338u, 0x3f490fdau, 0x3f7b985eu, 0x3fc90fdau};
__constant__ uint32_t kAtanLo[4] = {0x31ac3769u, 0x33222168u, 0x33140fb4u, 0x33a22168u};
__constant__ uint32_t kAT[11] = {0x3eaaaaabu, 0xbe4ccccdu, 0x3e124925u, 0xbde38e38u,
                                 0x3dba2e6eu, 0xbd9d8795u, 0x3d886b35u, 0xbd6ef16bu,
                                 0x3d4bda59u, 0xbd15a221u, 0x3c8569d7u};
constexpr uint32_t kPi = 0x40490fdbu;         // pi, and pi + tiny
constexpr uint32_t kPiLo = 0xb3bbbd2eu;
constexpr uint32_t kPiO2 = 0x3fc90fdbu;       // pi/2 + tiny, pi/2 + pi_lo/2, atanhi[3] + atanlo[3]
constexpr uint32_t kPiO4 = 0x3f490fdbu;       // pi/4 + tiny
constexpr uint32_t kThreePiO4 = 0x4016cbe4u;  // 3 * pi/4 + tiny
constexpr uint32_t kL2Floor = 0x2b8cbcccu;    // 1e-12f
constexpr int32_t kInt32Max = 0x7fffffff;

__device__ float atanf_fdlibm(float x) {
  const int32_t hx = __float_as_int(x);
  const int32_t ix = hx & 0x7fffffff;
  int id;
  if (ix >= 0x4c000000) {  // |x| >= 2^25
    if (ix > 0x7f800000) return fadd(x, x);  // NaN
    return hx > 0 ? bitsf(kPiO2) : fneg(bitsf(kPiO2));
  }
  if (ix < 0x3ee00000) {  // |x| < 7/16
    if (ix < 0x31000000) return x;  // |x| < 2^-29
    id = -1;
  } else {
    const float ax = __int_as_float(ix);
    if (ix < 0x3f980000) {    // |x| < 19/16
      if (ix < 0x3f300000) {  // 7/16 <= |x| < 11/16
        id = 0;
        x = fdiv(fsub(fmul(2.0f, ax), 1.0f), fadd(2.0f, ax));
      } else {  // 11/16 <= |x| < 19/16
        id = 1;
        x = fdiv(fsub(ax, 1.0f), fadd(ax, 1.0f));
      }
    } else if (ix < 0x401c0000) {  // |x| < 39/16
      id = 2;
      x = fdiv(fsub(ax, 1.5f), fadd(1.0f, fmul(1.5f, ax)));
    } else {  // 39/16 <= |x| < 2^25
      id = 3;
      x = fdiv(-1.0f, ax);
    }
  }
  const float z = fmul(x, x);
  const float w = fmul(z, z);
  // s1 = z*(aT0 + w*(aT2 + ... + w*aT10)), s2 = w*(aT1 + w*(aT3 + ... + w*aT9))
  float s1 = bitsf(kAT[10]), s2 = bitsf(kAT[9]);
  for (int j = 8; j >= 0; j -= 2) s1 = fadd(bitsf(kAT[j]), fmul(w, s1));
  for (int j = 7; j >= 1; j -= 2) s2 = fadd(bitsf(kAT[j]), fmul(w, s2));
  s1 = fmul(z, s1);
  s2 = fmul(w, s2);
  const float xs = fmul(x, fadd(s1, s2));
  if (id < 0) return fsub(x, xs);
  const float r = fsub(bitsf(kAtanHi[id]), fsub(fsub(xs, bitsf(kAtanLo[id])), x));
  return hx < 0 ? fneg(r) : r;
}

__device__ float atan2_fdlibm(float y, float x) {
  const int32_t hx = __float_as_int(x), hy = __float_as_int(y);
  const int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return fadd(x, y);  // NaN
  if (hx == 0x3f800000) return atanf_fdlibm(y);                // x = 1
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);          // 2 * sign(x) + sign(y)
  const float pi = bitsf(kPi), pi_o_2 = bitsf(kPiO2);
  if (iy == 0) return m < 2 ? y : (m == 2 ? pi : fneg(pi));
  if (ix == 0) return hy < 0 ? fneg(pi_o_2) : pi_o_2;
  if (ix == 0x7f800000) {
    float r;
    if (iy == 0x7f800000) r = (m < 2) ? bitsf(kPiO4) : bitsf(kThreePiO4);
    else r = (m < 2) ? 0.0f : pi;
    return (m & 1) ? fneg(r) : r;
  }
  if (iy == 0x7f800000) return hy < 0 ? fneg(pi_o_2) : pi_o_2;
  const int k = (iy - ix) >> 23;
  float z;
  if (k > 60) z = pi_o_2;                    // |y/x| > 2^60: pi/2 + pi_lo/2
  else if (hx < 0 && k < -60) z = 0.0f;      // |y|/x < -2^60
  else z = atanf_fdlibm(fabs_bits(fdiv(y, x)));
  switch (m) {
    case 0: return z;
    case 1: return fneg(z);
    case 2: return fsub(pi, fsub(z, bitsf(kPiLo)));
    default: return fsub(fsub(z, bitsf(kPiLo)), pi);
  }
}

__device__ __forceinline__ float asin_xla(float x) {
  const float t = atan2_fdlibm(x, fadd(1.0f, fsqrt(fmul(fsub(1.0f, x), fadd(1.0f, x)))));
  return fadd(t, t);
}

struct Spec {
  float res_h, x_min, res_v, y_min;
  int width, height, y_max;
};

// (azimuth pixel, elevation pixel, l2) before truncation
__device__ __forceinline__ void view_angles(float x, float y, float z, const Spec& s,
                                            float& az, float& el, float& l2) {
  l2 = fsqrt(fadd(fadd(fmul(x, x), fmul(y, y)), fmul(z, z)));
  az = fsub(fdiv(atan2_fdlibm(fneg(y), x), s.res_h), s.x_min);
  const float ratio = l2 > 0.0f ? fdiv(z, fmaxf(l2, bitsf(kL2Floor))) : 0.0f;
  el = fsub(fdiv(asin_xla(ratio), s.res_v), s.y_min);
}

__device__ __forceinline__ int floor_mod(int v, int m) {
  const int r = v % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ bool is_finite(float v) {
  return (__float_as_int(v) & 0x7f800000) != 0x7f800000;
}

__global__ void project_points_kernel(const float* __restrict__ pts,
                                      const uint8_t* __restrict__ valid,
                                      int32_t* __restrict__ pix, int32_t* __restrict__ key,
                                      uint8_t* __restrict__ ok, float* __restrict__ payload,
                                      int64_t total, int c, bool vec4, Spec s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    float x, y, z, inten;
    bool good;
    if (vec4) {
      const float4 v = reinterpret_cast<const float4*>(pts)[i];
      x = v.x, y = v.y, z = v.z, inten = v.w;
      good = is_finite(x) && is_finite(y) && is_finite(z) && is_finite(inten);
    } else {
      const float* p = pts + i * c;
      x = p[0], y = p[1], z = p[2];
      inten = c > 3 ? p[3] : 0.0f;
      good = true;
      for (int j = 0; j < c; ++j) good = good && is_finite(p[j]);
    }
    if (valid != nullptr) good = good && valid[i] != 0;
    float* out = payload + 3 * i;
    if (good) {
      float az, el, l2;
      view_angles(x, y, z, s, az, el, l2);
      const int col = floor_mod(__float2int_rz(az), s.width);
      const int row = s.y_max - floor_mod(__float2int_rz(el), s.height);
      pix[i] = row * s.width + col;
      key[i] = __float_as_int(l2);
      out[0] = fsqrt(fadd(fmul(x, x), fmul(y, y)));
      out[1] = z;
      out[2] = inten;
    } else {
      pix[i] = 0;
      key[i] = kInt32Max;
      out[0] = out[1] = out[2] = 0.0f;
    }
    ok[i] = good;
  }
}

__global__ void project_2d_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                                  const float* __restrict__ zs, int32_t* __restrict__ cols,
                                  int32_t* __restrict__ rows, int64_t n, Spec s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float az, el, l2;
    view_angles(xs[i], ys[i], zs[i], s, az, el, l2);
    cols[i] = __float2int_rz(az);  // cvt.rzi: NaN to 0, saturated, as XLA converts
    rows[i] = s.y_max - min(max(__float2int_rz(el), 0), s.y_max);
  }
}

constexpr int kThreads = 256;

int blocks_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return (int)(want < 132 * 32 ? want : 132 * 32);  // 32 blocks an SM, then the stride loop
}

}  // namespace

extern "C" int tf_project_points(const void* pts, const void* valid, void* pix, void* key,
                                 void* ok, void* payload, long long total, int c,
                                 float res_h, float x_min, float res_v, float y_min,
                                 int width, int height, int y_max, void* stream) {
  if (total <= 0) return (int)cudaGetLastError();
  const Spec s{res_h, x_min, res_v, y_min, width, height, y_max};
  const bool vec4 = c == 4 && (reinterpret_cast<uintptr_t>(pts) & 15) == 0;
  project_points_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const uint8_t*)valid, (int32_t*)pix, (int32_t*)key, (uint8_t*)ok,
      (float*)payload, total, c, vec4, s);
  return (int)cudaGetLastError();
}

extern "C" int tf_project_2d(const void* x, const void* y, const void* z, void* col, void* row,
                             long long n, float res_h, float x_min, float res_v, float y_min,
                             int width, int height, int y_max, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const Spec s{res_h, x_min, res_v, y_min, width, height, y_max};
  project_2d_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)z, (int32_t*)col, (int32_t*)row, n, s);
  return (int)cudaGetLastError();
}
