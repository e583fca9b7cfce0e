// The range view's exact float32 pixel arithmetic, shared by the kernels
// that must give eager JAX's pixels bit for bit on the CPU (pixels.cu's
// tf_project_points and tf_project_2d, label_encode.cu's corner rects):
// glibc 2.36's fdlibm atan2f / atanf, XLA's asin expansion, IEEE division,
// every float op a PTX `.rn.ftz` instruction (round to nearest, subnormals
// flushed as XLA's CPU code flushes them, never contracted into an FMA).
// pixels.cu's header comment says where each piece comes from;
// tpufusion_torch/ops/libm_f32.py is the plain version.

#pragma once

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

// project_2d of one point: (col, row), the column truncated toward zero
// and not wrapped (cvt.rzi: NaN to 0, saturated, as XLA converts), the
// row clamped to [0, y_max] and flipped
__device__ __forceinline__ void project_2d_point(float x, float y, float z, const Spec& s,
                                                 int& col, int& row) {
  float az, el, l2;
  view_angles(x, y, z, s, az, el, l2);
  col = __float2int_rz(az);
  row = s.y_max - min(max(__float2int_rz(el), 0), s.y_max);
}

}  // namespace
