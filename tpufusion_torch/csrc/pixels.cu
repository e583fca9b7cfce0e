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
// fdlibm's integer tests read the operands' bits as they came. The
// arithmetic lives in pixel_math.cuh, which label_encode.cu shares.
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

#include "pixel_math.cuh"

namespace {

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
    int col, row;
    project_2d_point(xs[i], ys[i], zs[i], s, col, row);
    cols[i] = col;
    rows[i] = row;
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
