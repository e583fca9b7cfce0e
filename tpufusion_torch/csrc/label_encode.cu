// The corner head's label encode for Hopper (sm_90a) in one pass:
// encode_label(center, size, yaw, image, spec, method) of every frame,
// bit for bit its plain PyTorch version on the card
// (tpufusion_torch/geometry/encoding.py::encode_label_reference).
//
// Ports no TPU kernel. The JAX package computes this in XLA, outside
// Pallas (tpufusion/geometry/encoding.py::encode_label, vmapped by
// encode_label_batch). It replaces the port's composition of some fifty
// torch launches around one tf_project_2d launch, which wrote (B, H, W,
// 8, 3) float32 intermediates.
//
//   per frame   the 8 corners (box_corners_3d's operation order), the 9
//               projected points (pixel_math.cuh's exact project_2d),
//               the stable sort of the corners' distances to the
//               projected centroid (correctly rounded sqrt), and the
//               footprint: the outer / inner rect as numpy slices with
//               negative indices wrapped, or the circle's bounds
//               (footprint_mask, circle_rect)
//   per pixel   p = (d cos theta, -d sin theta, h); for each corner
//               c' = R^T (c - p) as _to_local rounds it, each product and
//               sum its own round-to-nearest op, never an FMA; times the
//               0/1 mask (a multiply, as the plain version, so -0.0 stays)
//
// R = Rz(theta) Ry(phi) is built from torch's own cos / sin of each
// column's theta and row's phi (the wrapper caches them per spec and
// device). Each entry of torch's Rz @ Ry (a product, then a sum of three)
// is one nonzero product plus exact zeros, so it equals that product; a
// zero product gives +0.0, because a +0.0 term is in every such sum.
// The box's corners use cosf / sinf of the yaw, as torch's cos / sin do
// on the card (CUDA's libm, no fast math). The ops here are IEEE round
// to nearest without flush, as torch's elementwise kernels; the
// projection's are .ftz, as the pixel kernel's.
//
// What bounds it on the H100: bytes. Each pixel reads 12 B of a 3-channel
// image and writes 26 float32 (104 B): at 32 x 32 x 1801, 213.9 MB, a
// 63.9 us bound at 3.35 TB/s; ~200 float ops a pixel are ~10 us at the
// card's float32 rate. Design: one CTA of 256 threads takes kChunks x 256
// pixels of one frame; warp 0 computes the frame's box into shared memory
// while the other warps load their first pixels' distance and height;
// each thread then writes its pixel's 26 channels into shared memory,
// laid out with the chunk's alignment in the output, and the CTA stores
// the chunk's contiguous 104 B a pixel as aligned float4 streaming
// stores (st.global.cs: the label is not read again by this kernel).

#include "pixel_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 2;  // chunks of kThreads pixels a CTA
constexpr int kOut = 26;    // channels: one-hot (2) + 8 corners x 3
constexpr int kOuterRect = 0, kCircle = 2;  // method codes (1: inner_rect), label_encode.METHODS

struct Box {
  float corner[8][3];
  // rect methods: [row_lo, row_hi) x [col_lo, col_hi) after numpy's wrap and clamp
  int row_lo, row_hi, col_lo, col_hi;
  // circle: the painted rect's int bounds, the projected centroid, r * r
  int ul_x, ul_y, lr_x, lr_y, pcol, prow;
  float r2;
};

// torch's int32 arithmetic wraps
__device__ __forceinline__ int isub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int iadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

// torch.remainder of int32 by a positive n
__device__ __forceinline__ int py_mod(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// _pyslice_mask's bound: a negative index wraps once, then clamps to [0, n]
__device__ __forceinline__ int py_slice_bound(int v, int n) {
  if (v < 0) v += n;
  return min(max(v, 0), n);
}

// +0.0 for either zero, the value otherwise (a sum with a +0.0 term)
__device__ __forceinline__ float plus_zero(float v) {
  return (__float_as_uint(v) << 1) == 0u ? 0.0f : v;
}

// warp 0: the frame's corners, projection, sort and footprint, into `box`
__device__ void frame_box(const float* __restrict__ center, const float* __restrict__ size,
                          const float* __restrict__ yaw, int b, int method, const Spec& s,
                          Box& box, int (&proj)[9][2]) {
  const int lane = threadIdx.x;
  if (lane < 9) {
    float x = center[3 * b], y = center[3 * b + 1], z = center[3 * b + 2];
    if (lane < 8) {  // box_corners_3d: center + size * sign / 2, then Rz(yaw) about the origin
      const float sl = lane < 4 ? -1.0f : 1.0f;
      const float sw = (lane & 3) < 2 ? 1.0f : -1.0f;
      const float sh = (lane & 1) == 0 ? 1.0f : -1.0f;
      const float cx = __fadd_rn(x, __fmul_rn(__fmul_rn(size[3 * b], sl), 0.5f));
      const float cy = __fadd_rn(y, __fmul_rn(__fmul_rn(size[3 * b + 1], sw), 0.5f));
      z = __fadd_rn(z, __fmul_rn(__fmul_rn(size[3 * b + 2], sh), 0.5f));
      const float c = cosf(yaw[b]), sn = sinf(yaw[b]);
      x = __fsub_rn(__fmul_rn(c, cx), __fmul_rn(sn, cy));
      y = __fadd_rn(__fmul_rn(sn, cx), __fmul_rn(c, cy));
      box.corner[lane][0] = x;
      box.corner[lane][1] = y;
      box.corner[lane][2] = z;
    }
    project_2d_point(x, y, z, s, proj[lane][0], proj[lane][1]);
  }
  __syncwarp();
  if (lane != 0) return;
  const int pcol = proj[8][0], prow = proj[8][1];
  float d[8];
  int order[8];
  for (int k = 0; k < 8; ++k) {  // sqrt_f32(float(dc)**2 + float(dr)**2), correctly rounded
    const float dc = __int2float_rn(isub(proj[k][0], pcol));
    const float dr = __int2float_rn(isub(proj[k][1], prow));
    d[k] = __fsqrt_rn(__fadd_rn(__fmul_rn(dc, dc), __fmul_rn(dr, dr)));
    order[k] = k;
  }
  for (int i = 1; i < 8; ++i) {  // stable insertion sort, ascending
    const int o = order[i];
    int j = i;
    for (; j > 0 && d[order[j - 1]] > d[o]; --j) order[j] = order[j - 1];
    order[j] = o;
  }
  const int first = method == kOuterRect ? 4 : 0;  // outer: the 4 farthest; else the 4 nearest
  int ul_x = proj[order[first]][0], ul_y = proj[order[first]][1];
  int lr_x = ul_x, lr_y = ul_y;
  for (int k = first + 1; k < first + 4; ++k) {
    ul_x = min(ul_x, proj[order[k]][0]);
    lr_x = max(lr_x, proj[order[k]][0]);
    ul_y = min(ul_y, proj[order[k]][1]);
    lr_y = max(lr_y, proj[order[k]][1]);
  }
  if (method != kCircle) {
    box.row_lo = py_slice_bound(ul_y, s.height);
    box.row_hi = py_slice_bound(lr_y, s.height);
    box.col_lo = py_slice_bound(ul_x, s.width);
    box.col_hi = py_slice_bound(lr_x, s.width);
    return;
  }
  // circle_rect: the square of side min(inner dims) centered on the inner rect
  const float dim_x = __int2float_rn(isub(lr_x, ul_x));
  const float dim_y = __int2float_rn(isub(lr_y, ul_y));
  const float r = fminf(dim_x, dim_y);  // torch.minimum: no NaN among whole numbers
  const float cx = __fadd_rn(__int2float_rn(ul_x), __fmul_rn(dim_x, 0.5f));
  const float cy = __fadd_rn(__int2float_rn(ul_y), __fmul_rn(dim_y, 0.5f));
  const float half = __fmul_rn(r, 0.5f);
  const float ulxf = __fsub_rn(cx, half), ulyf = __fsub_rn(cy, half);
  const float lrxf = __fadd_rn(cx, half), lryf = __fadd_rn(cy, half);
  const float rr = __fmul_rn(fminf(__fsub_rn(lryf, ulyf), __fsub_rn(lrxf, ulxf)), 0.5f);
  box.ul_x = __float2int_rz(ulxf);
  box.ul_y = __float2int_rz(ulyf);
  box.lr_x = __float2int_rz(lrxf);
  box.lr_y = __float2int_rz(lryf);
  box.pcol = pcol;
  box.prow = prow;
  box.r2 = __fmul_rn(rr, rr);
}

__device__ __forceinline__ bool in_footprint(const Box& box, int row, int col, int method,
                                             const Spec& s) {
  if (method != kCircle)
    return row >= box.row_lo && row < box.row_hi && col >= box.col_lo && col < box.col_hi;
  // the reference paints `for x in range(ul, lr)` into label[y, x]: the
  // loop value that lands on column c is ul + (c - ul) mod W
  const int vx = iadd(box.ul_x, py_mod(isub(col, box.ul_x), s.width));
  const int vy = iadd(box.ul_y, py_mod(isub(row, box.ul_y), s.height));
  const float dx = __int2float_rn(isub(vx, box.pcol));
  const float dy = __int2float_rn(isub(vy, box.prow));
  const float dist2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  return vy < box.lr_y && vx < box.lr_x && dist2 <= box.r2;
}

__global__ void __launch_bounds__(kThreads)
encode_label_kernel(const float* __restrict__ center, const float* __restrict__ size,
                    const float* __restrict__ yaw, const float* __restrict__ image, int channels,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                    const float* __restrict__ cos_p, const float* __restrict__ sin_p,
                    float* __restrict__ out, int blocks_per_frame, int method, Spec s) {
  __shared__ Box box;
  __shared__ int proj[9][2];
  __shared__ __align__(16) float stage[kThreads * kOut + 4];
  const int b = blockIdx.x / blocks_per_frame;
  const int hw = s.height * s.width;
  const int pix0 = (blockIdx.x % blocks_per_frame) * (kChunks * kThreads);
  const int tid = threadIdx.x;
  const float* img = image + (int64_t)b * hw * channels;

  // the first chunk's distance and height load while warp 0 builds the box
  int p = pix0 + tid;
  float dist = 0.0f, height = 0.0f;
  if (p < hw) {
    dist = img[(int64_t)p * channels];
    height = img[(int64_t)p * channels + 1];
  }
  if (tid < 32) frame_box(center, size, yaw, b, method, s, box, proj);
  __syncthreads();

  for (int chunk = 0; chunk < kChunks; ++chunk) {
    const int start = pix0 + chunk * kThreads;
    if (start >= hw) break;
    const int n = min(kThreads, hw - start);
    const int64_t g0 = ((int64_t)b * hw + start) * kOut;  // the chunk's first float in `out`
    const int a = (int)(g0 & 3);  // stage[a + e] holds out[g0 + e]: one alignment
    p = start + tid;
    if (chunk > 0 && p < hw) {
      dist = img[(int64_t)p * channels];
      height = img[(int64_t)p * channels + 1];
    }
    if (tid < n) {
      const int row = p / s.width, col = p - row * s.width;
      const float m = in_footprint(box, row, col, method, s) ? 1.0f : 0.0f;
      const float c = cos_t[col], sn = sin_t[col], cp = cos_p[row], sp = sin_p[row];
      // R = Rz(theta) Ry(phi), entry by entry as torch's product-and-sum gives it
      const float r00 = __fmul_rn(c, cp), r01 = plus_zero(-sn), r02 = plus_zero(__fmul_rn(c, sp));
      const float r10 = plus_zero(__fmul_rn(sn, cp)), r11 = c, r12 = plus_zero(__fmul_rn(sn, sp));
      const float r20 = plus_zero(-sp), r21 = 0.0f, r22 = cp;
      const float px = __fmul_rn(dist, c), py = __fmul_rn(-dist, sn), pz = height;
      float* row_out = stage + a + tid * kOut;
      row_out[0] = __fsub_rn(1.0f, m);
      row_out[1] = m;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float v0 = __fsub_rn(box.corner[k][0], px);
        const float v1 = __fsub_rn(box.corner[k][1], py);
        const float v2 = __fsub_rn(box.corner[k][2], pz);
        const float l0 = __fadd_rn(__fadd_rn(__fmul_rn(v0, r00), __fmul_rn(v1, r10)), __fmul_rn(v2, r20));
        const float l1 = __fadd_rn(__fadd_rn(__fmul_rn(v0, r01), __fmul_rn(v1, r11)), __fmul_rn(v2, r21));
        const float l2 = __fadd_rn(__fadd_rn(__fmul_rn(v0, r02), __fmul_rn(v1, r12)), __fmul_rn(v2, r22));
        row_out[2 + 3 * k] = __fmul_rn(l0, m);
        row_out[3 + 3 * k] = __fmul_rn(l1, m);
        row_out[4 + 3 * k] = __fmul_rn(l2, m);
      }
    }
    __syncthreads();
    // out[g0 - a + 4 v ...] from stage[4 v ...]: whole float4s, the ragged ends by the float
    const int total = a + n * kOut;
    float* base = out + (g0 - a);
    for (int v = tid; v < (total + 3) / 4; v += kThreads) {
      const int e = 4 * v;
      if (e >= a && e + 4 <= total) {
        __stcs(reinterpret_cast<float4*>(base + e), *reinterpret_cast<const float4*>(stage + e));
      } else {
        for (int k = e; k < e + 4; ++k)
          if (k >= a && k < total) __stcs(base + k, stage[k]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tf_encode_label(const void* center, const void* size, const void* yaw,
                               const void* image, int channels, const void* cos_t,
                               const void* sin_t, const void* cos_p, const void* sin_p,
                               void* out, int frames, int method, float res_h, float x_min,
                               float res_v, float y_min, int width, int height, int y_max,
                               void* stream) {
  if (frames <= 0) return (int)cudaGetLastError();
  if (method < kOuterRect || method > kCircle || channels < 2 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Spec s{res_h, x_min, res_v, y_min, width, height, y_max};
  const int per_block = kChunks * kThreads;
  const int blocks_per_frame = (height * width + per_block - 1) / per_block;
  const int64_t blocks = (int64_t)blocks_per_frame * frames;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  encode_label_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)center, (const float*)size, (const float*)yaw, (const float*)image,
      channels, (const float*)cos_t, (const float*)sin_t, (const float*)cos_p,
      (const float*)sin_p, (float*)out, blocks_per_frame, method, s);
  return (int)cudaGetLastError();
}
