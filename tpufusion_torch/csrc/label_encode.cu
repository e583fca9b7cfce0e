// The label encodes of both heads for Hopper (sm_90a), each in one pass:
// encode_label(center, size, yaw, image, spec, method) for the corner head
// and encode_direct_label(center, size, yaw, image, spec, footprint,
// yaw_frame) for the direct head, of every frame, bit for bit their plain
// PyTorch versions on the card
// (tpufusion_torch/geometry/encoding.py::encode_label_reference and
// encode_direct_label_reference).
//
// Ports no TPU kernel. The JAX package computes both in XLA, outside
// Pallas (tpufusion/geometry/encoding.py::encode_label and
// encode_direct_label, vmapped by their _batch forms). The corner kernel
// replaces the port's composition of some fifty torch launches around one
// tf_project_2d launch, which wrote (B, H, W, 8, 3) float32
// intermediates; the direct kernel a composition of about forty launches
// that wrote (B, H, W, 3) and (B, H, W) intermediates.
//
// corner, per frame   the 8 corners (box_corners_3d's operation order),
//               the 9 projected points (pixel_math.cuh's exact
//               project_2d), the stable sort of the corners' distances to
//               the projected centroid (correctly rounded sqrt), and the
//               footprint: the outer / inner rect as numpy slices with
//               negative indices wrapped, or the circle's bounds
//               (footprint_mask, circle_rect)
// corner, per pixel   p = (d cos theta, -d sin theta, h); for each corner
//               c' = R^T (c - p) as _to_local rounds it, each product and
//               sum its own round-to-nearest op, never an FMA; times the
//               0/1 mask (a multiply, as the plain version, so -0.0 stays)
// direct, per frame   cos / sin of the yaw, c_phys = Rz(yaw) @ center
//               (_physical_center), the dilated half sizes size / 2 +
//               0.25, and for footprint "rect" the outer rect (the corner
//               kernel's frame_box)
// direct, per pixel   the surface test of box_surface_mask (rel = p -
//               c_phys, qx = c rel0 + s rel1, qy = (-s) rel0 + c rel1,
//               |q| <= half, d > 0) or the rect; dc = R^T (c_phys - p);
//               then [1 - m, m, dc m, lwh m, sin/cos(yaw + theta) m and / or
//               sin/cos(yaw) m]
//
// R = Rz(theta) Ry(phi) is built from torch's own cos / sin of each
// column's theta and row's phi (the wrapper caches them per spec and
// device), the local yaw frame's theta from the plain version's own
// pixel_angles (one float a column). Each entry of torch's Rz @ Ry (a
// product, then a sum of three) is one nonzero product plus exact zeros,
// so it equals that product; a zero product gives +0.0, because a +0.0
// term is in every such sum. cosf / sinf of the yaw, and of the rounded
// sum yaw + theta, are torch's cos / sin on the card (CUDA's libm, no
// fast math). The ops here are IEEE round to nearest without flush, as
// torch's elementwise kernels; the projection's are .ftz, as the pixel
// kernel's.
//
// What bounds them on the H100: bytes. Each pixel reads 12 B of a
// 3-channel image and writes 26 float32 (104 B, corner) or 10 / 12 (40 /
// 48 B, direct): at 32 x 32 x 1801, 213.9 / 95.9 / 110.7 MB, a 63.9 /
// 28.6 / 33.0 us bound at 3.35 TB/s; ~200 float ops a pixel (corner; the
// direct encode's ~40 and two sinf / cosf) are ~10 us at the card's
// float32 rate. Design: one CTA of 256 threads takes kChunks x 256 pixels
// of one frame; warp 0 computes the frame's box into shared memory while
// the other warps load their first pixels' distance and height; each
// thread then writes its pixel's channels into shared memory, laid out
// with the chunk's alignment in the output, and the CTA stores the
// chunk's contiguous channels as aligned float4 streaming stores
// (st.global.cs: the label is not read again by this kernel). A 40 B
// label is not 16-B aligned either: two pixels make five float4s.

#include "pixel_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 2;  // chunks of kThreads pixels a CTA
constexpr int kCornerOut = 26;  // channels: one-hot (2) + 8 corners x 3
constexpr int kOuterRect = 0, kCircle = 2;  // method codes (1: inner_rect), label_encode.METHODS
constexpr int kSurface = 0, kRect = 1;      // footprint codes, label_encode.FOOTPRINTS
constexpr int kLocal = 0, kGlobal = 1, kBoth = 2;  // yaw_frame codes, label_encode.YAW_FRAMES

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

// R = Rz(theta) Ry(phi), entry by entry as torch's product-and-sum gives it
struct Rot {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;
};

__device__ __forceinline__ Rot pixel_rotation(float c, float sn, float cp, float sp) {
  return {__fmul_rn(c, cp), plus_zero(-sn), plus_zero(__fmul_rn(c, sp)),
          plus_zero(__fmul_rn(sn, cp)), c, plus_zero(__fmul_rn(sn, sp)),
          plus_zero(-sp), 0.0f, cp};
}

// R^T v as _to_local rounds it: (v0 R0j + v1 R1j) + v2 R2j
__device__ __forceinline__ void to_local(const Rot& r, float v0, float v1, float v2, float& l0,
                                         float& l1, float& l2) {
  l0 = __fadd_rn(__fadd_rn(__fmul_rn(v0, r.r00), __fmul_rn(v1, r.r10)), __fmul_rn(v2, r.r20));
  l1 = __fadd_rn(__fadd_rn(__fmul_rn(v0, r.r01), __fmul_rn(v1, r.r11)), __fmul_rn(v2, r.r21));
  l2 = __fadd_rn(__fadd_rn(__fmul_rn(v0, r.r02), __fmul_rn(v1, r.r12)), __fmul_rn(v2, r.r22));
}

// out[g0 - a + 4 v ...] from stage[4 v ...] (stage[a + e] holds out[g0 + e],
// a = g0 & 3, `count` floats): whole float4s, the ragged ends by the float
__device__ __forceinline__ void store_staged(float* __restrict__ out, const float* stage,
                                             int64_t g0, int a, int count) {
  const int total = a + count;
  float* base = out + (g0 - a);
  for (int v = threadIdx.x; v < (total + 3) / 4; v += kThreads) {
    const int e = 4 * v;
    if (e >= a && e + 4 <= total) {
      __stcs(reinterpret_cast<float4*>(base + e), *reinterpret_cast<const float4*>(stage + e));
    } else {
      for (int k = e; k < e + 4; ++k)
        if (k >= a && k < total) __stcs(base + k, stage[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
encode_label_kernel(const float* __restrict__ center, const float* __restrict__ size,
                    const float* __restrict__ yaw, const float* __restrict__ image, int channels,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                    const float* __restrict__ cos_p, const float* __restrict__ sin_p,
                    float* __restrict__ out, int blocks_per_frame, int method, Spec s) {
  __shared__ Box box;
  __shared__ int proj[9][2];
  __shared__ __align__(16) float stage[kThreads * kCornerOut + 4];
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
    const int64_t g0 = ((int64_t)b * hw + start) * kCornerOut;  // the chunk's first float in `out`
    const int a = (int)(g0 & 3);  // stage[a + e] holds out[g0 + e]: one alignment
    p = start + tid;
    if (chunk > 0 && p < hw) {
      dist = img[(int64_t)p * channels];
      height = img[(int64_t)p * channels + 1];
    }
    if (tid < n) {
      const int row = p / s.width, col = p - row * s.width;
      const float m = in_footprint(box, row, col, method, s) ? 1.0f : 0.0f;
      const float c = cos_t[col], sn = sin_t[col];
      const Rot r = pixel_rotation(c, sn, cos_p[row], sin_p[row]);
      const float px = __fmul_rn(dist, c), py = __fmul_rn(-dist, sn), pz = height;
      float* row_out = stage + a + tid * kCornerOut;
      row_out[0] = __fsub_rn(1.0f, m);
      row_out[1] = m;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float v0 = __fsub_rn(box.corner[k][0], px);
        const float v1 = __fsub_rn(box.corner[k][1], py);
        const float v2 = __fsub_rn(box.corner[k][2], pz);
        float l0, l1, l2;
        to_local(r, v0, v1, v2, l0, l1, l2);
        row_out[2 + 3 * k] = __fmul_rn(l0, m);
        row_out[3 + 3 * k] = __fmul_rn(l1, m);
        row_out[4 + 3 * k] = __fmul_rn(l2, m);
      }
    }
    __syncthreads();
    store_staged(out, stage, g0, a, n * kCornerOut);
    __syncthreads();
  }
}

// the direct head's per-frame constants (box_surface_mask, _physical_center)
struct DirectFrame {
  float yaw, c, s;   // the yaw, torch's cos / sin of it
  float cphys[3];    // Rz(yaw) @ center
  float size[3];     // l w h
  float half[3];     // size / 2 + 0.25: the dilated box's half sizes
};

// kOut = 10 (yaw_frame local or global) or 12 (both)
template <int kOut>
__global__ void __launch_bounds__(kThreads)
encode_direct_kernel(const float* __restrict__ center, const float* __restrict__ size,
                     const float* __restrict__ yaw, const float* __restrict__ image, int channels,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                     const float* __restrict__ cos_p, const float* __restrict__ sin_p,
                     const float* __restrict__ theta, float* __restrict__ out,
                     int blocks_per_frame, int footprint, int yaw_frame, Spec s) {
  __shared__ Box box;
  __shared__ int proj[9][2];
  __shared__ DirectFrame f;
  __shared__ __align__(16) float stage[kThreads * kOut + 4];
  const int b = blockIdx.x / blocks_per_frame;
  const int hw = s.height * s.width;
  const int pix0 = (blockIdx.x % blocks_per_frame) * (kChunks * kThreads);
  const int tid = threadIdx.x;
  const float* img = image + (int64_t)b * hw * channels;

  int p = pix0 + tid;
  float dist = 0.0f, height = 0.0f;
  if (p < hw) {
    dist = img[(int64_t)p * channels];
    height = img[(int64_t)p * channels + 1];
  }
  if (tid < 32) {
    if (footprint == kRect) frame_box(center, size, yaw, b, kOuterRect, s, box, proj);
    if (tid == 0) {
      const float y = yaw[b], c = cosf(y), sn = sinf(y);
      const float cx = center[3 * b], cy = center[3 * b + 1];
      f.yaw = y;
      f.c = c;
      f.s = sn;
      f.cphys[0] = __fsub_rn(__fmul_rn(c, cx), __fmul_rn(sn, cy));
      f.cphys[1] = __fadd_rn(__fmul_rn(sn, cx), __fmul_rn(c, cy));
      f.cphys[2] = center[3 * b + 2];
      for (int j = 0; j < 3; ++j) {
        f.size[j] = size[3 * b + j];
        f.half[j] = __fadd_rn(__fmul_rn(f.size[j], 0.5f), 0.25f);
      }
    }
  }
  __syncthreads();

  for (int chunk = 0; chunk < kChunks; ++chunk) {
    const int start = pix0 + chunk * kThreads;
    if (start >= hw) break;
    const int n = min(kThreads, hw - start);
    const int64_t g0 = ((int64_t)b * hw + start) * kOut;
    const int a = (int)(g0 & 3);
    p = start + tid;
    if (chunk > 0 && p < hw) {
      dist = img[(int64_t)p * channels];
      height = img[(int64_t)p * channels + 1];
    }
    if (tid < n) {
      const int row = p / s.width, col = p - row * s.width;
      const float c = cos_t[col], sn = sin_t[col];
      const float px = __fmul_rn(dist, c), py = __fmul_rn(-dist, sn), pz = height;
      bool inside;
      if (footprint == kSurface) {  // box_surface_mask: -s is negated, then multiplied
        const float rel0 = __fsub_rn(px, f.cphys[0]), rel1 = __fsub_rn(py, f.cphys[1]);
        const float rel2 = __fsub_rn(pz, f.cphys[2]);
        const float qx = __fadd_rn(__fmul_rn(f.c, rel0), __fmul_rn(f.s, rel1));
        const float qy = __fadd_rn(__fmul_rn(-f.s, rel0), __fmul_rn(f.c, rel1));
        inside = fabsf(qx) <= f.half[0] && fabsf(qy) <= f.half[1] && fabsf(rel2) <= f.half[2] &&
                 dist > 0.0f;
      } else {
        inside = in_footprint(box, row, col, kOuterRect, s);
      }
      const float m = inside ? 1.0f : 0.0f;
      float d0, d1, d2;
      to_local(pixel_rotation(c, sn, cos_p[row], sin_p[row]), __fsub_rn(f.cphys[0], px),
               __fsub_rn(f.cphys[1], py), __fsub_rn(f.cphys[2], pz), d0, d1, d2);
      float* o = stage + a + tid * kOut;
      o[0] = __fsub_rn(1.0f, m);
      o[1] = m;
      o[2] = __fmul_rn(d0, m);
      o[3] = __fmul_rn(d1, m);
      o[4] = __fmul_rn(d2, m);
      o[5] = __fmul_rn(f.size[0], m);
      o[6] = __fmul_rn(f.size[1], m);
      o[7] = __fmul_rn(f.size[2], m);
      int k = 8;
      if (yaw_frame != kGlobal) {  // sin / cos(yaw + theta): the add rounded, then CUDA's libm
        const float ang = __fadd_rn(f.yaw, theta[col]);
        o[k++] = __fmul_rn(sinf(ang), m);
        o[k++] = __fmul_rn(cosf(ang), m);
      }
      if (yaw_frame != kLocal) {
        o[k++] = __fmul_rn(f.s, m);
        o[k] = __fmul_rn(f.c, m);
      }
    }
    __syncthreads();
    store_staged(out, stage, g0, a, n * kOut);
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

extern "C" int tf_encode_direct_label(const void* center, const void* size, const void* yaw,
                                      const void* image, int channels, const void* cos_t,
                                      const void* sin_t, const void* cos_p, const void* sin_p,
                                      const void* theta, void* out, int frames, int footprint,
                                      int yaw_frame, float res_h, float x_min, float res_v,
                                      float y_min, int width, int height, int y_max,
                                      void* stream) {
  if (frames <= 0) return (int)cudaGetLastError();
  if (footprint < kSurface || footprint > kRect || yaw_frame < kLocal || yaw_frame > kBoth ||
      channels < 2 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Spec s{res_h, x_min, res_v, y_min, width, height, y_max};
  const int per_block = kChunks * kThreads;
  const int blocks_per_frame = (height * width + per_block - 1) / per_block;
  const int64_t blocks = (int64_t)blocks_per_frame * frames;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kernel = yaw_frame == kBoth ? encode_direct_kernel<12> : encode_direct_kernel<10>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)center, (const float*)size, (const float*)yaw, (const float*)image,
      channels, (const float*)cos_t, (const float*)sin_t, (const float*)cos_p,
      (const float*)sin_p, (const float*)theta, (float*)out, blocks_per_frame, footprint,
      yaw_frame, s);
  return (int)cudaGetLastError();
}
