// The direct head's per-cluster decode for Hopper (sm_90a): for every
// (frame, lane) of `_topk_roots`, what decode_direct_clusters_reference
// (tpufusion_torch/decode/decode.py) computes from the CC's labels and
// extents on: the prob-weighted size and yaw (local, global or the
// dual-codec auto gate), the surface mean, the back-projection with its
// nearest-valid-pixel fallback, the radial push, the consensus, the head's
// center, and the Gauss-Newton fit of the box boundary (circle, ellipse,
// box, or the auto arms) to the gated surface points; then the final
// rotation and the found mask. Every center but "silhouette".
//
// Ports no TPU kernel. The JAX package computes this in XLA, outside
// Pallas (tpufusion/decode/decode.py: _direct_pose_from_cluster,
// back_project_2d_to_3d, _fit_pose_to_surface, vmapped by
// decode_batch_direct). It replaces the port's composition of 300 to 1,400
// torch launches, each over whole (B, k, H, W) frames, though a cluster's
// pixels, and every window the decode reads, lie inside its CC extents.
//
// What bounds it on the H100: the bytes the lanes need, a few hundred
// window pixels a car: each window pixel's mask, its label where the mask
// is set, the image's distance and height on the cluster (and on the
// back-projection's window where it falls back), and on the cluster's
// valid pixels the probability and the few y_pred channels the center and
// yaw frame read; far below the launch floor, so one launch is the bound,
// and the design keeps to one.
//
// Design: one CTA of 256 threads a (frame, lane); a lane that
// _topk_roots did not find writes zeros and returns (the plain version
// masks every output of such a lane). The CTA walks the rows min_y..max_y
// x columns min_x..max_x read at its root pixel (the CC kernel converges,
// so they hold every pixel labelled with the root), in raster order, a
// thread a pixel:
//   pass 1  over the cluster's pixels (mask, label == root): m = valid and
//           prob >= min_prob, the sums of prob, l w h, the yaw frame's
//           sin / cos (both frames for auto) and the head's center, each
//           term the float32 product torch rounds, summed in float64 and
//           rounded once; min d over m and over the cluster's valid
//           pixels; and the back-projection's nearest valid pixel in the
//           window shrunk by 2, as the exact integer dx^2 + dy^2 packed
//           with the flat index into 64 bits and taken by a min (the plain
//           version's first argmin of the correctly rounded sqrt: a sqrt
//           keeps the order and the ties of integers below 2^22)
//   pass 2  the surface mean over m with d <= dmin + 4
//   thread 0 the lane's scalars: yaw, size, back-projection, push,
//           consensus, the fit's arm, radius and gate
//   pass 3  (fit) the gated points (cluster, valid, d <= dmin + 4, within
//           the gate of the seed) compacted in raster order into shared
//           memory, a ballot a chunk of 256 pixels; past kPointCap points
//           the fit walks the window again instead
//   fit     a warp a candidate heading (1 for a circle, 37 for an ellipse
//           or a box; the auto boundary fits only the arm the yaw gate
//           picked, the one the plain version keeps): 4 Gauss-Newton steps
//           and the residual, each a warp's float64 sums; then thread 0
//           takes the first minimum, the decisive test, the pi-resolution
//           against the head yaw and ok_fit
//
// Numbers: each elementwise op is the plain version's float32 op, round
// to nearest, never contracted into an FMA (__fmul_rn and friends), every
// sqrt __fsqrt_rn (the plain version's sqrt_f32 is correctly rounded),
// IEEE division, no fast math; atan2f / sinf / cosf are torch's own on the
// card. Per-pixel points come from torch's cos / sin of the columns'
// theta, the head's rotation from those of the rows' phi too, and the
// fit's 36-heading grid from torch's arange, all made by the wrapper. Only
// the sums run in another order than torch's reductions (and the head's
// 3 x 3 product, which cuBLAS computes in the plain version), so the
// contract with the plain version is a tolerance, not bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGridPhis = 36;
constexpr int kMaxCands = kGridPhis + 1;
constexpr int kGnIters = 4;
constexpr int kPointCap = 4096;  // gated points held in shared memory (32 KB)
constexpr int kSums = 11;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr unsigned long long kNoKey = ~0ull;
enum { kBackproject, kGeometric, kSurface, kConsensus, kHead, kFit };  // decode_direct.CENTERS
enum { kCircle, kEllipse, kBox };                                      // decode_direct.BOUNDARIES
enum { kLocal, kGlobal, kAuto };                                       // decode_direct.YAW_FRAMES

struct Params {
  const float* y_pred;
  const float* image;
  const unsigned char* mask;
  const int* labels;
  const int* min_x;
  const int* max_x;
  const int* min_y;
  const int* max_y;
  const long long* root;
  const unsigned char* found;
  const float* cos_t;  // (W,) torch's cos / sin of each column's theta
  const float* sin_t;
  const float* cos_p;  // (H,) and of each row's phi
  const float* sin_p;
  const float* phi_grid;  // (36,) the fit's grid headings
  float* poses;
  unsigned char* found_out;
  int channels, img_channels, k, height, width;
  int center, yaw_frame, fit_auto;
  int boundary[2];  // the fit's arms: [0] oriented (or the only one), [1] symmetric
  float factor[2];
  float min_prob, min_height, range_offset;
};

// The lane's scalars, computed by thread 0 and read by the CTA.
struct Lane {
  int go;    // after pass 1 -- 0: the lane's outputs are written, the CTA returns
  int stage;  // after the lane's scalars -- 0: written, returns; 1: write the seed; 2: fit
  float dmin_m, dmin_c;  // min d over m, over the cluster's valid pixels
  float yaw, l, w, h;
  float seed[3];
  int oriented;
  // the fit
  int boundary, ncand, n_pts;
  float a, b, gate2, nw, lam;
  float phis[kMaxCands];
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // the same value in every lane: each step adds a pair both ways
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}

// The CTA's sums of v[0..n) in every thread (each warp's, then the warps'
// in order, so every thread holds the same values).
template <int N>
__device__ void block_sums(double (&v)[N], double (*red)[kSums]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[w][i];
    v[i] = s;
  }
  __syncthreads();
}

// jnp.remainder of float32: exact fmod, shifted by y where the signs differ
__device__ __forceinline__ float floor_mod(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) ? __fadd_rn(r, y) : r;
}

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
}

// torch.argmin over n values: the first minimum, a NaN wins
__device__ int first_argmin(const float* v, int n) {
  int best = 0;
  for (int j = 1; j < n && !isnan(v[best]); ++j)
    if (isnan(v[j]) || v[j] < v[best]) best = j;
  return best;
}

// push: the surface point moved out along its ray by the box's half
// extent 0.5 (l |cos d| + w |sin d|), d = its azimuth - yaw
__device__ void push(const float* in, float yaw, float l, float w, float* out) {
  const float x = in[0], y = in[1];
  const float d = __fsub_rn(atan2f(y, x), yaw);
  const float p = __fmul_rn(0.5f, __fadd_rn(__fmul_rn(l, fabsf(cosf(d))),
                                            __fmul_rn(w, fabsf(sinf(d)))));
  const float rho = __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
  const float scale = __fdiv_rn(__fadd_rn(rho, p), fmaxf(rho, 1e-6f));
  out[0] = __fmul_rn(x, scale);
  out[1] = __fmul_rn(y, scale);
  out[2] = in[2];
}

struct Window {
  int x0, x1, y0, y1, ww, npx;
  size_t frame;  // the frame's first pixel
};

// A window pixel's raster index t -> its frame pixel
__device__ __forceinline__ void window_pixel(const Window& win, int t, int width, int& x, int& y,
                                             size_t& q) {
  y = win.y0 + t / win.ww;
  x = win.x0 + t % win.ww;
  q = win.frame + (size_t)y * width + x;
}

// The fit's gate of a window pixel: the cluster's valid pixel within the
// surface depth and within the gate of the seed; (px, py) its point
__device__ __forceinline__ bool gated(const Params& p, const Window& win, const Lane& L,
                                      int root, int t, float& px, float& py) {
  int x, y;
  size_t q;
  window_pixel(win, t, p.width, x, y, q);
  if (!p.mask[q] || p.labels[q] != root) return false;
  const float d = p.image[q * p.img_channels], hh = p.image[q * p.img_channels + 1];
  if (!(d > 0.0f && hh > p.min_height) || !(d <= __fadd_rn(L.dmin_c, 4.0f))) return false;
  px = __fmul_rn(d, p.cos_t[x]);
  py = __fmul_rn(-d, p.sin_t[x]);
  const float e0 = __fsub_rn(px, L.seed[0]), e1 = __fsub_rn(py, L.seed[1]);
  const float e2 = __fsub_rn(hh, L.seed[2]);
  const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1)), __fmul_rn(e2, e2));
  return n2 <= L.gate2;
}

// One point's residual r and its Jacobian (jx, jy) in the centre, as
// _fit_pose_to_surface's residual() and Gauss-Newton step round them
__device__ __forceinline__ void residual(int boundary, float a, float b, float c, float s,
                                         float px, float py, float mx, float my, float& r,
                                         float& jx, float& jy) {
  const float dx = __fsub_rn(px, mx), dy = __fsub_rn(py, my);
  const float u = __fadd_rn(__fmul_rn(c, dx), __fmul_rn(s, dy));
  const float v = __fadd_rn(__fmul_rn(-s, dx), __fmul_rn(c, dy));
  float gu, gv;
  if (boundary == kBox) {
    const float su = __fdiv_rn(fabsf(u), a), sv = __fdiv_rn(fabsf(v), b);
    r = __fsub_rn(fmaxf(su, sv), 1.0f);
    const bool act_u = su >= sv;
    gu = act_u ? __fdiv_rn(sign_of(u), a) : 0.0f;
    gv = act_u ? 0.0f : __fdiv_rn(sign_of(v), b);
  } else {
    const float vx = __fdiv_rn(u, a), vy = __fdiv_rn(v, b);
    r = __fsub_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)), 1.0f);
    gu = __fdiv_rn(__fmul_rn(2.0f, vx), a);
    gv = __fdiv_rn(__fmul_rn(2.0f, vy), b);
  }
  jx = -__fsub_rn(__fmul_rn(c, gu), __fmul_rn(s, gv));
  jy = -__fadd_rn(__fmul_rn(s, gu), __fmul_rn(c, gv));
}

__global__ void __launch_bounds__(kThreads) decode_direct_kernel(const Params p) {
  __shared__ double red[kWarps][kSums];
  __shared__ float redf[kWarps][2];
  __shared__ int redi[kWarps];
  __shared__ unsigned long long s_key;
  __shared__ Lane L;
  __shared__ float2 pts[kPointCap];
  __shared__ float s_ress[kMaxCands], s_mx[kMaxCands], s_my[kMaxCands];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int id = blockIdx.x;  // frame * k + lane
  const int b = id / p.k;
  float* out = p.poses + (size_t)id * 7;
  if (!p.found[id]) {
    if (tid < 7) out[tid] = 0.0f;
    if (tid == 0) p.found_out[id] = 0;
    return;
  }
  const int W = p.width;
  Window win;
  win.frame = (size_t)b * p.height * W;
  const long long r64 = p.root[id];
  const int root = (int)r64;
  {
    const size_t q = win.frame + (size_t)r64;
    win.x0 = p.min_x[q];
    win.x1 = p.max_x[q];
    win.y0 = p.min_y[q];
    win.y1 = p.max_y[q];
  }
  win.ww = win.x1 - win.x0 + 1;
  win.npx = win.ww * (win.y1 - win.y0 + 1);
  const int center = p.center;
  const bool dual = p.channels >= 12;
  const bool want_local = p.yaw_frame != kGlobal, want_global = p.yaw_frame != kLocal;
  const bool want_bp = center == kBackproject || center == kGeometric || center == kConsensus ||
                       center == kFit;
  // the back-projection: the shrunk bbox [l, r] x [t, bt], its integer centroid
  const int bl = win.x0 + 2, bt = win.y0 + 2, br = win.x1 - 2, bb = win.y1 - 2;
  const int cx = (win.x0 + win.x1) / 2, cy = (win.y0 + win.y1) / 2;

  // pass 1
  double acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0;
  float dmin_m = INFINITY, dmin_c = INFINITY;
  int n_m = 0;
  unsigned long long key = kNoKey;
  if (tid == 0) s_key = kNoKey;
  for (int t = tid; t < win.npx; t += kThreads) {
    int x, y;
    size_t q;
    window_pixel(win, t, W, x, y, q);
    const float d = p.image[q * p.img_channels], hh = p.image[q * p.img_channels + 1];
    const bool valid = d > 0.0f && hh > p.min_height;
    if (want_bp && valid && x >= bl && x <= br && y >= bt && y <= bb) {
      const unsigned dx = (unsigned)abs(x - cx), dy = (unsigned)abs(y - cy);
      const unsigned long long k2 = ((unsigned long long)(dx * dx + dy * dy) << 32) |
                                    (unsigned)(y * W + x);
      key = k2 < key ? k2 : key;
    }
    if (!valid || !p.mask[q] || p.labels[q] != root) continue;
    dmin_c = fminf(dmin_c, d);
    const float* yp = p.y_pred + q * p.channels;
    const float prob = yp[1];
    if (!(prob >= p.min_prob)) continue;
    ++n_m;
    dmin_m = fminf(dmin_m, d);
    acc[0] += prob;
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[1 + i] += __fmul_rn(yp[5 + i], prob);
    const float ct = p.cos_t[x], st = p.sin_t[x];
    if (want_local) {  // sin / cos(yaw + theta): the pixel's vector rotated back
      const float s_px = yp[8], c_px = yp[9];
      acc[4] += __fmul_rn(__fsub_rn(__fmul_rn(s_px, ct), __fmul_rn(c_px, st)), prob);
      acc[5] += __fmul_rn(__fadd_rn(__fmul_rn(c_px, ct), __fmul_rn(s_px, st)), prob);
    }
    if (want_global) {
      const int gi = dual ? 10 : 8;
      acc[6] += __fmul_rn(yp[gi], prob);
      acc[7] += __fmul_rn(yp[gi + 1], prob);
    }
    if (center == kHead) {  // R dc + p, R = Rz(theta) Ry(phi)
      const float cp = p.cos_p[y], sp = p.sin_p[y];
      const float v0 = yp[2], v1 = yp[3], v2 = yp[4];
      const float pt[3] = {__fmul_rn(d, ct), __fmul_rn(-d, st), hh};
      const float rot[3][3] = {{__fmul_rn(ct, cp), -st, __fmul_rn(ct, sp)},
                               {__fmul_rn(st, cp), ct, __fmul_rn(st, sp)},
                               {-sp, 0.0f, cp}};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float rv = fmaf(rot[i][2], v2, fmaf(rot[i][1], v1, __fmul_rn(rot[i][0], v0)));
        acc[8 + i] += __fmul_rn(__fadd_rn(rv, pt[i]), prob);
      }
    }
  }
  block_sums(acc, red);
  dmin_m = warp_min(dmin_m);
  dmin_c = warp_min(dmin_c);
  key = warp_min(key);
#pragma unroll
  for (int o = 16; o; o >>= 1) n_m += __shfl_xor_sync(0xffffffffu, n_m, o);
  if (lane == 0) {
    redf[warp][0] = dmin_m;
    redf[warp][1] = dmin_c;
    redi[warp] = n_m;
    atomicMin(&s_key, key);
  }
  __syncthreads();

  if (tid == 0) {
    float dm = INFINITY, dc = INFINITY;
    int n = 0;
    for (int w = 0; w < kWarps; ++w) {
      dm = fminf(dm, redf[w][0]);
      dc = fminf(dc, redf[w][1]);
      n += redi[w];
    }
    L.dmin_m = dm;
    L.dmin_c = dc;
    L.go = n > 0;  // nonempty; an empty lane is not found
    if (!L.go) {
      for (int i = 0; i < 7; ++i) out[i] = 0.0f;
      p.found_out[id] = 0;
    } else {
      const float tot = fmaxf((float)acc[0], 1e-6f);
      L.l = __fdiv_rn((float)acc[1], tot);
      L.w = __fdiv_rn((float)acc[2], tot);
      L.h = __fdiv_rn((float)acc[3], tot);
      float sin_m, cos_m;
      if (p.yaw_frame == kLocal) {
        sin_m = __fdiv_rn((float)acc[4], tot);
        cos_m = __fdiv_rn((float)acc[5], tot);
        L.oriented = 1;
      } else if (p.yaw_frame == kGlobal) {
        sin_m = __fdiv_rn((float)acc[6], tot);
        cos_m = __fdiv_rn((float)acc[7], tot);
        L.oriented = 0;
      } else {  // the codec whose mean vector is longer
        const float sl = __fdiv_rn((float)acc[4], tot), cl = __fdiv_rn((float)acc[5], tot);
        const float sg = __fdiv_rn((float)acc[6], tot), cg = __fdiv_rn((float)acc[7], tot);
        L.oriented = __fadd_rn(__fmul_rn(sl, sl), __fmul_rn(cl, cl)) >=
                     __fadd_rn(__fmul_rn(sg, sg), __fmul_rn(cg, cg));
        sin_m = L.oriented ? sl : sg;
        cos_m = L.oriented ? cl : cg;
      }
      L.yaw = atan2f(sin_m, cos_m);
      if (center == kHead) {  // back to the reference's frame: Rz(-yaw) c_phys
        const float c0 = __fdiv_rn((float)acc[8], tot), c1 = __fdiv_rn((float)acc[9], tot);
        const float c2 = __fdiv_rn((float)acc[10], tot);
        const float c = cosf(-L.yaw), s = sinf(-L.yaw);
        out[0] = __fsub_rn(__fmul_rn(c, c0), __fmul_rn(s, c1));
        out[1] = __fadd_rn(__fmul_rn(s, c0), __fmul_rn(c, c1));
        out[2] = c2;
        out[3] = L.yaw;
        out[4] = L.l;
        out[5] = L.w;
        out[6] = L.h;
        p.found_out[id] = 1;
        L.go = 0;
      }
    }
  }
  __syncthreads();
  if (!L.go) return;

  // pass 2: the surface mean over m within a vehicle depth of its closest return
  float p_mean[3] = {0.0f, 0.0f, 0.0f};
  if (center == kSurface || center == kConsensus || center == kFit) {
    double sm[4] = {0.0, 0.0, 0.0, 0.0};
    const float dlim = __fadd_rn(L.dmin_m, 4.0f);
    for (int t = tid; t < win.npx; t += kThreads) {
      int x, y;
      size_t q;
      window_pixel(win, t, W, x, y, q);
      if (!p.mask[q] || p.labels[q] != root) continue;
      const float d = p.image[q * p.img_channels], hh = p.image[q * p.img_channels + 1];
      if (!(d > 0.0f && hh > p.min_height)) continue;
      const float prob = p.y_pred[q * p.channels + 1];
      if (!(prob >= p.min_prob) || !(d <= dlim)) continue;
      sm[0] += prob;
      sm[1] += __fmul_rn(__fmul_rn(d, p.cos_t[x]), prob);
      sm[2] += __fmul_rn(__fmul_rn(-d, p.sin_t[x]), prob);
      sm[3] += __fmul_rn(hh, prob);
    }
    block_sums(sm, red);
    const float ws = fmaxf((float)sm[0], 1e-6f);
#pragma unroll
    for (int i = 0; i < 3; ++i) p_mean[i] = __fdiv_rn((float)sm[1 + i], ws);
  }

  if (tid == 0) {
    float xyz[3] = {0.0f, 0.0f, 0.0f};
    bool bp_ok = true;
    if (want_bp) {
      const size_t qc = win.frame + (size_t)cy * W + cx;
      const bool centroid_ok =
          p.image[qc * p.img_channels] > 0.0f && p.image[qc * p.img_channels + 1] > p.min_height;
      const bool use_fallback = !centroid_ok && bl != 0 && br != 0;
      int nx = cx, ny = cy;
      if (use_fallback) {
        const bool fb_ok = s_key != kNoKey;
        const int idx = (int)(s_key & 0xffffffffu);
        nx = fb_ok ? idx % W : 0;
        ny = fb_ok ? idx / W : 0;
      }
      bp_ok = !(nx == 0 && ny == 0);
      if (bp_ok) {
        const size_t q = win.frame + (size_t)ny * W + nx;
        const float d = __fadd_rn(p.image[q * p.img_channels], p.range_offset);
        xyz[0] = __fmul_rn(d, p.cos_t[nx]);
        xyz[1] = __fmul_rn(-d, p.sin_t[nx]);
        xyz[2] = p.image[q * p.img_channels + 1];
      }
    }
    if (center == kSurface) {
      push(p_mean, L.yaw, L.l, L.w, xyz);
    } else if (center == kConsensus || center == kFit) {
      float geo[3], surf[3];
      push(xyz, L.yaw, L.l, L.w, geo);
      push(p_mean, L.yaw, L.l, L.w, surf);
      const float e0 = __fsub_rn(surf[0], geo[0]), e1 = __fsub_rn(surf[1], geo[1]);
      const float e2 = __fsub_rn(surf[2], geo[2]);
      const bool agree =
          __fadd_rn(__fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1)), __fmul_rn(e2, e2)) <= 6.25f;
      for (int i = 0; i < 3; ++i) xyz[i] = agree ? surf[i] : geo[i];
    } else if (center == kGeometric) {
      const float raw[3] = {xyz[0], xyz[1], xyz[2]};
      push(raw, L.yaw, L.l, L.w, xyz);
    }
    for (int i = 0; i < 3; ++i) L.seed[i] = xyz[i];
    // a field of its own: other warps may still be reading L.go
    L.stage = bp_ok ? (center == kFit ? 2 : 1) : 0;
    if (!bp_ok) {
      for (int i = 0; i < 7; ++i) out[i] = 0.0f;
      p.found_out[id] = 0;
    }
    if (L.stage == 2) {  // the fit's arm, radius, gate and candidates
      const int arm = (p.fit_auto && !L.oriented) ? 1 : 0;
      L.boundary = p.boundary[arm];
      const float f = p.factor[arm];
      const float diag = __fsqrt_rn(__fadd_rn(__fmul_rn(L.l, L.l), __fmul_rn(L.w, L.w)));
      const float head_phi = floor_mod(L.yaw, kPi);
      if (L.boundary == kCircle) {
        L.a = L.b = fmaxf(__fmul_rn(f, diag), 1e-2f);
        L.ncand = 1;
      } else {
        L.a = fmaxf(__fmul_rn(__fmul_rn(f, L.l), 0.5f), 1e-2f);
        L.b = fmaxf(__fmul_rn(__fmul_rn(f, L.w), 0.5f), 1e-2f);
        for (int j = 0; j < kGridPhis; ++j) L.phis[j] = p.phi_grid[j];
        L.ncand = kMaxCands;
      }
      L.phis[L.ncand - 1] = head_phi;
      const float gate = __fadd_rn(__fmul_rn(0.5f, diag), 3.0f);
      L.gate2 = __fmul_rn(gate, gate);
    }
  }
  __syncthreads();
  if (L.stage != 2) {
    if (tid == 0 && L.stage == 1) {
      const float c = cosf(-L.yaw), s = sinf(-L.yaw);
      out[0] = __fsub_rn(__fmul_rn(c, L.seed[0]), __fmul_rn(s, L.seed[1]));
      out[1] = __fadd_rn(__fmul_rn(s, L.seed[0]), __fmul_rn(c, L.seed[1]));
      out[2] = L.seed[2];
      out[3] = L.yaw;
      out[4] = L.l;
      out[5] = L.w;
      out[6] = L.h;
      p.found_out[id] = 1;
    }
    return;
  }

  // pass 3: the gated points, compacted in raster order
  int n_pts = 0;
  for (int base = 0; base < win.npx; base += kThreads) {
    float px = 0.0f, py = 0.0f;
    const bool g = base + tid < win.npx && gated(p, win, L, root, base + tid, px, py);
    const unsigned bal = __ballot_sync(0xffffffffu, g);
    if (lane == 0) redi[warp] = __popc(bal);
    __syncthreads();
    int before = n_pts;
    for (int w = 0; w < warp; ++w) before += redi[w];
    const int slot = before + __popc(bal & ((1u << lane) - 1u));
    if (g && slot < kPointCap) pts[slot] = make_float2(px, py);
    for (int w = 0; w < kWarps; ++w) n_pts += redi[w];
    __syncthreads();
  }
  const bool held = n_pts <= kPointCap;
  const float nw = fmaxf((float)n_pts, 1e-6f);
  const float lam = __fmul_rn(0.08f, nw);
  const float sx = L.seed[0], sy = L.seed[1], a = L.a, bax = L.b;
  const int boundary = L.boundary;

  // the fit: a warp a candidate heading
  for (int c_i = warp; c_i < L.ncand; c_i += kWarps) {
    const float phi = L.phis[c_i];
    const float c = cosf(phi), s = sinf(phi);
    float mx = sx, my = sy;
    for (int it = 0; it <= kGnIters; ++it) {
      double sum[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
      const int n_walk = held ? n_pts : win.npx;
      for (int i = lane; i < n_walk; i += 32) {
        float px, py;
        if (held) {
          px = pts[i].x;
          py = pts[i].y;
        } else if (!gated(p, win, L, root, i, px, py)) {
          continue;
        }
        float r, jx, jy;
        residual(boundary, a, bax, c, s, px, py, mx, my, r, jx, jy);
        if (it == kGnIters) {
          sum[0] += __fmul_rn(r, r);
        } else {
          sum[0] += __fmul_rn(jx, jx);
          sum[1] += __fmul_rn(jx, jy);
          sum[2] += __fmul_rn(jy, jy);
          sum[3] += __fmul_rn(jx, r);
          sum[4] += __fmul_rn(jy, r);
        }
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) sum[i] = warp_sum(sum[i]);
      if (it == kGnIters) {
        if (lane == 0) {
          s_ress[c_i] = __fdiv_rn((float)sum[0], nw);
          s_mx[c_i] = mx;
          s_my[c_i] = my;
        }
        break;
      }
      const float jxx = __fadd_rn((float)sum[0], lam), jxy = (float)sum[1];
      const float jyy = __fadd_rn((float)sum[2], lam);
      const float bx = __fadd_rn((float)sum[3], __fmul_rn(lam, __fsub_rn(mx, sx)));
      const float by = __fadd_rn((float)sum[4], __fmul_rn(lam, __fsub_rn(my, sy)));
      const float det = __fsub_rn(__fmul_rn(jxx, jyy), __fmul_rn(jxy, jxy));
      const float nx = __fsub_rn(mx, __fdiv_rn(__fsub_rn(__fmul_rn(jyy, bx), __fmul_rn(jxy, by)), det));
      const float ny = __fsub_rn(my, __fdiv_rn(__fsub_rn(__fmul_rn(jxx, by), __fmul_rn(jxy, bx)), det));
      mx = nx;
      my = ny;
    }
  }
  __syncthreads();

  if (tid == 0) {
    const int last = L.ncand - 1;
    const int i = first_argmin(s_ress, L.ncand);
    const bool decisive = s_ress[i] < __fmul_rn(0.9f, s_ress[last]);
    const float ctr[2] = {decisive ? s_mx[i] : s_mx[last], decisive ? s_my[i] : s_my[last]};
    float phi = decisive ? L.phis[i] : L.phis[last];
    // the boundary's pi-symmetry, resolved with the head yaw
    const float cand[3] = {phi, __fadd_rn(phi, kPi), __fsub_rn(phi, kPi)};
    float off[3];
    for (int j = 0; j < 3; ++j)
      off[j] = fabsf(__fsub_rn(floor_mod(__fadd_rn(__fsub_rn(cand[j], L.yaw), kPi), kTwoPi), kPi));
    phi = cand[first_argmin(off, 3)];
    const float d0 = __fsub_rn(ctr[0], L.seed[0]), d1 = __fsub_rn(ctr[1], L.seed[1]);
    const bool ok_fit = (float)n_pts >= 5.0f &&
                        __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)) <= 4.0f;
    const float x = ok_fit ? ctr[0] : L.seed[0], y = ok_fit ? ctr[1] : L.seed[1];
    const float yaw = ok_fit ? phi : L.yaw;
    const float c = cosf(-yaw), s = sinf(-yaw);
    out[0] = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
    out[1] = __fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y));
    out[2] = L.seed[2];
    out[3] = yaw;
    out[4] = L.l;
    out[5] = L.w;
    out[6] = L.h;
    p.found_out[id] = 1;
  }
}

}  // namespace

extern "C" int tf_decode_direct(const void* y_pred, int channels, const void* image,
                                int img_channels, const void* mask, const void* labels,
                                const void* min_x, const void* max_x, const void* min_y,
                                const void* max_y, const void* root, const void* found,
                                int frames, int k, int height, int width, const void* cos_t,
                                const void* sin_t, const void* cos_p, const void* sin_p,
                                const void* phi_grid, int center, int yaw_frame, int fit_auto,
                                int boundary0, int boundary1, const float* consts, void* poses,
                                void* found_out, void* stream) {
  if (frames <= 0 || k <= 0) return (int)cudaGetLastError();
  if (channels < 10 || (yaw_frame == kAuto && channels < 12) || img_channels < 2 ||
      center < kBackproject || center > kFit || yaw_frame < kLocal || yaw_frame > kAuto ||
      boundary0 < kCircle || boundary0 > kBox || boundary1 < kCircle || boundary1 > kBox ||
      (long long)frames * k > 0x7fffffffLL || (long long)frames * height * width > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y_pred = (const float*)y_pred;
  p.image = (const float*)image;
  p.mask = (const unsigned char*)mask;
  p.labels = (const int*)labels;
  p.min_x = (const int*)min_x;
  p.max_x = (const int*)max_x;
  p.min_y = (const int*)min_y;
  p.max_y = (const int*)max_y;
  p.root = (const long long*)root;
  p.found = (const unsigned char*)found;
  p.cos_t = (const float*)cos_t;
  p.sin_t = (const float*)sin_t;
  p.cos_p = (const float*)cos_p;
  p.sin_p = (const float*)sin_p;
  p.phi_grid = (const float*)phi_grid;
  p.poses = (float*)poses;
  p.found_out = (unsigned char*)found_out;
  p.channels = channels;
  p.img_channels = img_channels;
  p.k = k;
  p.height = height;
  p.width = width;
  p.center = center;
  p.yaw_frame = yaw_frame;
  p.fit_auto = fit_auto;
  p.boundary[0] = boundary0;
  p.boundary[1] = boundary1;
  p.min_prob = consts[0];
  p.min_height = consts[1];
  p.range_offset = consts[2];
  p.factor[0] = consts[3];
  p.factor[1] = consts[4];
  decode_direct_kernel<<<frames * k, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
