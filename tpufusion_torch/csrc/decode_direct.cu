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
// window pixels a car (each window pixel's mask, its label where the mask
// is set, the image's distance and height, the few y_pred channels the
// center and yaw frame read): well under a microsecond at 3.35 TB/s, so the
// bound in use is the launch floor, and the design keeps to one launch.
// What held the first design (one 256-thread CTA a lane) far above that
// floor was latency: its phase split (probes/phase_split.py) put the
// largest lane's three walks of the window from global memory and its
// Gauss-Newton fit on one warp at about 15-25 µs each.
//
// Design: a thread-block cluster of kCluster CTAs a (frame, lane), launched
// with cudaLaunchKernelEx; a lane that _topk_roots did not find writes
// zeros and returns (the plain version masks every output of such a lane).
// The lane's window (rows min_y..max_y x columns min_x..max_x read at its
// root pixel; the CC kernel converges, so they hold every pixel labelled
// with the root) is cut in raster order into kCluster slices, one a CTA (a
// row may straddle two CTAs); a warp takes every eighth run of 32 pixels of
// its CTA's slice.
//   pass 1  each slice pixel read once from global memory: on the cluster's
//           pixels (mask, label == root) that are valid, m = prob >=
//           min_prob, the sums of prob, l w h, the yaw frame's sin / cos
//           (both frames for auto) and the head's center, each term the
//           float32 product torch rounds, summed in float64; min d over m
//           and over the cluster's valid pixels; the back-projection's
//           nearest valid pixel in the window shrunk by 2, as the exact
//           integer dx^2 + dy^2 packed with the flat index into 64 bits
//           and taken by a min (the plain version's first argmin of the
//           correctly rounded sqrt: a sqrt keeps the order and the ties of
//           integers below 2^22). Each cluster-valid pixel's point (x, y),
//           height, distance and probability is staged in shared memory,
//           compacted by ballot into its warp's region (kStageCap a CTA;
//           past it the CTA walks its slice in global memory again, as the
//           first design did)
//   thread 0 of every CTA computes the lane's scalars from the cluster's
//           totals (the same values in each): yaw, size, back-projection,
//           push, consensus, the fit's arm, radius and gate
//   pass 2  the surface mean over m with d <= dmin + 4, from the stage
//   pass 3  the fit's gated points (cluster, valid, d <= dmin + 4, within
//           the gate of the seed), compacted from the stage into a list,
//           then gathered into every CTA of the cluster (through
//           distributed shared memory, the CTAs by rank) in the stage's
//           room; past kGatherCap points, or where a slice was not staged,
//           the fit reads the window from global memory again
//   fit     4 Gauss-Newton steps and the residual a candidate heading (1
//           for a circle, 37 for an ellipse or a box; the auto boundary
//           fits only the arm the yaw gate picked, the one the plain
//           version keeps), with no exchange between rounds: a circle's
//           one heading in rank 0 over all its threads, 37 headings split
//           over the cluster's warps (heading h in rank h % kCluster), a
//           warp's rounds its own; then thread 0 of rank 0 reads each
//           heading's result, takes the first minimum, the decisive test,
//           the pi-resolution against the head yaw and ok_fit. (Exchanging
//           each round's sums across the cluster instead cost a cluster
//           barrier a round, ~9 µs a lane by the phase split.)
// Every sum is a float64 sum of float32 terms in a fixed order, rounded
// once: each thread's terms, its warp's tree, the warps in order, and for
// the pass sums then the cluster's CTAs by rank through distributed shared
// memory; a call always gives the same bits. Each pass's exchange is one
// cluster barrier; its buffers alternate, so a CTA that runs ahead never
// overwrites a buffer another still reads. Minima go the same way (no
// 64-bit atomic on distributed shared memory: probes/dsmem_min64.cu).
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
//
// A bf16 y_pred (the kernel's second instance, over __nv_bfloat16 loads)
// computes what the plain version computes for it, as XLA computes the
// reference's bf16 ops on the CPU: every op in float32 on exact values
// (a product of two bf16 channels is exact in float32), a result rounded
// to bf16 (`Elem<T>::keep`) only where the reference feeds it to another
// bf16 op: the sums of the weight, the sizes, the global frame's sin /
// cos and the surface weight (each the float64 sum rounded to float32,
// then to bf16, as the plain version rounds its float64 sum), the global
// frame's quotients before its atan2 and the auto gate's squares, and the
// global frame's yaw. A float16 y_pred (the third instance, over __half
// loads) rounds at those points and, as XLA runs each op of two float16
// values in float16, also each such op's result (`Elem<T>::op`): the
// products of two channels before they are summed, the quotients of the
// rounded sums by the weight, the auto gate's sum of squares, and the cos
// / sin of the global frame's negated yaw in the head's center; the
// clamp of the weight is float16(1e-6), a subnormal (`Elem<T>::tiny`).
// Every conversion is round to nearest with subnormals kept (no -ftz, no
// fast math in _build.py's flags). The wrapper rounds min_prob to the
// head's type, the type the reference compares in. The float32 instance
// rounds nothing more.
//
// The cluster width is a compile-time constant (-DTF_DECODE_CLUSTER=N, N in
// 1..8, builds the variants `kernel_bench.py` times beside it).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Phase stamps for probes/phase_stamps.cu (nothing in the shipped build).
#ifndef TF_STAMP
#define TF_STAMP(kernel, slot)
#endif

#ifndef TF_DECODE_CLUSTER
#define TF_DECODE_CLUSTER 2
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = TF_DECODE_CLUSTER;  // CTAs a lane
static_assert(kCluster >= 1 && kCluster <= 8, "a portable cluster holds 1 to 8 CTAs");
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGridPhis = 36;
constexpr int kMaxCands = kGridPhis + 1;
constexpr int kGnIters = 4;
constexpr int kStageCap = 1024;  // cluster-valid pixels a CTA stages (28 KB with its list)
constexpr int kWarpCap = kStageCap / kWarps;
constexpr int kGatherCap = kStageCap * 5 / 2;  // the lane's gated points, in the stage's room
constexpr int kSums = 11;
constexpr int kFitSums = 5;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr unsigned long long kNoKey = ~0ull;
enum { kBackproject, kGeometric, kSurface, kConsensus, kHead, kFit };  // decode_direct.CENTERS
enum { kCircle, kEllipse, kBox };                                      // decode_direct.BOUNDARIES
enum { kLocal, kGlobal, kAuto };                                       // decode_direct.YAW_FRAMES

// y_pred's element type: its load as a float, the rounding of a float32
// result to it where the reference rounds a sum (`keep`) and where it runs
// an op of two head values in the head's type (`op`), and the weight's
// clamp in that type (`tiny`); nothing for float
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* v, size_t i) { return v[i]; }
  static __device__ __forceinline__ float keep(float x) { return x; }
  static __device__ __forceinline__ float op(float x) { return x; }
  static constexpr float tiny = 1e-6f;
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* v, size_t i) {
    return __bfloat162float(v[i]);
  }
  static __device__ __forceinline__ float keep(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float op(float x) { return x; }  // XLA keeps float32
  static constexpr float tiny = 1e-6f;
};
template <>
struct Elem<__half> {
  static __device__ __forceinline__ float load(const __half* v, size_t i) {
    return __half2float(v[i]);
  }
  static __device__ __forceinline__ float keep(float x) { return __half2float(__float2half_rn(x)); }
  // an op of two float16 values, computed in float32 and rounded once:
  // the correctly rounded float16 result of a product or a quotient (24
  // bits hold 2 x 11 + 2)
  static __device__ __forceinline__ float op(float x) { return keep(x); }
  static constexpr float tiny = 0x1.1p-20f;  // float16(1e-6) = 17 x 2^-24, a subnormal
};

struct Params {
  const void* y_pred;  // float, __nv_bfloat16 or __half, the kernel's instance
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

// The lane's scalars, computed by thread 0 of each CTA from the cluster's
// totals (the same values in every CTA) and read by its threads.
struct Lane {
  int go;       // after pass 1 -- 0: the lane's outputs are written, the cluster returns
  int written;  // the head's center wrote the outputs
  int stage;    // after the lane's scalars -- 0: zeros, returns; 1: write the seed; 2: fit
  float dmin_m, dmin_c;  // min d over m, over the cluster's valid pixels
  float yaw, l, w, h;
  float seed[3];
  int oriented;
  unsigned long long key;  // the back-projection's nearest valid pixel, packed
  // the fit
  int boundary, ncand;
  float a, b, gate2;
  float phis[kMaxCands];
};

// One CTA's partials of an exchange, read by every CTA of the cluster.
struct Xchg {
  double v[kSums];
  float dmin[2];
  int n;     // pass 1: m's count; pass 3: the CTA's gated points
  int held;  // pass 3: every cluster-valid pixel of the slice was staged
  unsigned long long key;
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
  int lo, hi;    // this CTA's slice of the raster range [0, npx)
  size_t frame;  // the frame's first pixel
};

// A window pixel's raster index t -> its frame pixel
__device__ __forceinline__ void window_pixel(const Window& win, int t, int width, int& x, int& y,
                                             size_t& q) {
  y = win.y0 + t / win.ww;
  x = win.x0 + t % win.ww;
  q = win.frame + (size_t)y * width + x;
}

// The fit's gate of a cluster-valid point: within the surface depth and
// within the gate of the seed
__device__ __forceinline__ bool in_gate(const Lane& L, float px, float py, float hh, float d) {
  if (!(d <= __fadd_rn(L.dmin_c, 4.0f))) return false;
  const float e0 = __fsub_rn(px, L.seed[0]), e1 = __fsub_rn(py, L.seed[1]);
  const float e2 = __fsub_rn(hh, L.seed[2]);
  const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1)), __fmul_rn(e2, e2));
  return n2 <= L.gate2;
}

// The same for a window pixel read from global memory: the cluster's
// valid pixel within the gate; (px, py) its point
__device__ __forceinline__ bool gated(const Params& p, const Window& win, const Lane& L,
                                      int root, int t, float& px, float& py) {
  int x, y;
  size_t q;
  window_pixel(win, t, p.width, x, y, q);
  if (!p.mask[q] || p.labels[q] != root) return false;
  const float d = p.image[q * p.img_channels], hh = p.image[q * p.img_channels + 1];
  if (!(d > 0.0f && hh > p.min_height)) return false;
  px = __fmul_rn(d, p.cos_t[x]);
  py = __fmul_rn(-d, p.sin_t[x]);
  return in_gate(L, px, py, hh, d);
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

// A point's terms of a Gauss-Newton round (or, on the last, of the
// residual) added to its thread's sums
__device__ __forceinline__ void fit_terms(int boundary, float a, float b, float c, float s,
                                          float px, float py, float mx, float my, bool last,
                                          double (&sum)[kFitSums]) {
  float r, jx, jy;
  residual(boundary, a, b, c, s, px, py, mx, my, r, jx, jy);
  if (last) {
    sum[0] += __fmul_rn(r, r);
  } else {
    sum[0] += __fmul_rn(jx, jx);
    sum[1] += __fmul_rn(jx, jy);
    sum[2] += __fmul_rn(jy, jy);
    sum[3] += __fmul_rn(jx, r);
    sum[4] += __fmul_rn(jy, r);
  }
}

// The CTA's partials of n sums into x->v: the warps' values wsum[w][i]
// added in warp order. Call after a CTA barrier that follows the writes
// of wsum.
__device__ __forceinline__ void cta_partial(const double (*wsum)[kSums], int n, Xchg* x) {
  if ((int)threadIdx.x < n) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += wsum[w][threadIdx.x];
    x->v[threadIdx.x] = s;
  }
}

// The cluster's totals of entries [0, n) of every CTA's x, the CTAs by
// rank, into tot: one cluster barrier, then a CTA barrier.
__device__ __forceinline__ void cluster_totals(cg::cluster_group& cluster, Xchg* x, int n,
                                               double* tot) {
  cluster.sync();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(x, r)->v[i];
    tot[i] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_direct_kernel(const Params p) {
  using E = Elem<T>;
  const T* const y_pred = static_cast<const T*>(p.y_pred);
  // the stage (x, y, height, distance, probability a pixel); after pass 3
  // the lane's gathered points (kGatherCap float2) in the same room
  __shared__ __align__(16) float s_stage[5][kStageCap];
  float* const s_px = s_stage[0];
  float* const s_py = s_stage[1];
  float* const s_h = s_stage[2];
  float* const s_d = s_stage[3];
  float* const s_prob = s_stage[4];
  float2* const s_all = reinterpret_cast<float2*>(&s_stage[0][0]);
  __shared__ float2 s_pts[kStageCap];  // this CTA's gated points, read by the cluster
  __shared__ int s_count[kWarps];
  __shared__ double s_wsum[kWarps][kSums];
  __shared__ double s_fit[2][kWarps][kFitSums];  // a circle's round sums, by round parity
  __shared__ float s_surf[3];                     // the pushed surface mean
  __shared__ float s_wmin[kWarps][2];
  __shared__ int s_wn[kWarps];
  __shared__ unsigned long long s_wkey[kWarps];
  __shared__ Xchg s_x[2];  // the exchanges' buffers, alternating
  __shared__ double s_tot[kSums];
  __shared__ float s_mx[kMaxCands], s_my[kMaxCands], s_ress[kMaxCands];  // the fit's results
  __shared__ Lane L;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int id = blockIdx.x / kCluster;  // frame * k + lane
  TF_STAMP(0, 0);
  const int b = id / p.k;
  float* out = p.poses + (size_t)id * 7;
  const bool writer = rank == 0 && tid == 0;
  if (!p.found[id]) {  // no CTA of the cluster reads another's memory
    if (rank == 0 && tid < 7) out[tid] = 0.0f;
    if (writer) p.found_out[id] = 0;
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
  win.lo = (int)((long long)win.npx * rank / kCluster);
  win.hi = (int)((long long)win.npx * (rank + 1) / kCluster);
  const int center = p.center;
  const bool dual = p.channels >= 12;
  const bool want_local = p.yaw_frame != kGlobal, want_global = p.yaw_frame != kLocal;
  const bool want_bp = center == kBackproject || center == kGeometric || center == kConsensus ||
                       center == kFit;
  // the back-projection: the shrunk bbox [l, r] x [t, bt], its integer centroid
  const int bl = win.x0 + 2, bt = win.y0 + 2, br = win.x1 - 2, bb = win.y1 - 2;
  const int cx = (win.x0 + win.x1) / 2, cy = (win.y0 + win.y1) / 2;
  float cen_d = 0.0f, cen_h = 0.0f;  // the centroid pixel's return, read ahead by thread 0
  if (want_bp && tid == 0) {
    const size_t qc = win.frame + (size_t)cy * W + cx;
    cen_d = p.image[qc * p.img_channels];
    cen_h = p.image[qc * p.img_channels + 1];
  }
  int xi = 0;  // the exchanges so far: the next one's buffer is s_x[xi & 1]

  // pass 1: a warp takes every kWarps-th run of 32 pixels of the slice
  double acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0;
  float dmin_m = INFINITY, dmin_c = INFINITY;
  int n_m = 0, staged = 0;
  unsigned long long key = kNoKey;
  for (int base = win.lo + 32 * warp; base < win.hi; base += 32 * kWarps) {
    const int t = base + lane;
    bool in_cl = false;
    float d = 0.0f, hh = 0.0f, prob = 0.0f, px = 0.0f, py = 0.0f;
    if (t < win.hi) {
      int x, y;
      size_t q;
      window_pixel(win, t, W, x, y, q);
      // every load of the pixel issued before any is used: one round trip
      d = p.image[q * p.img_channels];
      hh = p.image[q * p.img_channels + 1];
      const bool marked = p.mask[q] != 0;
      const int label = p.labels[q];
      const bool valid = d > 0.0f && hh > p.min_height;
      if (want_bp && valid && x >= bl && x <= br && y >= bt && y <= bb) {
        const unsigned dx = (unsigned)abs(x - cx), dy = (unsigned)abs(y - cy);
        const unsigned long long k2 = ((unsigned long long)(dx * dx + dy * dy) << 32) |
                                      (unsigned)(y * W + x);
        key = k2 < key ? k2 : key;
      }
      in_cl = valid && marked && label == root;
      if (in_cl) {
        const T* yp = y_pred + q * p.channels;
        prob = E::load(yp, 1);
        float ch[10];  // l w h, the yaw frames' sin / cos, the head's offsets
#pragma unroll
        for (int i = 0; i < 7; ++i) ch[i] = (i < 5 || dual) ? E::load(yp, 5 + i) : 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i) ch[7 + i] = center == kHead ? E::load(yp, 2 + i) : 0.0f;
        const float ct = p.cos_t[x], st = p.sin_t[x];
        px = __fmul_rn(d, ct);
        py = __fmul_rn(-d, st);
        dmin_c = fminf(dmin_c, d);
        if (prob >= p.min_prob) {
          ++n_m;
          dmin_m = fminf(dmin_m, d);
          acc[0] += prob;
#pragma unroll
          for (int i = 0; i < 3; ++i) acc[1 + i] += E::op(__fmul_rn(ch[i], prob));
          if (want_local) {  // sin / cos(yaw + theta): the pixel's vector rotated back
            const float s_px = ch[3], c_px = ch[4];
            acc[4] += __fmul_rn(__fsub_rn(__fmul_rn(s_px, ct), __fmul_rn(c_px, st)), prob);
            acc[5] += __fmul_rn(__fadd_rn(__fmul_rn(c_px, ct), __fmul_rn(s_px, st)), prob);
          }
          if (want_global) {
            const int gi = dual ? 5 : 3;  // channel 10 or 8
            acc[6] += E::op(__fmul_rn(ch[gi], prob));
            acc[7] += E::op(__fmul_rn(ch[gi + 1], prob));
          }
          if (center == kHead) {  // R dc + p, R = Rz(theta) Ry(phi)
            const float cp = p.cos_p[y], sp = p.sin_p[y];
            const float v0 = ch[7], v1 = ch[8], v2 = ch[9];
            const float pt[3] = {px, py, hh};
            const float rot[3][3] = {{__fmul_rn(ct, cp), -st, __fmul_rn(ct, sp)},
                                     {__fmul_rn(st, cp), ct, __fmul_rn(st, sp)},
                                     {-sp, 0.0f, cp}};
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              const float rv =
                  fmaf(rot[i][2], v2, fmaf(rot[i][1], v1, __fmul_rn(rot[i][0], v0)));
              acc[8 + i] += __fmul_rn(__fadd_rn(rv, pt[i]), prob);
            }
          }
        }
      }
    }
    // stage the cluster-valid pixels, in order, in the warp's region
    const unsigned bal = __ballot_sync(0xffffffffu, in_cl);
    const int slot = staged + __popc(bal & below);
    if (in_cl && slot < kWarpCap) {
      const int e = warp * kWarpCap + slot;
      s_px[e] = px;
      s_py[e] = py;
      s_h[e] = hh;
      s_d[e] = d;
      s_prob[e] = prob;
    }
    staged += __popc(bal);
  }
  // the pass's partials: each warp's, then the CTA's in warp order
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = warp_sum(acc[i]);
  dmin_m = warp_min(dmin_m);
  dmin_c = warp_min(dmin_c);
  key = warp_min(key);
#pragma unroll
  for (int o = 16; o; o >>= 1) n_m += __shfl_xor_sync(0xffffffffu, n_m, o);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) s_wsum[warp][i] = acc[i];
    s_count[warp] = staged;
    s_wmin[warp][0] = dmin_m;
    s_wmin[warp][1] = dmin_c;
    s_wn[warp] = n_m;
    s_wkey[warp] = key;
  }
  __syncthreads();
  bool held = true;  // every cluster-valid pixel of the slice is staged
  for (int w = 0; w < kWarps; ++w) held = held && s_count[w] <= kWarpCap;
  {
    Xchg* x = &s_x[xi & 1];
    cta_partial(s_wsum, kSums, x);
    if (tid == kThreads - 1) {
      float dm = INFINITY, dc = INFINITY;
      int n = 0;
      unsigned long long kk = kNoKey;
      for (int w = 0; w < kWarps; ++w) {
        dm = fminf(dm, s_wmin[w][0]);
        dc = fminf(dc, s_wmin[w][1]);
        n += s_wn[w];
        kk = s_wkey[w] < kk ? s_wkey[w] : kk;
      }
      x->dmin[0] = dm;
      x->dmin[1] = dc;
      x->n = n;
      x->key = kk;
    }
    TF_STAMP(0, 1);
    cluster_totals(cluster, x, kSums, s_tot);
    if (tid == 0) {
      float dm = INFINITY, dc = INFINITY;
      int n = 0;
      unsigned long long kk = kNoKey;
      for (int r = 0; r < kCluster; ++r) {
        const Xchg* o = cluster.map_shared_rank(x, r);
        dm = fminf(dm, o->dmin[0]);
        dc = fminf(dc, o->dmin[1]);
        n += o->n;
        kk = o->key < kk ? o->key : kk;
      }
      L.dmin_m = dm;
      L.dmin_c = dc;
      L.go = n > 0;  // nonempty; an empty lane is not found
      L.written = 0;
      L.key = kk;
    }
    ++xi;
  }
  __syncthreads();
  TF_STAMP(0, 2);

  if (tid == 0 && L.go) {
    // the bf16 and float16 instances round the sums of head values
    // (E::keep), the float16 one their quotients too (E::op)
    const float tot = fmaxf(E::keep((float)s_tot[0]), E::tiny);
    L.l = E::op(__fdiv_rn(E::keep((float)s_tot[1]), tot));
    L.w = E::op(__fdiv_rn(E::keep((float)s_tot[2]), tot));
    L.h = E::op(__fdiv_rn(E::keep((float)s_tot[3]), tot));
    float sin_m, cos_m;
    if (p.yaw_frame == kLocal) {
      sin_m = __fdiv_rn((float)s_tot[4], tot);
      cos_m = __fdiv_rn((float)s_tot[5], tot);
      L.oriented = 1;
    } else if (p.yaw_frame == kGlobal) {  // the quotients enter the atan2 rounded
      sin_m = E::keep(__fdiv_rn(E::keep((float)s_tot[6]), tot));
      cos_m = E::keep(__fdiv_rn(E::keep((float)s_tot[7]), tot));
      L.oriented = 0;
    } else {  // the codec whose mean vector is longer
      const float sl = __fdiv_rn((float)s_tot[4], tot), cl = __fdiv_rn((float)s_tot[5], tot);
      const float sg = E::op(__fdiv_rn(E::keep((float)s_tot[6]), tot));
      const float cg_ = E::op(__fdiv_rn(E::keep((float)s_tot[7]), tot));
      const float rs = E::keep(sg), rc = E::keep(cg_);
      L.oriented = __fadd_rn(__fmul_rn(sl, sl), __fmul_rn(cl, cl)) >=
                   E::op(__fadd_rn(E::keep(__fmul_rn(rs, rs)), E::keep(__fmul_rn(rc, rc))));
      sin_m = L.oriented ? sl : sg;
      cos_m = L.oriented ? cl : cg_;
    }
    L.yaw = atan2f(sin_m, cos_m);
    if (p.yaw_frame == kGlobal) L.yaw = E::keep(L.yaw);
    if (center == kHead) {  // back to the reference's frame: Rz(-yaw) c_phys
      if (rank == 0) {
        const float c0 = __fdiv_rn((float)s_tot[8], tot), c1 = __fdiv_rn((float)s_tot[9], tot);
        const float c2 = __fdiv_rn((float)s_tot[10], tot);
        float c = cosf(-L.yaw), s = sinf(-L.yaw);
        if (p.yaw_frame == kGlobal) {  // of the head-typed yaw
          c = E::op(c);
          s = E::op(s);
        }
        out[0] = __fsub_rn(__fmul_rn(c, c0), __fmul_rn(s, c1));
        out[1] = __fadd_rn(__fmul_rn(s, c0), __fmul_rn(c, c1));
        out[2] = c2;
        out[3] = L.yaw;
        out[4] = L.l;
        out[5] = L.w;
        out[6] = L.h;
        p.found_out[id] = 1;
      }
      L.go = 0;
      L.written = 1;
    }
  }
  __syncthreads();
  TF_STAMP(0, 3);
  if (!L.go) {
    if (!L.written && rank == 0 && tid < 7) out[tid] = 0.0f;
    if (!L.written && writer) p.found_out[id] = 0;
    cluster.sync();  // no CTA leaves while another may read its buffers
    return;
  }

  // pass 2: the surface mean over m within a vehicle depth of its closest return
  float p_mean[3] = {0.0f, 0.0f, 0.0f};
  if (center == kSurface || center == kConsensus || center == kFit) {
    double sm[4] = {0.0, 0.0, 0.0, 0.0};
    const float dlim = __fadd_rn(L.dmin_m, 4.0f);
    if (held) {
      const int n = s_count[warp];
      for (int i = lane; i < n; i += 32) {
        const int e = warp * kWarpCap + i;
        const float prob = s_prob[e];
        if (!(prob >= p.min_prob) || !(s_d[e] <= dlim)) continue;
        sm[0] += prob;
        sm[1] += __fmul_rn(s_px[e], prob);
        sm[2] += __fmul_rn(s_py[e], prob);
        sm[3] += __fmul_rn(s_h[e], prob);
      }
    } else {
      for (int t = win.lo + tid; t < win.hi; t += kThreads) {
        int x, y;
        size_t q;
        window_pixel(win, t, W, x, y, q);
        if (!p.mask[q] || p.labels[q] != root) continue;
        const float d = p.image[q * p.img_channels], hh = p.image[q * p.img_channels + 1];
        if (!(d > 0.0f && hh > p.min_height)) continue;
        const float prob = E::load(y_pred, q * p.channels + 1);
        if (!(prob >= p.min_prob) || !(d <= dlim)) continue;
        sm[0] += prob;
        sm[1] += __fmul_rn(__fmul_rn(d, p.cos_t[x]), prob);
        sm[2] += __fmul_rn(__fmul_rn(-d, p.sin_t[x]), prob);
        sm[3] += __fmul_rn(hh, prob);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm[i] = warp_sum(sm[i]);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s_wsum[warp][i] = sm[i];
    }
    __syncthreads();
    Xchg* x = &s_x[xi & 1];
    cta_partial(s_wsum, 4, x);
    cluster_totals(cluster, x, 4, s_tot);
    ++xi;
    const float ws = fmaxf(E::keep((float)s_tot[0]), E::tiny);
#pragma unroll
    for (int i = 0; i < 3; ++i) p_mean[i] = __fdiv_rn((float)s_tot[1 + i], ws);
  }
  TF_STAMP(0, 4);

  const bool want_surf = center == kSurface || center == kConsensus || center == kFit;
  if (tid == 32 && want_surf) push(p_mean, L.yaw, L.l, L.w, s_surf);  // beside thread 0's work
  if (tid == 0) {
    float xyz[3] = {0.0f, 0.0f, 0.0f};
    bool bp_ok = true;
    if (want_bp) {
      const bool centroid_ok = cen_d > 0.0f && cen_h > p.min_height;
      const bool use_fallback = !centroid_ok && bl != 0 && br != 0;
      int nx = cx, ny = cy;
      float d = cen_d, hh = cen_h;
      if (use_fallback) {
        const bool fb_ok = L.key != kNoKey;
        const int idx = (int)(L.key & 0xffffffffu);
        nx = fb_ok ? idx % W : 0;
        ny = fb_ok ? idx / W : 0;
        const size_t q = win.frame + (size_t)ny * W + nx;
        d = p.image[q * p.img_channels];
        hh = p.image[q * p.img_channels + 1];
      }
      bp_ok = !(nx == 0 && ny == 0);
      if (bp_ok) {
        d = __fadd_rn(d, p.range_offset);
        xyz[0] = __fmul_rn(d, p.cos_t[nx]);
        xyz[1] = __fmul_rn(-d, p.sin_t[nx]);
        xyz[2] = hh;
      }
    }
    if (center == kConsensus || center == kFit || center == kGeometric) {
      const float raw[3] = {xyz[0], xyz[1], xyz[2]};
      push(raw, L.yaw, L.l, L.w, xyz);  // the geometric point
    }
    for (int i = 0; i < 3; ++i) L.seed[i] = xyz[i];
    L.stage = bp_ok ? (center == kFit ? 2 : 1) : 0;
  }
  __syncthreads();  // thread 32's push is done
  if (tid == 0) {
    if (center == kSurface) {
      for (int i = 0; i < 3; ++i) L.seed[i] = s_surf[i];
    } else if (center == kConsensus || center == kFit) {
      const float e0 = __fsub_rn(s_surf[0], L.seed[0]), e1 = __fsub_rn(s_surf[1], L.seed[1]);
      const float e2 = __fsub_rn(s_surf[2], L.seed[2]);
      const bool agree =
          __fadd_rn(__fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1)), __fmul_rn(e2, e2)) <= 6.25f;
      for (int i = 0; i < 3; ++i) L.seed[i] = agree ? s_surf[i] : L.seed[i];
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
  TF_STAMP(0, 5);
  if (L.stage != 2) {
    if (writer && L.stage == 1) {
      const float c = cosf(-L.yaw), s = sinf(-L.yaw);
      out[0] = __fsub_rn(__fmul_rn(c, L.seed[0]), __fmul_rn(s, L.seed[1]));
      out[1] = __fadd_rn(__fmul_rn(s, L.seed[0]), __fmul_rn(c, L.seed[1]));
      out[2] = L.seed[2];
      out[3] = L.yaw;
      out[4] = L.l;
      out[5] = L.w;
      out[6] = L.h;
      p.found_out[id] = 1;
    } else if (writer) {
      for (int i = 0; i < 7; ++i) out[i] = 0.0f;
      p.found_out[id] = 0;
    }
    cluster.sync();
    return;
  }

  // pass 3: the gated points, compacted in the stage's order (each warp's
  // region, the warps in order)
  int n_cta = 0;  // this CTA's gated points
  if (held) {
    const int n = s_count[warp];
    int g = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int e = warp * kWarpCap + i0 + lane;
      const bool in = i0 + lane < n && in_gate(L, s_px[e], s_py[e], s_h[e], s_d[e]);
      g += __popc(__ballot_sync(0xffffffffu, in));
    }
    __syncthreads();  // every warp has read s_count
    if (lane == 0) s_count[warp] = g;
    __syncthreads();
    int off = 0;
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? s_count[w] : 0;
      n_cta += s_count[w];
    }
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int e = warp * kWarpCap + i0 + lane;
      const bool in = i0 + lane < n && in_gate(L, s_px[e], s_py[e], s_h[e], s_d[e]);
      const unsigned bal = __ballot_sync(0xffffffffu, in);
      if (in) s_pts[off + __popc(bal & below)] = make_float2(s_px[e], s_py[e]);
      off += __popc(bal);
    }
  } else {
    int g = 0;
    for (int t = win.lo + tid; t < win.hi; t += kThreads) {
      float px, py;
      g += gated(p, win, L, root, t, px, py) ? 1 : 0;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) g += __shfl_xor_sync(0xffffffffu, g, o);
    __syncthreads();  // every warp has read s_count
    if (lane == 0) s_count[warp] = g;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) n_cta += s_count[w];
  }
  // the lane's points: every CTA's count and whether it staged its slice
  int n_pts = 0;
  bool all_held = true;
  Xchg* x = &s_x[xi & 1];
  if (tid == 0) {
    x->n = n_cta;
    x->held = held;
  }
  cluster.sync();
  for (int r = 0; r < kCluster; ++r) {
    const Xchg* o = cluster.map_shared_rank(x, r);
    n_pts += o->n;
    all_held = all_held && o->held;
  }
  // gathered into every CTA (the stage's room, free after pass 3), the
  // CTAs' lists by rank; past kGatherCap the fit reads the window again
  const bool gathered = all_held && n_pts <= kGatherCap;
  if (gathered) {
    int off = 0;
    for (int r = 0; r < kCluster; ++r) {
      const int n_r = cluster.map_shared_rank(x, r)->n;
      const float2* src = cluster.map_shared_rank(s_pts, r);
      for (int i = tid; i < n_r; i += kThreads) s_all[off + i] = src[i];
      off += n_r;
    }
  }
  __syncthreads();
  const float nw = fmaxf((float)n_pts, 1e-6f);
  const float lam = __fmul_rn(0.08f, nw);
  const float sx = L.seed[0], sy = L.seed[1], a = L.a, bax = L.b;
  const int boundary = L.boundary, ncand = L.ncand;
  // fn(px, py) on the points from `start` by `stride`
  auto each_point = [&](int start, int stride, auto&& fn) {
    if (gathered) {
      for (int i = start; i < n_pts; i += stride) fn(s_all[i].x, s_all[i].y);
    } else {
      for (int t = start; t < win.npx; t += stride) {
        float px, py;
        if (gated(p, win, L, root, t, px, py)) fn(px, py);
      }
    }
  };
  // one Gauss-Newton step of the centre (mx, my) from a round's sums
  auto step = [&](const double (&sum)[kFitSums], float& mx, float& my) {
    const float jxx = __fadd_rn((float)sum[0], lam), jxy = (float)sum[1];
    const float jyy = __fadd_rn((float)sum[2], lam);
    const float bx = __fadd_rn((float)sum[3], __fmul_rn(lam, __fsub_rn(mx, sx)));
    const float by = __fadd_rn((float)sum[4], __fmul_rn(lam, __fsub_rn(my, sy)));
    const float det = __fsub_rn(__fmul_rn(jxx, jyy), __fmul_rn(jxy, jxy));
    const float nx = __fsub_rn(mx, __fdiv_rn(__fsub_rn(__fmul_rn(jyy, bx), __fmul_rn(jxy, by)), det));
    const float ny = __fsub_rn(my, __fdiv_rn(__fsub_rn(__fmul_rn(jxx, by), __fmul_rn(jxy, bx)), det));
    mx = nx;
    my = ny;
  };
  TF_STAMP(0, 6);

  // the fit, with no exchange between rounds: a circle's one heading in
  // rank 0 over all its threads (a round's sums: each thread's, its warp's
  // tree, the warps in order), or the headings split over the cluster's
  // warps (heading h in rank h % kCluster), each warp's rounds its own
  if (ncand == 1) {
    if (rank == 0) {
      const float c = cosf(L.phis[0]), s = sinf(L.phis[0]);
      float mx = sx, my = sy, ress = 0.0f;  // every thread steps alike
      for (int it = 0; it <= kGnIters; ++it) {
        const bool last = it == kGnIters;
        double sum[kFitSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
        each_point(tid, kThreads, [&](float px, float py) {
          fit_terms(boundary, a, bax, c, s, px, py, mx, my, last, sum);
        });
#pragma unroll
        for (int i = 0; i < kFitSums; ++i) sum[i] = warp_sum(sum[i]);
        double (*part)[kFitSums] = s_fit[it & 1];  // the next round writes the other
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < kFitSums; ++i) part[warp][i] = sum[i];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kFitSums; ++i) {
          sum[i] = 0.0;
          for (int w = 0; w < kWarps; ++w) sum[i] += part[w][i];
        }
        if (last)
          ress = __fdiv_rn((float)sum[0], nw);
        else
          step(sum, mx, my);
      }
      if (tid == 0) {
        s_ress[0] = ress;
        s_mx[0] = mx;
        s_my[0] = my;
      }
    }
  } else {
    for (int h = rank + kCluster * warp; h < ncand; h += kCluster * kWarps) {
      const float c = cosf(L.phis[h]), s = sinf(L.phis[h]);
      float mx = sx, my = sy, ress = 0.0f;  // every lane of the warp steps alike
      for (int it = 0; it <= kGnIters; ++it) {
        const bool last = it == kGnIters;
        double sum[kFitSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
        each_point(lane, 32, [&](float px, float py) {
          fit_terms(boundary, a, bax, c, s, px, py, mx, my, last, sum);
        });
#pragma unroll
        for (int i = 0; i < kFitSums; ++i) sum[i] = warp_sum(sum[i]);
        if (last)
          ress = __fdiv_rn((float)sum[0], nw);
        else
          step(sum, mx, my);
      }
      if (lane == 0) {
        s_ress[h] = ress;
        s_mx[h] = mx;
        s_my[h] = my;
      }
    }
  }
  cluster.sync();  // every heading's result is in its CTA's arrays
  TF_STAMP(0, 7);

  if (writer) {
    float res[kMaxCands], cmx[kMaxCands], cmy[kMaxCands];
    for (int h = 0; h < ncand; ++h) {
      const int owner = h % kCluster;
      res[h] = *cluster.map_shared_rank(&s_ress[h], owner);
      cmx[h] = *cluster.map_shared_rank(&s_mx[h], owner);
      cmy[h] = *cluster.map_shared_rank(&s_my[h], owner);
    }
    const int last = ncand - 1;
    const int i = first_argmin(res, ncand);
    const bool decisive = res[i] < __fmul_rn(0.9f, res[last]);
    const float ctr[2] = {decisive ? cmx[i] : cmx[last], decisive ? cmy[i] : cmy[last]};
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
  TF_STAMP(0, 8);
  cluster.sync();  // no CTA leaves while another may read its buffers
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
                                void* found_out, void* stream, int dtype) {
  if (frames <= 0 || k <= 0) return (int)cudaGetLastError();
  if (channels < 10 || (yaw_frame == kAuto && channels < 12) || img_channels < 2 ||
      center < kBackproject || center > kFit || yaw_frame < kLocal || yaw_frame > kAuto ||
      boundary0 < kCircle || boundary0 > kBox || boundary1 < kCircle || boundary1 > kBox ||
      (long long)frames * k * kCluster > 0x7fffffffLL ||
      (long long)frames * height * width > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y_pred = y_pred;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(frames * k * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // y_pred's type by ops/decode_direct.py DTYPES' code: float32, bf16, float16
  switch (dtype) {
    case 0:
      return (int)cudaLaunchKernelEx(&cfg, decode_direct_kernel<float>, p);
    case 1:
      return (int)cudaLaunchKernelEx(&cfg, decode_direct_kernel<__nv_bfloat16>, p);
    case 2:
      return (int)cudaLaunchKernelEx(&cfg, decode_direct_kernel<__half>, p);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
