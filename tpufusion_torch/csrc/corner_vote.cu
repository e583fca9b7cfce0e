// The corner head's vote for Hopper (sm_90a): for every (frame, lane), what
// corner_vote_reference (tpufusion_torch/decode/decode.py) computes: the
// candidate pixels in the lane's bbox +- margins whose row and column hold
// a positive anywhere in the frame, up to K = max_candidates of them in the
// reference's column-major scan order; each candidate's 8 corners
// c = Rz(theta) Ry(phi) c' + p and its near test against the lane's 3D
// centroid; each valid candidate's count of valid neighbours within
// max_bbox_dist in the Gram form; the winners (the valid candidates with
// the largest count), their mean box and the pose from its corner geometry.
//
// Ports no TPU kernel. The JAX package computes the vote in XLA, outside
// Pallas (tpufusion/decode/decode.py::corner_vote, vmapped by decode_frame,
// decode_frame_multi, decode_batch and decode_batch_multi). It replaces the
// port's composition, which builds several (B, n, K, K) float32 tensors
// (1.07 GB each at B = 64, n = 1, K = 2048: the Gram product, sq_i + sq_j,
// d2, the pair masks) and a cumsum and scatter over (B, n, H * W), and
// spends K^2 on every lane however few candidates it has.
//
// What bounds it on the H100: the FP32 FMAs of the Gram products, 24 a pair
// over n_c^2 pairs a lane (n_c = min(total, K), its real candidates): 6.4
// GFMA at 64 full lanes, ~0.19 ms at 67 TFLOP/s, far above the bytes (the
// frames' positive channel, 4 B a pixel, and 104 B a candidate).
//
// Design, three launches:
//   has_pos   a CTA a (frame, 256 columns): each thread walks its column's
//             rows; the column's flag, and each 32 rows' flags as a ballot
//             OR over the CTA (row_bits, one word a chunk of columns)
//   counts    a CTA a (lane, 64 candidates i). It compacts the lane's
//             window columns with a positive (C) and rows with a positive
//             (R) in order into shared memory, so slot s is column
//             C[s / |R|], row R[s mod |R|] (the candidate set is the
//             product C x R: O(W + H), no cumsum over the frame); it inverts
//             its own 64 candidates into shared memory (4 threads a
//             candidate, 2 corners each), writes their corners for the
//             winners, then walks the lane's candidates j in tiles of 64,
//             inverting each tile into shared memory, and counts: a thread
//             takes 4 x 4 pairs, 24 FMAs each from two float4 reads a
//             coordinate. Work is n_c^2: a CTA whose rows lie past n_c
//             returns at once, and no (K, K) array exists
//   winners   a CTA a lane: the largest count, the winners, their box as a
//             float64 sum in a fixed order rounded once, and the pose
// A lane the caller leaves out (decode_batch's stage 2) writes zeros and
// False in the winners kernel and does nothing in the others; every caller
// masks such a lane's outputs.
//
// Where the two versions can part, and what meets it:
//   - Pairs near the thresholds. Each float32 op is the plain version's,
//     round to nearest (__fmul_rn and friends), except the orders of the
//     three sums the plain version leaves to cuBLAS or torch's reductions:
//     the corners' 3-term rotation, sq and the Gram product (here FMA
//     chains in coordinate order). With ~4 M pairs a lane some pair sits
//     within rounding of 25.0 (or of 1e-9: near-duplicate candidates, whose
//     d2 is rounding noise in both), so single counts may differ by 1. The
//     plain version reports, per candidate, its pairs within a relative
//     1e-5 of a threshold, and its near tests and atan2 branches within
//     rounding (its `readings`); the contract (_golden.corner_kernel_
//     readings) holds the winner sets equal and pose and box within 1e-4 on
//     the lanes no such flip can change, and counts the others.
//   - TF32. The counts run on the CUDA cores in FP32 FMAs; no tensor core
//     touches them.
//   - Overflow. Slots past K are never made: the product's first K in scan
//     order, at any K (64 or 2048), overflow = |C| |R| > K.
//   - Windows clipped at column 0 or W - 1, row 0 or H - 1: the window is
//     clamped to the frame, as the reference masks an iota (no wrap at the
//     azimuth seam); any height and width the shared lists hold.
//   - Exactness around the vote: theta and phi's cos / sin come from torch
//     (`label_encode.pixel_trig`, the same ops as the plain version's), the
//     rotation entries are single rounded products as in the plain matmul
//     (its other terms add exact zeros), and y_pred is read in float32 (the
//     wrapper converts another type, as the plain version needs).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;    // candidates a tile (ops/corner_vote.py TILE)
constexpr int kCoords = 24;  // 8 corners x 3
constexpr int kParts = 4;    // threads a candidate when a tile is inverted
constexpr int kPartCoords = kCoords / kParts;

struct Params {
  const float* y_pred;      // (B, H, W, channels >= 26)
  const float* image;       // (B, H, W, img_channels >= 2): distance, height
  const long long* bbox;    // (B, n, 4) [l, t, r, b]
  const float* centroid;    // (B, n, 3)
  const unsigned char* lanes;  // (B, n) the lanes to vote
  const float* cos_t;       // (W,) torch's cos / sin of each column's theta
  const float* sin_t;
  const float* cos_p;       // (H,) and of each row's phi
  const float* sin_p;
  unsigned char* col_has;   // (B, W) scratch
  unsigned int* row_bits;   // (B, chunks, words) scratch
  int* counts;              // (B * n, K) each real slot's count, -1 where not valid
  float* corners;           // (B * n, K, 24) each real slot's corners
  int* lane_info;           // (B * n, 2) scratch: n_c, total
  float* pose;              // (B * n, 7)
  float* box;               // (B * n, 8, 3)
  unsigned char* ok;        // (B * n,)
  unsigned char* overflow;  // (B * n,)
  int n, height, width, channels, img_channels, k, margin_x, margin_y, chunks, words;
  float min_prob, delta[3], lo, hi;
};

// The frame's rows and columns with a positive (y_pred[..., 1] >= min_prob).
__global__ void __launch_bounds__(kThreads) has_pos_kernel(Params p) {
  __shared__ unsigned int s_bits[kWarps];
  const int b = blockIdx.y, c = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in = c < p.width;
  const size_t row_stride = (size_t)p.width * p.channels;
  const float* y = p.y_pred + ((size_t)b * p.height * p.width + (in ? c : 0)) * p.channels + 1;
  bool col = false;
  for (int g = 0; g < p.words; ++g) {
    unsigned int bits = 0;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const int r = g * 32 + i;
      if (in && r < p.height && y[r * row_stride] >= p.min_prob) bits |= 1u << i;
    }
    col |= bits != 0;
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0) s_bits[warp] = bits;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned int all = 0;
      for (int w = 0; w < kWarps; ++w) all |= s_bits[w];
      p.row_bits[((size_t)b * p.chunks + blockIdx.x) * p.words + g] = all;
    }
    __syncthreads();
  }
  if (in) p.col_has[(size_t)b * p.width + c] = col;
}

// The indices x in [begin, end) with flag(x), in order, into out; returns
// their number (in every thread).
template <typename Flag>
__device__ int compact(int begin, int end, Flag flag, int* out, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int x0 = begin; x0 < end; x0 += kThreads) {
    const int x = x0 + threadIdx.x;
    const bool f = x < end && flag(x);
    const unsigned int m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int off = base, all = 0;
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? s_warp[w] : 0;
      all += s_warp[w];
    }
    if (f) out[off + __popc(m & ((1u << lane) - 1u))] = x;
    base += all;
    __syncthreads();
  }
  return base;
}

// Candidates s0 .. s0 + kTile - 1 of the lane: thread t takes corners
// 2 (t % 4) and 2 (t % 4) + 1 of candidate t / 4 (4 consecutive lanes a
// candidate). Writes each candidate's centred coordinates (c - centroid)
// into cen[coordinate][candidate], its sq and validity (near test, and a
// real slot); where `keep` is set, also the real slots' corners into
// p.corners. A slot past n_c is zeros and not valid.
__device__ void invert_tile(const Params& p, int b, int lane_id, int s0, int n_c,
                            const int* cols, const int* rows, int n_rows,
                            float (*cen)[kTile], float* sq_out, int* valid_out, bool keep) {
  const int cand = threadIdx.x / kParts, part = threadIdx.x % kParts, s = s0 + cand;
  const float* c3 = p.centroid + (size_t)lane_id * 3;
  float x[kPartCoords], sel[kPartCoords];
  float sq = 0.0f;
  bool near = s < n_c;
  if (s < n_c) {
    const int col = cols[s / n_rows], row = rows[s % n_rows];
    const size_t pix = ((size_t)b * p.height + row) * p.width + col;
    const float* reg = p.y_pred + pix * p.channels + 2 + kPartCoords * part;
    const float* im = p.image + pix * p.img_channels;
    const float d = im[0], hgt = im[1];
    const float ct = p.cos_t[col], st = p.sin_t[col], cp = p.cos_p[row], sp = p.sin_p[row];
    // Rz(theta) Ry(phi): each entry one rounded product (the plain matmul's
    // other terms add exact zeros)
    const float r[3][3] = {{__fmul_rn(ct, cp), -st, __fmul_rn(ct, sp)},
                           {__fmul_rn(st, cp), ct, __fmul_rn(st, sp)},
                           {-sp, 0.0f, cp}};
    const float p3[3] = {__fmul_rn(d, ct), -__fmul_rn(d, st), hgt};
    const float cen3[3] = {c3[0], c3[1], c3[2]};
#pragma unroll
    for (int q = 0; q < kPartCoords / 3; ++q) {
      const float r0 = reg[3 * q], r1 = reg[3 * q + 1], r2 = reg[3 * q + 2];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float acc = __fmul_rn(r0, r[i][0]);
        acc = __fmaf_rn(r1, r[i][1], acc);
        acc = __fmaf_rn(r2, r[i][2], acc);
        const float c = __fadd_rn(acc, p3[i]);
        const float v = __fsub_rn(c, cen3[i]);
        near = near && fabsf(v) <= p.delta[i];
        sel[3 * q + i] = c;
        x[3 * q + i] = v;
        sq = __fmaf_rn(v, v, sq);
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < kPartCoords; ++m) x[m] = sel[m] = 0.0f;
  }
  int v = near;
  v &= __shfl_xor_sync(0xffffffffu, v, 1);
  v &= __shfl_xor_sync(0xffffffffu, v, 2);
  sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 1));
  sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 2));
#pragma unroll
  for (int m = 0; m < kPartCoords; ++m) cen[kPartCoords * part + m][cand] = x[m];
  if (part == 0) {
    sq_out[cand] = sq;
    valid_out[cand] = v;
  }
  if (keep && s < n_c) {
    float* out = p.corners + ((size_t)lane_id * p.k + s) * kCoords + kPartCoords * part;
#pragma unroll
    for (int m = 0; m < kPartCoords; ++m) out[m] = sel[m];
  }
}

__global__ void __launch_bounds__(kThreads, 3) counts_kernel(Params p) {
  extern __shared__ int s_list[];  // the lane's columns (up to W), then its rows
  __shared__ __align__(16) float s_ci[kCoords][kTile];
  __shared__ __align__(16) float s_cj[kCoords][kTile];
  __shared__ float s_sqi[kTile], s_sqj[kTile];
  __shared__ int s_vi[kTile], s_vj[kTile];
  __shared__ int s_warp[kWarps];
  const int lane_id = blockIdx.x;
  if (!p.lanes[lane_id]) return;
  const int b = lane_id / p.n;
  int* s_cols = s_list;
  int* s_rows = s_list + p.width;
  const long long* bb = p.bbox + (size_t)lane_id * 4;
  // the window, clamped to the frame: cols [l - mx, r + mx), rows [t - my, b + my)
  const long long wd = p.width, ht = p.height;
  const int c0 = (int)min(max(bb[0] - p.margin_x, 0LL), wd);
  const int c1 = (int)min(max(bb[2] + p.margin_x, 0LL), wd);
  const int r0 = (int)min(max(bb[1] - p.margin_y, 0LL), ht);
  const int r1 = (int)min(max(bb[3] + p.margin_y, 0LL), ht);
  const unsigned char* col_has = p.col_has + (size_t)b * p.width;
  const unsigned int* bits = p.row_bits + (size_t)b * p.chunks * p.words;
  const int n_cols = compact(c0, c1, [&](int c) { return col_has[c] != 0; }, s_cols, s_warp);
  const int n_rows = compact(r0, r1, [&](int r) {
    unsigned int any = 0;
    for (int ch = 0; ch < p.chunks; ++ch) any |= bits[ch * p.words + (r >> 5)];
    return ((any >> (r & 31)) & 1u) != 0;
  }, s_rows, s_warp);
  const int total = n_cols * n_rows;
  const int n_c = min(total, p.k);
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    p.lane_info[2 * lane_id] = n_c;
    p.lane_info[2 * lane_id + 1] = total;
  }
  const int i0 = blockIdx.y * kTile;
  if (i0 >= n_c) return;

  invert_tile(p, b, lane_id, i0, n_c, s_cols, s_rows, n_rows, s_ci, s_sqi, s_vi, true);
  __syncthreads();
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float sqi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sqi[i] = s_sqi[4 * ty + i];
  int cnt[4] = {0, 0, 0, 0};
  const int n_tiles = (n_c + kTile - 1) / kTile;
  for (int jt = 0; jt < n_tiles; ++jt) {
    invert_tile(p, b, lane_id, jt * kTile, n_c, s_cols, s_rows, n_rows, s_cj, s_sqj, s_vj,
                false);
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int q = 0; q < kCoords; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(&s_ci[q][4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&s_cj[q][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], cv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sqj = s_sqj[4 * tx + j];
      const bool vj = s_vj[4 * tx + j] != 0;
      const int gj = jt * kTile + 4 * tx + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // d2 = max(sq_i + sq_j - 2 g, 0), 0 on the diagonal, as the plain version
        float d2 = __fsub_rn(__fadd_rn(sqi[i], sqj), __fmul_rn(2.0f, acc[i][j]));
        d2 = (i0 + 4 * ty + i == gj) ? 0.0f : fmaxf(d2, 0.0f);
        cnt[i] += (vj && d2 > p.lo && d2 < p.hi) ? 1 : 0;
      }
    }
    __syncthreads();  // the tile is read before the next one overwrites it
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o; o >>= 1) cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], o);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = i0 + 4 * ty + i;
      if (gi < n_c) p.counts[(size_t)lane_id * p.k + gi] = s_vi[4 * ty + i] ? cnt[i] : -1;
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // the same value in every lane: each step adds a pair both ways
}

__global__ void __launch_bounds__(kThreads) winners_kernel(Params p) {
  __shared__ int s_top[kWarps];
  __shared__ double s_sum[kWarps][kCoords + 1];
  const int lane_id = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pose = p.pose + (size_t)lane_id * 7;
  float* box = p.box + (size_t)lane_id * kCoords;
  const bool voted = p.lanes[lane_id] != 0;
  const int n_c = voted ? p.lane_info[2 * lane_id] : 0;
  const int* counts = p.counts + (size_t)lane_id * p.k;
  int top = -1;
  for (int s = threadIdx.x; s < n_c; s += kThreads) top = max(top, counts[s]);
  top = __reduce_max_sync(0xffffffffu, top);
  if (lane == 0) s_top[warp] = top;
  __syncthreads();
  top = -1;
  for (int w = 0; w < kWarps; ++w) top = max(top, s_top[w]);
  if (top < 0) {  // no valid candidate, or a lane left out: zeros, not ok
    if (threadIdx.x < 7) pose[threadIdx.x] = 0.0f;
    if (threadIdx.x < kCoords) box[threadIdx.x] = 0.0f;
    if (threadIdx.x == 0) {
      p.ok[lane_id] = 0;
      p.overflow[lane_id] = voted && p.lane_info[2 * lane_id + 1] > p.k;
    }
    return;
  }
  // the winners' corners, a float64 sum in a fixed order: each thread's
  // slots in turn, the warp's tree, the warps in order
  double acc[kCoords];
#pragma unroll
  for (int q = 0; q < kCoords; ++q) acc[q] = 0.0;
  double wins = 0.0;
  for (int s = threadIdx.x; s < n_c; s += kThreads) {
    if (counts[s] != top) continue;
    const float* c = p.corners + ((size_t)lane_id * p.k + s) * kCoords;
    wins += 1.0;
#pragma unroll
    for (int q = 0; q < kCoords; ++q) acc[q] += (double)c[q];
  }
#pragma unroll
  for (int q = 0; q < kCoords; ++q) acc[q] = warp_sum(acc[q]);
  wins = warp_sum(wins);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kCoords; ++q) s_sum[warp][q] = acc[q];
    s_sum[warp][kCoords] = wins;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  double sum[kCoords + 1];
  for (int q = 0; q <= kCoords; ++q) {
    sum[q] = 0.0;
    for (int w = 0; w < kWarps; ++w) sum[q] += s_sum[w][q];
  }
  const float n_win = (float)sum[kCoords];
  float bx[8][3];
  for (int q = 0; q < kCoords; ++q) {
    bx[q / 3][q % 3] = __fdiv_rn(__double2float_rn(sum[q]), n_win);
    box[q] = bx[q / 3][q % 3];
  }
  // the pose from the box's corner geometry, the plain version's ops
  float yaw = 0.0f, len = 0.0f, wid = 0.0f, hgt = 0.0f, mean[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 4; ++i) {
    const float dx = __fsub_rn(bx[i][0], bx[i + 4][0]), dy = __fsub_rn(bx[i][1], bx[i + 4][1]);
    const float y = atan2f(dy, dx), cy = cosf(y);
    const bool big = fabsf(cy) > 1e-12f;
    const float safe = big ? cy : 1.0f;
    const float l = big ? __fdiv_rn(dx, safe) : dy;
    const float dx2 = __fsub_rn(bx[i][0], bx[i + 2][0]), dy2 = __fsub_rn(bx[i][1], bx[i + 2][1]);
    const float w = big ? __fdiv_rn(dy2, safe) : dx2;
    yaw = __fadd_rn(yaw, y);
    len = __fadd_rn(len, fabsf(l));
    wid = __fadd_rn(wid, fabsf(w));
    hgt = __fadd_rn(hgt, fabsf(__fsub_rn(bx[i][2], bx[i + 1][2])));
  }
  for (int c = 0; c < 8; ++c)
    for (int i = 0; i < 3; ++i) mean[i] = __fadd_rn(mean[i], bx[c][i]);
  for (int i = 0; i < 3; ++i) pose[i] = __fdiv_rn(mean[i], 8.0f);
  pose[3] = __fdiv_rn(yaw, 4.0f);
  pose[4] = __fdiv_rn(len, 4.0f);
  pose[5] = __fdiv_rn(wid, 4.0f);
  pose[6] = __fdiv_rn(hgt, 4.0f);
  p.ok[lane_id] = 1;
  p.overflow[lane_id] = p.lane_info[2 * lane_id + 1] > p.k;
}

}  // namespace

extern "C" int tf_corner_vote(const void* y_pred, int channels, const void* image,
                              int img_channels, const void* bbox, const void* centroid,
                              const void* lanes, const void* cos_t, const void* sin_t,
                              const void* cos_p, const void* sin_p, int frames, int n,
                              int height, int width, int k, int margin_x, int margin_y,
                              const float* consts, void* col_has, void* row_bits, void* counts,
                              void* corners, void* lane_info, void* pose, void* box, void* ok,
                              void* overflow, void* stream) {
  if (frames <= 0 || n <= 0) return (int)cudaGetLastError();
  if (channels < 2 + kCoords || img_channels < 2 || height <= 0 || width <= 0 || k <= 0 ||
      frames > 65535 || (long long)frames * n > 0x7fffffffLL ||
      (long long)frames * height * width * channels > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y_pred = (const float*)y_pred;
  p.image = (const float*)image;
  p.bbox = (const long long*)bbox;
  p.centroid = (const float*)centroid;
  p.lanes = (const unsigned char*)lanes;
  p.cos_t = (const float*)cos_t;
  p.sin_t = (const float*)sin_t;
  p.cos_p = (const float*)cos_p;
  p.sin_p = (const float*)sin_p;
  p.col_has = (unsigned char*)col_has;
  p.row_bits = (unsigned int*)row_bits;
  p.counts = (int*)counts;
  p.corners = (float*)corners;
  p.lane_info = (int*)lane_info;
  p.pose = (float*)pose;
  p.box = (float*)box;
  p.ok = (unsigned char*)ok;
  p.overflow = (unsigned char*)overflow;
  p.n = n;
  p.height = height;
  p.width = width;
  p.channels = channels;
  p.img_channels = img_channels;
  p.k = k;
  p.margin_x = margin_x;
  p.margin_y = margin_y;
  p.chunks = (width + kThreads - 1) / kThreads;
  p.words = (height + 31) / 32;
  p.min_prob = consts[0];
  p.delta[0] = consts[1];
  p.delta[1] = consts[2];
  p.delta[2] = consts[3];
  p.lo = consts[4];
  p.hi = consts[5];
  const cudaStream_t s = (cudaStream_t)stream;
  has_pos_kernel<<<dim3(p.chunks, frames), kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int lists = (int)sizeof(int) * (width + height);
  if (lists > 32 * 1024) {
    err = cudaFuncSetAttribute(counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lists);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (k + kTile - 1) / kTile;
  counts_kernel<<<dim3(frames * n, blocks), kThreads, lists, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  winners_kernel<<<frames * n, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
