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
// GFMA at 64 full lanes, ~0.19 ms at 67 TFLOP/s; on the driven paths (a few
// hundred candidates a lane, or none) the bytes: the voting frames'
// positives map, 1 B a pixel, and 104 B a candidate.
//
// Design, two launches. The first design's three (a has-pos pass over
// channel 1 of y_pred at a 104-byte stride, on every frame: ~80 µs at 64
// frames whatever the lanes, by its phase split; a compaction of the lane's
// window and an inversion of every candidate tile in each of its CTAs; the
// winners) became:
//   lists     a CTA a frame. A frame none of whose lanes votes returns at
//             once, reading nothing of y_pred or the map. Else it reads the
//             frame's positives map (y_pred[..., 1] >= min_prob, the
//             comparison the decode's heat mask makes, as a (B, H, W) bool
//             map, 1 B a pixel; a warp's loads on 32 consecutive bytes of a
//             row, 32 rows' loads in flight a thread): each column's flag,
//             and each 32 rows' flags as a ballot OR. Then, for each voting
//             lane, it compacts the window's positive columns (C) and rows
//             (R) in order into the lane's lists, writes n_c, total, |C|,
//             |R| and zeroes the lane's done counter, and inverts each
//             candidate once (slot s at column C[s / |R|], row R[s mod |R|]:
//             the candidate set is the product C x R, in the reference's
//             column-major order, no cumsum over the frame; 4 threads a
//             candidate, 2 corners each): its corners, its sq (of the
//             corners centred on the lane's centroid) and its validity into
//             the lane's tiles of 64 (26 x 64 floats a tile,
//             coordinate-major), read by the counts and the winners
//   counts    a CTA a (lane, 64 candidates i): its own tile, then the
//             lane's tiles j in turn through shared memory, centred on the
//             centroid as they are stored (the rounded c - centroid the sq
//             took), the next tile's loads in flight while one is counted:
//             a thread takes 4 x 4
//             pairs, 24 FMAs each from two float4 reads a coordinate. Work
//             is n_c^2: a CTA whose rows lie past n_c returns at once, and
//             no (K, K) array exists. The lane's last CTA to finish (a
//             counter taken after a fence, the classic last-block pattern)
//             then finds the largest count, the winners (compacted in slot
//             order, their corners staged in shared memory), their box as a
//             float64 sum in slot order rounded once, and the pose: which CTA
//             is last changes nothing
// A lane the caller leaves out (decode_batch's stage 2) writes zeros and
// False in the counts launch's first CTA of the lane and does nothing else;
// every caller masks such a lane's outputs.
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
//     azimuth seam); any height and width the lists kernel's shared memory
//     holds (W + H / 8 bytes).
//   - Exactness around the vote: theta and phi's cos / sin come from torch
//     (`label_encode.pixel_trig`, the same ops as the plain version's), the
//     rotation entries are single rounded products as in the plain matmul
//     (its other terms add exact zeros), and y_pred is read in float32 (the
//     wrapper converts another type, as the plain version needs).

#include <cuda_runtime.h>
#include <math.h>

// Phase stamps for probes/phase_stamps.cu (nothing in the shipped build).
#ifndef TF_STAMP
#define TF_STAMP(kernel, slot)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kListThreads = 1024;  // the lists kernel's CTA
constexpr int kListWarps = kListThreads / 32;
constexpr int kTile = 64;    // candidates a tile (ops/corner_vote.py TILE)
constexpr int kCoords = 24;  // 8 corners x 3
constexpr int kRows = kCoords + 2;  // a tile's rows: 24 corner coordinates, sq, validity
constexpr int kParts = 4;    // threads a candidate when it is inverted
constexpr int kPartCoords = kCoords / kParts;
constexpr int kTileVec = kRows * kTile / 4;  // a tile's float4s
enum { kInfoNc, kInfoTotal, kInfoCols, kInfoRows, kInfoDone, kInfo };  // lane_info

struct Params {
  const float* y_pred;         // (B, H, W, channels >= 26)
  const float* image;          // (B, H, W, img_channels >= 2): distance, height
  const unsigned char* pos;    // (B, H, W) y_pred[..., 1] >= min_prob
  const long long* bbox;       // (B, n, 4) [l, t, r, b]
  const float* centroid;       // (B, n, 3)
  const unsigned char* lanes;  // (B, n) the lanes to vote, or null for all
  const float* cos_t;          // (W,) torch's cos / sin of each column's theta
  const float* sin_t;
  const float* cos_p;          // (H,) and of each row's phi
  const float* sin_p;
  int* lists;                  // (B * n, W + H) scratch: the lane's columns, then its rows
  float* tiles;                // (B * n, K / 64, kRows, 64) scratch: the inverted candidates
  int* counts;                 // (B * n, K) each real slot's count, -1 where not valid
  int* lane_info;              // (B * n, kInfo) scratch
  float* pose;                 // (B * n, 7)
  float* box;                  // (B * n, 8, 3)
  unsigned char* ok;           // (B * n,)
  unsigned char* overflow;     // (B * n,)
  int n, height, width, channels, img_channels, k, tiles_per_lane, margin_x, margin_y, words;
  float delta[3], lo, hi;
};

__device__ __forceinline__ bool votes(const Params& p, int lane_id) {
  return p.lanes == nullptr || p.lanes[lane_id] != 0;
}

// The indices x in [begin, end) with flag(x), in order, into out; returns
// their number (in every thread). Every thread of the CTA calls it.
template <int kT, typename Flag>
__device__ int compact(int begin, int end, Flag flag, int* out, int* s_warp) {
  constexpr int kW = kT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int x0 = begin; x0 < end; x0 += kT) {
    const int x = x0 + threadIdx.x;
    const bool f = x < end && flag(x);
    const unsigned int m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int off = base, all = 0;
    for (int w = 0; w < kW; ++w) {
      off += w < warp ? s_warp[w] : 0;
      all += s_warp[w];
    }
    if (f) out[off + __popc(m & ((1u << lane) - 1u))] = x;
    base += all;
    __syncthreads();
  }
  return base;
}

// Part `part` (corners 2 part and 2 part + 1) of candidate slot s of the
// lane, by 4 consecutive lanes of a warp (every lane of the warp calls
// it): its corners, its sq (of the coordinates centred on the lane's
// centroid, c - centroid) and its validity (near test, and a real slot)
// into the lane's tile of p.tiles. A slot past n_c is zeros and not
// valid.
__device__ void invert(const Params& p, int b, int lane_id, int s, int part, int n_c,
                       const int* cols, const int* rows, int n_rows) {
  const float* c3 = p.centroid + (size_t)lane_id * 3;
  float sel[kPartCoords];
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
        sq = __fmaf_rn(v, v, sq);
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < kPartCoords; ++m) sel[m] = 0.0f;
  }
  int v = near;
  v &= __shfl_xor_sync(0xffffffffu, v, 1);
  v &= __shfl_xor_sync(0xffffffffu, v, 2);
  sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 1));
  sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, 2));
  float* tile = p.tiles + ((size_t)lane_id * p.tiles_per_lane + s / kTile) * kRows * kTile;
  const int c = s % kTile;
#pragma unroll
  for (int m = 0; m < kPartCoords; ++m) tile[(kPartCoords * part + m) * kTile + c] = sel[m];
  if (part == 0) {
    tile[kCoords * kTile + c] = sq;
    tile[(kCoords + 1) * kTile + c] = v ? 1.0f : 0.0f;
  }
}

// A frame's positive columns and rows, and each voting lane's lists and
// inverted candidates.
__global__ void __launch_bounds__(kListThreads) lists_kernel(Params p) {
  extern __shared__ unsigned int s_dyn[];  // the row words, then a byte a column
  __shared__ int s_any;
  __shared__ int s_warp[kListWarps];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  TF_STAMP(0, 0);
  if (tid == 0) s_any = 0;
  __syncthreads();
  if (tid < p.n && votes(p, b * p.n + tid)) s_any = 1;
  __syncthreads();
  if (!s_any) return;  // a frame with no voting lane reads nothing
  unsigned int* s_row = s_dyn;
  unsigned char* s_col = reinterpret_cast<unsigned char*>(s_dyn + p.words);
  for (int g = tid; g < p.words; g += kListThreads) s_row[g] = 0;
  __syncthreads();
  const unsigned char* pos = p.pos + (size_t)b * p.height * p.width;
  for (int c0 = 0; c0 < p.width; c0 += kListThreads) {
    const int c = c0 + tid;
    const bool in = c < p.width;
    const unsigned char* col = pos + (in ? c : 0);
    unsigned int any = 0;
    for (int g = 0; g < p.words; ++g) {
      // 32 rows' loads issued together (a row past the frame reads its last)
      unsigned char v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = col[(size_t)min(g * 32 + i, p.height - 1) * p.width];
      unsigned int bits = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) bits |= (v[i] && g * 32 + i < p.height) ? 1u << i : 0u;
      bits = in ? bits : 0u;
      any |= bits;
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (lane == 0 && bits) atomicOr(&s_row[g], bits);
    }
    if (in) s_col[c] = any != 0;
  }
  __syncthreads();
  TF_STAMP(0, 1);
  for (int j = 0; j < p.n; ++j) {
    const int lane_id = b * p.n + j;
    if (!votes(p, lane_id)) continue;
    // the window, clamped to the frame: cols [l - mx, r + mx), rows [t - my, b + my)
    const long long* bb = p.bbox + (size_t)lane_id * 4;
    const long long wd = p.width, ht = p.height;
    const int c0 = (int)min(max(bb[0] - p.margin_x, 0LL), wd);
    const int c1 = (int)min(max(bb[2] + p.margin_x, 0LL), wd);
    const int r0 = (int)min(max(bb[1] - p.margin_y, 0LL), ht);
    const int r1 = (int)min(max(bb[3] + p.margin_y, 0LL), ht);
    int* list = p.lists + (size_t)lane_id * (p.width + p.height);
    const int n_cols = compact<kListThreads>(c0, c1, [&](int c) { return s_col[c] != 0; }, list,
                                             s_warp);
    const int n_rows = compact<kListThreads>(r0, r1, [&](int r) {
      return ((s_row[r >> 5] >> (r & 31)) & 1u) != 0;
    }, list + p.width, s_warp);
    const int total = n_cols * n_rows;
    const int n_c = min(total, p.k);
    if (tid == 0) {
      int* info = p.lane_info + (size_t)lane_id * kInfo;
      info[kInfoNc] = n_c;
      info[kInfoTotal] = total;
      info[kInfoCols] = n_cols;
      info[kInfoRows] = n_rows;
      info[kInfoDone] = 0;
    }
    // every candidate inverted once, a tile's padding included
    const int tasks = (n_c + kTile - 1) / kTile * kTile * kParts;
    for (int e = tid; e < tasks; e += kListThreads)
      invert(p, b, lane_id, e / kParts, e % kParts, n_c, list, list + p.width, n_rows);
  }
  TF_STAMP(0, 2);
}

__device__ __forceinline__ void load_tile(const float4* src, float4 (&r)[2]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = threadIdx.x + u * kThreads;
    r[u] = e < kTileVec ? __ldcg(src + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// A tile into shared memory, its corners centred on the lane's centroid
// c3 (c - centroid, the same rounded difference the inversion's sq took)
__device__ __forceinline__ void store_tile(float4* dst, const float4 (&r)[2], const float* c3) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = threadIdx.x + u * kThreads;
    if (e >= kTileVec) continue;
    const int row = e / (kTile / 4);
    float4 v = r[u];
    if (row < kCoords) {
      const float c = c3[row % 3];
      v = make_float4(__fsub_rn(v.x, c), __fsub_rn(v.y, c), __fsub_rn(v.z, c), __fsub_rn(v.w, c));
    }
    dst[e] = v;
  }
}

// The lane's winners, box and pose from every CTA's counts and the
// corners in the lane's tiles (the counts read through L2: other CTAs
// wrote them in this launch). Every thread of the CTA calls it.
__device__ void winners(const Params& p, int lane_id, int n_c, int total, int* s_top,
                        int* s_warp, int* s_win, float* s_wc, double* s_box) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pose = p.pose + (size_t)lane_id * 7;
  float* box = p.box + (size_t)lane_id * kCoords;
  const int* counts = p.counts + (size_t)lane_id * p.k;
  int top = -1;
  for (int s = threadIdx.x; s < n_c; s += kThreads) top = max(top, __ldcg(counts + s));
  top = __reduce_max_sync(0xffffffffu, top);
  if (lane == 0) s_top[warp] = top;
  __syncthreads();
  top = -1;
  for (int w = 0; w < kWarps; ++w) top = max(top, s_top[w]);
  if (top < 0) {  // no valid candidate: zeros, not ok
    if (threadIdx.x < 7) pose[threadIdx.x] = 0.0f;
    if (threadIdx.x < kCoords) box[threadIdx.x] = 0.0f;
    if (threadIdx.x == 0) {
      p.ok[lane_id] = 0;
      p.overflow[lane_id] = total > p.k;
    }
    return;
  }
  // the winners' corners, a float64 sum in slot order, a coordinate a
  // thread: each chunk of slots' winners compacted, their corners staged
  // in shared memory kTile at a time
  const float* tiles = p.tiles + (size_t)lane_id * p.tiles_per_lane * kRows * kTile;
  double acc = 0.0;
  int n_win = 0;
  for (int s0 = 0; s0 < n_c; s0 += kThreads) {
    const int m = compact<kThreads>(s0, min(s0 + kThreads, n_c), [&](int s) {
      return __ldcg(counts + s) == top;
    }, s_win, s_warp);
    for (int w0 = 0; w0 < m; w0 += kTile) {
      const int nb = min(kTile, m - w0);
      for (int e = threadIdx.x; e < nb * kCoords; e += kThreads) {
        const int s = s_win[w0 + e / kCoords], q = e % kCoords;
        s_wc[e] = tiles[((size_t)(s / kTile) * kRows + q) * kTile + s % kTile];
      }
      __syncthreads();
      if (threadIdx.x < kCoords)
        for (int i = 0; i < nb; ++i) acc += (double)s_wc[i * kCoords + threadIdx.x];
      __syncthreads();
    }
    n_win += m;
  }
  if (threadIdx.x < kCoords) s_box[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float wins = (float)n_win;
  float bx[8][3];
  for (int q = 0; q < kCoords; ++q) {
    bx[q / 3][q % 3] = __fdiv_rn(__double2float_rn(s_box[q]), wins);
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
  p.overflow[lane_id] = total > p.k;
}

__global__ void __launch_bounds__(kThreads, 3) counts_kernel(Params p) {
  __shared__ __align__(16) float s_ti[kRows][kTile];  // this CTA's candidates i
  __shared__ __align__(16) float s_tj[kRows][kTile];  // the tile j being counted
  __shared__ int s_top[kWarps], s_warp[kWarps], s_win[kThreads];
  __shared__ double s_box[kCoords];
  __shared__ int s_last;
  const int lane_id = blockIdx.x;
  TF_STAMP(1, 0);
  if (!votes(p, lane_id)) {  // zeros and False, once a lane
    if (blockIdx.y == 0) {
      if (threadIdx.x < 7) p.pose[(size_t)lane_id * 7 + threadIdx.x] = 0.0f;
      if (threadIdx.x < kCoords) p.box[(size_t)lane_id * kCoords + threadIdx.x] = 0.0f;
      if (threadIdx.x == 0) p.ok[lane_id] = p.overflow[lane_id] = 0;
    }
    return;
  }
  const int* info = p.lane_info + (size_t)lane_id * kInfo;
  const int n_c = info[kInfoNc], total = info[kInfoTotal];
  const int i0 = blockIdx.y * kTile;
  TF_STAMP(1, 1);
  if (n_c == 0) {  // no candidate: the first CTA writes the empty vote
    if (blockIdx.y == 0)
      winners(p, lane_id, 0, total, s_top, s_warp, s_win, &s_tj[0][0], s_box);
    return;
  }
  if (i0 >= n_c) return;
  const float4* tiles =
      reinterpret_cast<const float4*>(p.tiles + (size_t)lane_id * p.tiles_per_lane * kRows * kTile);
  const float* c3 = p.centroid + (size_t)lane_id * 3;
  const float cen[3] = {c3[0], c3[1], c3[2]};
  float4 next[2];
  load_tile(tiles + (size_t)blockIdx.y * kTileVec, next);
  store_tile(reinterpret_cast<float4*>(&s_ti[0][0]), next, cen);
  load_tile(tiles, next);
  __syncthreads();
  TF_STAMP(1, 2);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float sqi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sqi[i] = s_ti[kCoords][4 * ty + i];
  int cnt[4] = {0, 0, 0, 0};
  const int n_tiles = (n_c + kTile - 1) / kTile;
  for (int jt = 0; jt < n_tiles; ++jt) {
    store_tile(reinterpret_cast<float4*>(&s_tj[0][0]), next, cen);
    __syncthreads();
    if (jt + 1 < n_tiles) load_tile(tiles + (size_t)(jt + 1) * kTileVec, next);  // in flight
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int q = 0; q < kCoords; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(&s_ti[q][4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&s_tj[q][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], cv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sqj = s_tj[kCoords][4 * tx + j];
      const bool vj = s_tj[kCoords + 1][4 * tx + j] != 0.0f;
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
  TF_STAMP(1, 3);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o; o >>= 1) cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], o);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = i0 + 4 * ty + i;
      if (gi < n_c) p.counts[(size_t)lane_id * p.k + gi] = s_ti[kCoords + 1][4 * ty + i] != 0.0f
                                                              ? cnt[i] : -1;
    }
  }
  // the lane's last CTA to finish votes: every thread's counts are visible
  // to the card before the CTA takes its ticket
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(p.lane_info + (size_t)lane_id * kInfo + kInfoDone, 1) == n_tiles - 1;
  __syncthreads();
  TF_STAMP(1, 4);
  if (!s_last) return;
  __threadfence();
  winners(p, lane_id, n_c, total, s_top, s_warp, s_win, &s_tj[0][0], s_box);
  TF_STAMP(1, 5);
}

// The kernels the C entry has launched since the library was loaded (a
// host-side count: `ops/corner_vote.py::kernel_launches`).
unsigned long long g_kernels = 0;

}  // namespace

extern "C" int tf_corner_vote(const void* y_pred, int channels, const void* image,
                              int img_channels, const void* positives, const void* bbox,
                              const void* centroid, const void* lanes, const void* cos_t,
                              const void* sin_t, const void* cos_p, const void* sin_p, int frames,
                              int n, int height, int width, int k, int margin_x, int margin_y,
                              const float* consts, void* lists, void* tiles, void* counts,
                              void* lane_info, void* pose, void* box, void* ok, void* overflow,
                              void* stream) {
  if (frames <= 0 || n <= 0) return (int)cudaGetLastError();
  const int blocks = (k + kTile - 1) / kTile;
  if (channels < 2 + kCoords || img_channels < 2 || height <= 0 || width <= 0 || k <= 0 ||
      n > kListThreads || blocks > 65535 || (long long)frames * n > 0x7fffffffLL ||
      (long long)frames * height * width * channels > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y_pred = (const float*)y_pred;
  p.image = (const float*)image;
  p.pos = (const unsigned char*)positives;
  p.bbox = (const long long*)bbox;
  p.centroid = (const float*)centroid;
  p.lanes = (const unsigned char*)lanes;
  p.cos_t = (const float*)cos_t;
  p.sin_t = (const float*)sin_t;
  p.cos_p = (const float*)cos_p;
  p.sin_p = (const float*)sin_p;
  p.lists = (int*)lists;
  p.tiles = (float*)tiles;
  p.counts = (int*)counts;
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
  p.tiles_per_lane = blocks;
  p.margin_x = margin_x;
  p.margin_y = margin_y;
  p.words = (height + 31) / 32;
  p.delta[0] = consts[0];
  p.delta[1] = consts[1];
  p.delta[2] = consts[2];
  p.lo = consts[3];
  p.hi = consts[4];
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = (int)sizeof(unsigned int) * p.words + width;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  lists_kernel<<<frames, kListThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++g_kernels;
  counts_kernel<<<dim3(frames * n, blocks), kThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_kernels;
  return (int)err;
}

extern "C" unsigned long long tf_corner_vote_kernels() { return g_kernels; }
