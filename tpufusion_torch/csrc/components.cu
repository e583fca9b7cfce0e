// 4-connected component labels with per-component bbox extents, for Hopper
// (sm_90a): block-based union-find on full-height column strips.
//
// Replaces the TPU kernel `propagate_pallas` / `_propagate_kernel`
// (tpufusion/ops/pallas_cc.py), which keeps one frame's (5, 32, 1801) int32
// state (-flat_id, -col, col, -row, row) resident in VMEM and runs gated
// multi-distance max-shift sweeps to a fixed point. Contract (as
// tpufusion/ops/components.py connected_components_with_bbox): each
// foreground pixel's label is the smallest flat index (within its frame) of
// its 4-connected component, with no wrap across column 0 / W-1, plus the
// component's min/max column and row; background gets label -1 and the
// extents (BIG, -BIG, BIG, -BIG).
//
// What bounds it on the H100: bytes. The function reads the mask (1 B a
// pixel) and writes the labels and four extent planes (20 B a pixel): 77.5 MB
// at 64 x 32 x 1801, 23.1 us at 3.35 TB/s. Everything else (the union-find)
// should stay out of device memory.
//
// Design (block-based union-find, after Allegretti, Bolelli & Grana, IEEE
// TPDS 2019, fitted to a 32-row frame). Two launches and a memset of one
// counter per frame:
//  1. strip_kernel, one CTA per 32 x 64 full-height column strip (29 a
//     frame): loads the strip's mask and labels it in shared memory. Each
//     foreground pixel's parent starts at the first pixel of its run
//     within its warp's 32 columns (one ballot), so horizontal unions cost
//     nothing; each run is united with the run above it once, and finds
//     halve their paths. Every vertical union and all horizontal ones but
//     the strip borders stay inside the CTA. It then reduces each local
//     root's extents with shared-memory atomics and stores only what the
//     merge needs: each foreground pixel's parent (its local root) and
//     each local root's extents, straight into the output planes. No pass
//     initialises the batch. Local indices (row * 64 + col) order pixels
//     as the frame's flat index does, so a local root is its piece's
//     smallest flat index. The last strip CTA of a frame to finish (a
//     per-frame counter, after a __threadfence) then merges the frame: it
//     unites the 32 pixel pairs across each of the 28 strip borders with
//     the atomicMin link rule (roots only ever point to smaller indices,
//     so a root stays its component's smallest index), records each root
//     it links, and folds that root's extents into its final root: 4
//     atomics a merged piece, not 4 a pixel. Frames never merge, so no
//     grid-wide barrier is needed.
//  2. write_kernel, one thread per pixel: finds each foreground pixel's
//     root (usually two hops) and writes the label and the root's extents;
//     background gets the constants. The labels plane holds the parents
//     until then; overwriting a parent with its root is path compression,
//     so other threads still reading the chain stay correct.
// Resources: 40 KB of static shared memory and 512 threads a CTA (4 CTAs an
// SM), 1,856 CTAs at batch 64. What holds it back from its bound: the
// second pass over the batch (the write kernel re-reads the mask and the
// parents) and each frame's merge, which runs on one CTA after its strips.
// One launch with a frame's strips as one thread-block cluster (128-column
// strips, 15 CTAs, merge and fold through distributed shared memory, each
// output written once from shared memory) reaches the byte bound on paper,
// but measured slower on an H100 at batch 64: at 96 KB of shared memory a
// CTA, few 15-CTA clusters fit at once.
// Union-find always converges; the reference's sweeps stop at max_iters,
// so the two agree wherever the sweeps converged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 64;                  // columns a strip CTA owns
constexpr int kMaxRows = 32;                // a strip holds the full height
constexpr int kTile = kStrip * kMaxRows;    // pixels of a strip
constexpr int kSmemInts = 5 * kTile;        // parents + 4 extent planes
constexpr int kThreads = 512;
constexpr int kWriteThreads = 256;
constexpr int kBig = 0x7FFFFFFE;  // INT32_MAX - 1, components._BIG

// ---- union-find; `volatile` because other threads relink roots ----------

__device__ __forceinline__ int find_root(const volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// find_root with path halving: each visited node is pointed at its
// grandparent. Safe beside concurrent links: the node is no root, so a
// link that lands on it meanwhile is retried from its old parent by the
// linking thread, and the grandparent lies in the same set.
__device__ __forceinline__ int find_halving(volatile int* parent, int x) {
  while (true) {
    int p = parent[x];
    if (p == x) return x;
    int gp = parent[p];
    if (gp == p) return p;
    parent[x] = gp;
    x = gp;
  }
}

// Unites the sets of a and b, linking the larger root under the smaller.
// Returns the root it linked (which stops being a root for good), or -1
// when a and b were already one set.
__device__ int unite(int* parent, int a, int b) {
  while (true) {
    a = find_halving(parent, a);
    b = find_halving(parent, b);
    if (a == b) return -1;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    // if b stopped being a root meanwhile, atomicMin still leaves
    // parent[b] < b, and we retry from its old parent
    int old = atomicMin(parent + b, a);
    if (old == b) return b;
    b = old;
  }
}

__global__ void __launch_bounds__(kThreads)
strip_kernel(const uint8_t* __restrict__ mask, int* __restrict__ parent_out,
             int* __restrict__ ext, int* __restrict__ frame_done, int height,
             int width, int nstrips, int64_t plane) {
  __shared__ int smem[kSmemInts];
  __shared__ int s_last, s_linked;
  int* par = smem;  // local parent, -1 on background
  volatile int* vpar = smem;
  int* sx0 = smem + kTile;      // min col
  int* sx1 = smem + 2 * kTile;  // max col
  int* sy0 = smem + 3 * kTile;  // min row
  int* sy1 = smem + 4 * kTile;  // max row

  const int b = blockIdx.x / nstrips;
  const int c0 = (blockIdx.x - b * nstrips) * kStrip;
  const int cw = min(kStrip, width - c0);
  const int64_t base = (int64_t)b * height * width;
  const uint8_t* m = mask + base;
  int* parent = parent_out + base;  // frame-relative flat indices
  const int n = height * kStrip;

  // a warp takes 32 columns of a row (n and kThreads are multiples of 32);
  // each foreground pixel's parent starts as the first pixel of its run
  // within those 32 (a ballot), so horizontal unions cost nothing
  for (int l = threadIdx.x; l < n; l += kThreads) {
    int r = l / kStrip, c = l % kStrip, lane = l % 32;
    bool fg = c < cw && m[r * width + c0 + c];
    unsigned runs = __ballot_sync(0xFFFFFFFFu, fg);
    unsigned starts = runs & ~(runs << 1) & (0xFFFFFFFFu >> (31 - lane));
    par[l] = fg ? l - lane + 31 - __clz(starts) : -1;
    sx0[l] = kBig;
    sx1[l] = -kBig;
    sy0[l] = kBig;
    sy1[l] = -kBig;
  }
  __syncthreads();
  // join the two half-row runs, and each run to the run above it once:
  // where the left and upper-left pixels are foreground too, the pixel to
  // the left has joined the same two runs
  for (int l = threadIdx.x; l < n; l += kThreads) {
    if (vpar[l] < 0) continue;
    int c = l % kStrip;
    bool left = c > 0 && vpar[l - 1] >= 0;
    if (c == 32 && left) unite(par, l, l - 1);
    if (l >= kStrip && vpar[l - kStrip] >= 0 && !(left && vpar[l - kStrip - 1] >= 0)) {
      unite(par, l, l - kStrip);
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < n; l += kThreads) {
    if (vpar[l] < 0) continue;
    int root = find_halving(vpar, l);
    vpar[l] = root;
    int r = l / kStrip, c = l % kStrip;
    atomicMin(sx0 + root, c);
    atomicMax(sx1 + root, c);
    atomicMin(sy0 + root, r);
    atomicMax(sy1 + root, r);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < n; l += kThreads) {
    int p = par[l];
    if (p < 0) continue;
    int g = (l / kStrip) * width + c0 + l % kStrip;
    parent[g] = (p / kStrip) * width + c0 + p % kStrip;
    if (p == l) {
      ext[base + g] = c0 + sx0[l];
      ext[plane + base + g] = c0 + sx1[l];
      ext[2 * plane + base + g] = sy0[l];
      ext[3 * plane + base + g] = sy1[l];
    }
  }

  // the frame's last strip CTA to get here merges the strip borders
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(frame_done + b, 1) == nstrips - 1;
    s_linked = 0;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int* linked = smem;  // the strip's arrays are free now
  const int pairs = (nstrips - 1) * height;
  for (int i = threadIdx.x; i < pairs; i += kThreads) {
    int g = (i % height) * width + (i / height + 1) * kStrip;
    if (m[g - 1] && m[g]) {
      int x = unite(parent, g - 1, g);
      if (x >= 0) linked[atomicAdd(&s_linked, 1)] = x;
    }
  }
  __syncthreads();
  // each linked root folds its piece's extents into its final root; a
  // linked root is never a final root, so no one writes its extents now
  for (int i = threadIdx.x; i < s_linked; i += kThreads) {
    int x = linked[i];
    int64_t root = base + find_halving(parent, x);
    int64_t at = base + x;
    atomicMin(ext + root, __ldcg(ext + at));
    atomicMax(ext + plane + root, __ldcg(ext + plane + at));
    atomicMin(ext + 2 * plane + root, __ldcg(ext + 2 * plane + at));
    atomicMax(ext + 3 * plane + root, __ldcg(ext + 3 * plane + at));
  }
}

// One thread a pixel: the label and the component's extents, or the
// background values. Plain find_root: a label written here is final, so
// no thread may rewrite another pixel's entry (path halving would).
__global__ void __launch_bounds__(kWriteThreads)
write_kernel(const uint8_t* __restrict__ mask, int* labels, int* ext,
             int64_t total, int hw) {
  int64_t i = (int64_t)blockIdx.x * kWriteThreads + threadIdx.x;
  if (i >= total) return;
  int l = -1, x0 = kBig, x1 = -kBig, y0 = kBig, y1 = -kBig;
  if (mask[i]) {
    int64_t base = i / hw * hw;
    l = find_root(labels + base, (int)(i - base));
    // a root's extents are final and only ever rewritten with themselves
    int64_t at = base + l;
    x0 = ext[at];
    x1 = ext[total + at];
    y0 = ext[2 * total + at];
    y1 = ext[3 * total + at];
  }
  labels[i] = l;
  ext[i] = x0;
  ext[total + i] = x1;
  ext[2 * total + i] = y0;
  ext[3 * total + i] = y1;
}

}  // namespace

// mask: (B, H, W) bool with H <= 32; frame_done: B int32 of scratch;
// labels: (B, H, W) int32 out; ext_out: (4, B, H, W) int32 out as (min_x,
// max_x, min_y, max_y). Launches on `stream`; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int tf_components_with_bbox(const void* mask, void* frame_done,
                                       void* labels, void* ext_out, int batch,
                                       int height, int width, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int64_t total = (int64_t)batch * height * width;
  if (total <= 0) return (int)cudaGetLastError();
  int nstrips = (width + kStrip - 1) / kStrip;
  if (height > kMaxRows || (nstrips - 1) * height > kSmemInts) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaMemsetAsync(frame_done, 0, sizeof(int) * batch, s);
  if (err != 0) return err;
  strip_kernel<<<batch * nstrips, kThreads, 0, s>>>(
      (const uint8_t*)mask, (int*)labels, (int*)ext_out, (int*)frame_done,
      height, width, nstrips, total);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  write_kernel<<<(int)((total + kWriteThreads - 1) / kWriteThreads),
                 kWriteThreads, 0, s>>>((const uint8_t*)mask, (int*)labels,
                                        (int*)ext_out, total, height * width);
  return (int)cudaGetLastError();
}
