// 4-connected component labels with per-component bbox extents, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `propagate_pallas` / `_propagate_kernel`
// (tpufusion/ops/pallas_cc.py), which keeps one frame's (5, 32, 1801) int32
// state (-flat_id, -col, col, -row, row) resident in VMEM and runs gated
// multi-distance max-shift sweeps to a fixed point. Contract (as
// tpufusion/ops/components.py connected_components_with_bbox): each
// foreground pixel's label is the smallest flat index (within its frame) of
// its 4-connected component, with no wrap across column 0 / W-1, plus the
// component's min/max column and row; background gets label -1.
//
// What bounds it on the H100: memory traffic and atomics, not FLOPs. The
// TPU state is 1.15 MB a frame, far above one SM's 227 KB of shared memory,
// so carrying the sweep over block by block would round-trip the state
// through L2/HBM every sweep, dozens of sweeps per frame.
//
// Design: union-find label equivalence (Playne & Hawick), which needs no
// sweep count at all. (1) init: parent[p] = p on foreground, -1 elsewhere;
// (2) union: each foreground pixel unites with its left (col > 0) and upper
// (row > 0) foreground neighbour, linking the larger root under the smaller
// with an atomicMin retry loop — parents only ever point to smaller
// indices, so each root is its component's smallest index, the same label
// the sweeps converge to; (3) resolve: each pixel finds its root, stores it
// (path compression) and folds its row/col into the root's extents with
// atomicMin/atomicMax; (4) finalize: each pixel gathers its root's label and
// extents. Four launches over the batch's pixels, each reading or writing a
// few int32 per pixel. Union-find always converges; the reference's sweeps
// stop at max_iters, so the two agree wherever the sweeps converged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBig = 0x7FFFFFFE;  // INT32_MAX - 1, components._BIG

__device__ __forceinline__ int load_parent(const int* parent, int x) {
  return *(const volatile int*)(parent + x);  // other threads relink roots
}

__device__ int find_root(const int* parent, int x) {
  int p = load_parent(parent, x);
  while (p != x) {
    x = p;
    p = load_parent(parent, x);
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    // link the larger root b under a; if b stopped being a root meanwhile,
    // atomicMin still leaves parent[b] < b, and we retry from its new parent
    int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void init_kernel(const uint8_t* __restrict__ mask, int* parent,
                            int* ext, int total) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  parent[i] = mask[i] ? i : -1;
  ext[i] = kBig;                // min col
  ext[total + i] = -kBig;       // max col
  ext[2 * total + i] = kBig;    // min row
  ext[3 * total + i] = -kBig;   // max row
}

__global__ void union_kernel(const uint8_t* __restrict__ mask, int* parent,
                             int total, int hw, int width) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || !mask[i]) return;
  int local = i % hw;
  int col = local % width;
  if (col > 0 && mask[i - 1]) unite(parent, i, i - 1);
  if (local >= width && mask[i - width]) unite(parent, i, i - width);
}

__global__ void resolve_kernel(const uint8_t* __restrict__ mask, int* parent,
                               int* ext, int total, int hw, int width) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || !mask[i]) return;
  int root = find_root(parent, i);
  parent[i] = root;
  int local = i % hw;
  int col = local % width, row = local / width;
  atomicMin(ext + root, col);
  atomicMax(ext + total + root, col);
  atomicMin(ext + 2 * total + root, row);
  atomicMax(ext + 3 * total + root, row);
}

__global__ void finalize_kernel(const uint8_t* __restrict__ mask,
                                const int* __restrict__ parent,
                                const int* __restrict__ ext,
                                int* __restrict__ labels,
                                int* __restrict__ out, int total, int hw) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  if (mask[i]) {
    int root = parent[i];
    labels[i] = root - (i / hw) * hw;
    out[i] = ext[root];
    out[total + i] = ext[total + root];
    out[2 * total + i] = ext[2 * total + root];
    out[3 * total + i] = ext[3 * total + root];
  } else {  // the reference's background values (-(-BIG), -BIG, ...)
    labels[i] = -1;
    out[i] = kBig;
    out[total + i] = -kBig;
    out[2 * total + i] = kBig;
    out[3 * total + i] = -kBig;
  }
}

}  // namespace

// mask: (B, H, W) bool; scratch: (5, B*H*W) int32 (parent + 4 extent
// planes); labels: (B, H, W) int32 out; ext_out: (4, B, H, W) int32 out as
// (min_x, max_x, min_y, max_y). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int tf_components_with_bbox(const void* mask, void* scratch,
                                       void* labels, void* ext_out, int batch,
                                       int height, int width, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int hw = height * width;
  int total = batch * hw;
  if (total <= 0) return (int)cudaGetLastError();
  int blocks = (total + kThreads - 1) / kThreads;
  const uint8_t* m = (const uint8_t*)mask;
  int* parent = (int*)scratch;
  int* ext = parent + total;
  init_kernel<<<blocks, kThreads, 0, s>>>(m, parent, ext, total);
  union_kernel<<<blocks, kThreads, 0, s>>>(m, parent, total, hw, width);
  resolve_kernel<<<blocks, kThreads, 0, s>>>(m, parent, ext, total, hw, width);
  finalize_kernel<<<blocks, kThreads, 0, s>>>(m, parent, ext, (int*)labels,
                                              (int*)ext_out, total, hw);
  return (int)cudaGetLastError();
}
