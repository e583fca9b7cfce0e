// The packed ("quantized-key") range-view z-buffer for Hopper (sm_90a):
// one launch, one thread-block cluster per frame, the frame's int32 grid in
// the cluster's shared memory.
//
// Replaces `nearest_wins_scatter_packed` (tpufusion/ops/scatter.py:107,
// one XLA scatter-min over an int32 pack, outside Pallas) plus the image
// gather that follows it (tpufusion/geometry/range_view.py:103-111).
// Contract (the reference's rule literally): with idx_bits =
// max((N - 1).bit_length(), 1) for the frame's padded point count N, each
// valid point packs ((key >> idx_bits) << idx_bits) | point_idx into an
// int32 (an arithmetic shift, as XLA's int32 >>); per frame and pixel the
// smallest pack wins, and the winner is its low idx_bits. Two points whose
// keys agree in all but the low idx_bits go to the lower index. Invalid
// points are dropped whatever their pixel id or key (the caller's INT32_MAX
// key for a non-finite point does not survive the shift, so the mask is
// `valid`, not the key); empty pixels get the fills (0, min_height, 0).
//
// The bound on the H100 is bytes, as for the exact z-buffer
// (nearest_wins.cu): each point's pixel id, key and validity (9 B), each
// winner's payload (12 B an occupied pixel), the image (12 B a pixel):
// 23.6 us at 64 x 32,768 into 32 x 1801 at 3.35 TB/s, the image's 44 MB
// most of it. The earlier design (the exact kernel's scheme with 32-bit
// words, its grid in L2: a fill and a read back of 14.75 MB beside the
// image's stream, scalar image stores at a stride of 3 floats) ran at
// 47-50 % of it.
//
// Design: a cluster of kCluster CTAs takes a frame; CTA r owns the
// frame's pixels [r * slots, (r + 1) * slots), slots = ceil(P / kCluster)
// (3,602 at 32 x 1801, 7,092 at 63 x 1801 with a ragged last slice of
// 7,083), as an int32 array in its own dynamic shared memory. (1) Each
// CTA issues the loads of its first points, fills its slots with
// INT32_MAX; cluster barrier. (2) Each CTA streams 1 / kCluster of the
// frame's points and does one 32-bit atomicMin per valid point on the
// owning CTA's slot through the cluster's window (`map_shared_rank`); a
// 32-bit atomicMin on distributed shared memory is exact on sm_90a
// (probes/dsmem_min64.cu, row min32); cluster barrier. (3) Each CTA
// decodes its own slots from local shared memory, gathers the winners'
// payload (eight pixels a thread in flight), stages a tile's image rows in
// shared memory and writes them as 16-byte stores, aligned and coalesced.
// Any arrival order reaches the same minimum: exact and deterministic. No
// grid in device memory: the caller allocates only the image. 256 threads
// a CTA at four CTAs an SM (64 registers): the card holds 28 frames'
// clusters at once (cudaOccupancyMaxActiveClusters). Blocks of 128 to 512
// threads and clusters of 8 CTAs were tried in scratch builds; this was
// the fastest of them at 64 x 32,768.
//
// What holds it at ~52 % of the bound (no Nsight Compute on the card's
// machine; read from `kernel_bench.py`'s rows on an H100 at 700 W): the
// frame's fixed phases, not the atomics. With every point invalid (the
// fill, the point loads, both barriers, the decode and the image's stores,
// no atomic and no gather) it takes 32.6 of its 45.3 us at 64 x 32,768,
// 47.6 of 72.8 at 63 x 1801. At 16 x 131,072 (8,192 points a CTA) the
// distributed-shared-memory atomics cost more than the earlier design's
// L2 atomics: 31.9 us against its 24.7.
//
// Any image size: when a CTA's slots would not fit the shared memory a
// block can hold (P > ~830,000 pixels at 16 CTAs), the slots are cut to
// what fits and the kernel makes one pass over the frame's points per band
// of kCluster * slots pixels (fill, scatter of the band's points, decode).
// The band count follows from the shape, inside the kernel; one band is
// the common case, not a separate path.
//
// The cluster width is a compile-time constant (-DTF_PACKED_CLUSTER=8
// builds the 8-CTA variant `kernel_bench.py` times beside it).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifndef TF_PACKED_CLUSTER
#define TF_PACKED_CLUSTER 16
#endif

namespace {

constexpr int kCluster = TF_PACKED_CLUSTER;  // CTAs a frame (16: a non-portable size)
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;               // CTAs an SM: at most 64 registers a thread
constexpr int kUnroll = 4;                  // points a thread keeps in flight
constexpr int kTile = 8 * kThreads;         // pixels a decode tile, eight a thread
constexpr int kStageFloats = 3 * kTile + 4; // a tile's rows, shifted to a 16-byte boundary
constexpr int kEmpty = 0x7fffffff;

struct Points {  // kUnroll points of one thread: band-relative id, pack, kept
  uint32_t rel[kUnroll];
  int packed[kUnroll];
  bool ok[kUnroll];
};

__device__ __forceinline__ void load_points(Points& q, const int32_t* __restrict__ pix,
                                            const int32_t* __restrict__ key,
                                            const uint8_t* __restrict__ valid, int64_t pbase,
                                            int base, int stride, int n, int num_pixels,
                                            int band0, int span, int idx_bits) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = base + u * stride;
    const bool in = i < n;
    const int p = in ? pix[pbase + i] : 0;
    const int k = in ? key[pbase + i] : 0;
    q.rel[u] = (uint32_t)p - (uint32_t)band0;
    // invalid points are dropped whatever their id; so are ids off the image
    q.ok[u] = in && valid[pbase + i] && (uint32_t)p < (uint32_t)num_pixels &&
              q.rel[u] < (uint32_t)span;
    // arithmetic >> on the signed key, then << on its unsigned bits
    q.packed[u] = (int)(((uint32_t)(k >> idx_bits) << idx_bits) | (uint32_t)i);
  }
}

__device__ __forceinline__ void scatter_points(const Points& q, cg::cluster_group& cluster,
                                               int* grid, int slots) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (q.ok[u]) {
      const int owner = (int)(q.rel[u] / (uint32_t)slots);
      atomicMin(cluster.map_shared_rank(grid, owner) + (q.rel[u] - owner * slots), q.packed[u]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
packed_zbuffer_kernel(const int32_t* __restrict__ pix, const int32_t* __restrict__ key,
                      const uint8_t* __restrict__ valid, const float* __restrict__ payload,
                      float* __restrict__ img, int n, int num_pixels, int slots, int idx_bits,
                      float min_height) {
  extern __shared__ __align__(16) int smem[];
  float* stage = reinterpret_cast<float*>(smem);  // kStageFloats (a multiple of 4)
  int* grid = smem + kStageFloats;                // this CTA's slots
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t b = blockIdx.x / kCluster;
  const int64_t pbase = b * n;
  const uint32_t idx_mask = (1u << idx_bits) - 1u;
  const int span = kCluster * slots;  // pixels a band
  const int stride = kCluster * kThreads;

  for (int band0 = 0; band0 < num_pixels; band0 += span) {
    const int first = band0 + rank * slots;  // this CTA's pixels: [first, first + own)
    const int own = max(0, min(slots, num_pixels - first));
    // a thread's points lie a cluster's width apart, so a warp's loads are
    // coalesced; the first kUnroll are in flight across the fill and barrier
    int base = rank * kThreads + threadIdx.x;
    Points q;
    if (base < n)
      load_points(q, pix, key, valid, pbase, base, stride, n, num_pixels, band0, span, idx_bits);
    for (int s = threadIdx.x; s < own; s += kThreads) grid[s] = kEmpty;
    cluster.sync();  // every slot of the band is empty before any atomic
    while (base < n) {
      scatter_points(q, cluster, grid, slots);
      base += kUnroll * stride;
      if (base < n)
        load_points(q, pix, key, valid, pbase, base, stride, n, num_pixels, band0, span, idx_bits);
    }
    cluster.sync();  // every atomic of the band has landed

    // decode: image floats [3 * (b * P + first), ...) of this CTA, a tile at
    // a time; the stage holds a tile's floats from the 16-byte boundary at
    // or below its first float, so every whole float4 of the tile is one
    // aligned store
    const int64_t pix0 = b * (int64_t)num_pixels + first;
    for (int t0 = 0; t0 < own; t0 += kTile) {
      const int cnt = min(kTile, own - t0);
      const int64_t f0 = 3 * (pix0 + t0);
      const int shift = (int)(f0 & 3);
      float v[kTile / kThreads][3];
#pragma unroll
      for (int u = 0; u < kTile / kThreads; ++u) {  // every gather in flight before any store
        const int s = threadIdx.x + u * kThreads;
        const int g = s < cnt ? grid[t0 + s] : kEmpty;
        v[u][0] = 0.0f, v[u][1] = min_height, v[u][2] = 0.0f;
        if (g != kEmpty) {
          const float* row = payload + (pbase + ((uint32_t)g & idx_mask)) * 3;
          v[u][0] = __ldg(row), v[u][1] = __ldg(row + 1), v[u][2] = __ldg(row + 2);
        }
      }
#pragma unroll
      for (int u = 0; u < kTile / kThreads; ++u) {
        const int s = threadIdx.x + u * kThreads;
        if (s < cnt) {
          float* st = stage + shift + 3 * s;
          st[0] = v[u][0], st[1] = v[u][1], st[2] = v[u][2];
        }
      }
      __syncthreads();
      float* out = img + (f0 - shift);  // 16-byte aligned
      const int nf = shift + 3 * cnt;   // stage floats [shift, nf) are the tile's
      const int q0 = shift ? 1 : 0, q1 = nf >> 2;
      for (int j = q0 + threadIdx.x; j < q1; j += kThreads)
        reinterpret_cast<float4*>(out)[j] = reinterpret_cast<const float4*>(stage)[j];
      if (threadIdx.x < 4) {  // the floats before the first whole float4
        const int j = shift + threadIdx.x;
        if (j < min(4 * q0, nf)) out[j] = stage[j];
      } else if (threadIdx.x >= kThreads - 4) {  // and after the last one
        const int j = max(4 * max(q0, q1), shift) + threadIdx.x - (kThreads - 4);
        if (j < nf) out[j] = stage[j];
      }
      __syncthreads();  // the next tile rewrites the stage
    }
  }
}

// per device: the most slots a CTA holds (0: not set up yet)
int g_max_slots[64] = {};

int setup(int* max_slots) {
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device < 64 && g_max_slots[device] > 0) {
    *max_slots = g_max_slots[device];
    return 0;
  }
  int optin = 0;
  err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == 0 && kCluster > 8)
    err = (int)cudaFuncSetAttribute(packed_zbuffer_kernel,
                                    cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(packed_zbuffer_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != 0) return err;
  *max_slots = (optin - kStageFloats * (int)sizeof(float)) / (int)sizeof(int);
  if (device < 64) g_max_slots[device] = *max_slots;
  return 0;
}

// The launch's shape for an image of num_pixels: slots a CTA, dynamic
// shared memory, and its configuration (attrs must outlive the launch).
int plan(int batch, int num_pixels, void* stream, int* slots, cudaLaunchConfig_t* cfg,
         cudaLaunchAttribute* attr) {
  int max_slots = 0;
  int err = setup(&max_slots);
  if (err != 0) return err;
  const int slice = (num_pixels + kCluster - 1) / kCluster;
  *slots = slice < max_slots ? slice : max_slots;  // below the slice: bands
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(batch * kCluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = (size_t)(kStageFloats + *slots) * sizeof(int);
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

}  // namespace

// pix, key: (B, N) int32; valid: (B, N) bool; payload: (B, N, 3) float32;
// img: (B, P, 3) float32 output, 16-byte aligned; idx_bits: max((N -
// 1).bit_length(), 1), at most 30. Launches on `stream`; returns the
// launch's error code.
extern "C" int tf_nearest_wins_packed_image(const void* pix, const void* key,
                                            const void* valid, const void* payload,
                                            void* img, int batch, int n, int num_pixels,
                                            int idx_bits, float min_height, void* stream) {
  if (batch <= 0 || num_pixels <= 0) return (int)cudaGetLastError();
  if (idx_bits < 1 || idx_bits > 30 || (n > 0 && ((n - 1) >> idx_bits) != 0) ||
      (reinterpret_cast<uintptr_t>(img) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int slots = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = plan(batch, num_pixels, stream, &slots, &cfg, attr);
  if (err != 0) return err;
  return (int)cudaLaunchKernelEx(&cfg, packed_zbuffer_kernel, (const int32_t*)pix,
                                 (const int32_t*)key, (const uint8_t*)valid,
                                 (const float*)payload, (float*)img, n, num_pixels, slots,
                                 idx_bits, min_height);
}

// For an image of num_pixels: the slots a CTA holds, its dynamic shared
// memory in bytes, the bands, and how many of the frames' clusters the card
// holds at once (cudaOccupancyMaxActiveClusters). Returns an error code.
extern "C" int tf_nearest_wins_packed_shape(int num_pixels, int* slots, int* smem_bytes,
                                            int* bands, int* clusters) {
  if (num_pixels <= 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = plan(1, num_pixels, nullptr, slots, &cfg, attr);
  if (err != 0) return err;
  *smem_bytes = (int)cfg.dynamicSmemBytes;
  *bands = (num_pixels + kCluster * *slots - 1) / (kCluster * *slots);
  return (int)cudaOccupancyMaxActiveClusters(clusters, packed_zbuffer_kernel, &cfg);
}
