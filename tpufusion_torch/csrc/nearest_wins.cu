// Nearest-wins range-view z-buffer for Hopper (sm_90a): one launch, one
// thread-block cluster per frame, the cluster's barriers between its
// phases.
//
// Replaces the TPU kernel `nearest_wins_pallas_batch` / `_scatter_kernel`
// (tpufusion/ops/pallas_projection.py), which walks each frame's points in
// index order on the TPU's scalar core with a strict compare against an
// SMEM best-key grid, plus the image gather that follows it. Contract (same
// as tpufusion/ops/scatter.py nearest_wins_sort): per frame and pixel, the
// valid point with the smallest sortable-bits L2 key wins, ties to the
// lowest point index; invalid points are dropped whatever their pixel id;
// empty pixels get the fills (0, min_height, 0).
//
// What bounds it on the H100: bytes. The function reads each point's pixel
// id, key and validity (9 B), each winner's payload (12 B an occupied
// pixel) and writes the image (12 B a pixel): 63-88 MB at 64 x 32,768
// points, 19-26 us at 3.35 TB/s. In practice the 2.1 M atomics hold it
// back: on the H100 an atomic on another SM's shared memory costs about
// what one in L2 does.
//
// Design: the TPU kernel's sequential scan (strict compare in index order)
// becomes the minimum of the packed key (key_bits << 32) | point_idx per
// pixel, which any arrival order reaches: exact and deterministic. Keys are
// bit patterns of finite non-negative float32, so < 2^31, and every pack
// lies below the empty value ~0. A cluster of 16 CTAs takes a frame (16 x
// 512 threads); its barriers order three phases inside one launch: (1)
// each CTA fills its sixteenth of the frame's winner grid, (2) each CTA
// streams a sixteenth of the frame's points and does one 64-bit atomicMin
// per valid point into the grid, (3) each CTA decodes its slice of the
// grid, gathers the winners' (sqrt(x^2+y^2), z, intensity) payload and
// writes its slice of the image. The grid (461 KB a frame, 29.5 MB at
// batch 64) is scratch the caller allocates and never fills; it lives in
// the 50 MB L2. The earlier design took a fill pass, the scatter and a
// gather pass: three launches.
//
// Why the grid is not in distributed shared memory (a cluster holding a
// frame's 57,632 slots across its CTAs' shared memory): measured on an
// H100, a 64-bit atomicMin on a distributed-shared-memory address is not
// exact (ptxas emits a generic ATOM.E.MIN.64 / ATOMS.CAST.SPIN.64 pair,
// neither of which serves the cluster window;
// tpufusion_torch/probes/dsmem_min64.cu shows it), so that design needs
// two passes of 32-bit atomics (key, then index among equal keys), and
// remote shared-memory atomics proved no faster than L2 atomics: it lost
// to this design at 16 frames and came level at 64. The keys and payload
// are computed by the caller (as the Pallas kernel takes precomputed ids
// and keys), so no sqrt/atan2 rounding lives here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;  // CTAs a frame (a non-portable size; Hopper takes it)
constexpr int kThreads = 512;
constexpr int kUnroll = 2;    // points (then pixels) a thread keeps in flight
constexpr unsigned long long kEmpty = ~0ull;

__global__ void __launch_bounds__(kThreads)
zbuffer_kernel(const int32_t* __restrict__ pix, const int32_t* __restrict__ key,
               const uint8_t* __restrict__ valid,
               const float* __restrict__ payload, unsigned long long* grids,
               float* __restrict__ img, int n, int num_pixels, int slice,
               float min_height) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t b = blockIdx.x / kCluster;
  const int first = rank * slice;  // this CTA's pixels: [first, first + own)
  const int own = min(slice, num_pixels - first);
  const int64_t pbase = b * n;
  unsigned long long* grid = grids + b * num_pixels;

  for (int s = threadIdx.x; s < own; s += kThreads) grid[first + s] = kEmpty;
  cluster.sync();  // the frame's grid is empty before any atomic

  // a thread's points lie a cluster's width apart, so a warp's loads are
  // coalesced; all kUnroll loads are in flight before the atomics
  const int stride = kCluster * kThreads;
  for (int base = rank * kThreads + threadIdx.x; base < n; base += kUnroll * stride) {
    int p[kUnroll];
    unsigned long long packed[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int i = base + u * stride;
      ok[u] = i < n && valid[pbase + i];
      p[u] = i < n ? pix[pbase + i] : 0;
      packed[u] = ((unsigned long long)(uint32_t)(i < n ? key[pbase + i] : 0) << 32) | (uint32_t)i;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // invalid points are dropped whatever their id; valid ids are in range
      if (ok[u] && (uint32_t)p[u] < (uint32_t)num_pixels) atomicMin(grid + p[u], packed[u]);
    }
  }
  cluster.sync();  // every atomic of the frame has landed

  float* out = img + (b * num_pixels + first) * 3;
  for (int base = threadIdx.x; base < own; base += kUnroll * kThreads) {
    float v[kUnroll][3];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every gather in flight before any store
      int s = base + u * kThreads;
      unsigned long long g = s < own ? __ldcg(grid + first + s) : kEmpty;  // from L2
      v[u][0] = 0.0f, v[u][1] = min_height, v[u][2] = 0.0f;
      if (g != kEmpty) {
        const float* row = payload + (pbase + (uint32_t)g) * 3;
        v[u][0] = row[0], v[u][1] = row[1], v[u][2] = row[2];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int s = base + u * kThreads;
      if (s < own) out[s * 3] = v[u][0], out[s * 3 + 1] = v[u][1], out[s * 3 + 2] = v[u][2];
    }
  }
}

}  // namespace

// pix, key: (B, N) int32; valid: (B, N) bool; payload: (B, N, 3) float32;
// grids: (B, P) int64 scratch, any contents; img: (B, P, 3) float32 output.
// Launches on `stream`; returns the launch's error code.
extern "C" int tf_nearest_wins_image(const void* pix, const void* key,
                                     const void* valid, const void* payload,
                                     void* grids, void* img, int batch, int n,
                                     int num_pixels, float min_height,
                                     void* stream) {
  if (batch <= 0 || num_pixels <= 0) return (int)cudaGetLastError();
  static unsigned long long allowed = 0;  // devices that take 16-CTA clusters
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err == 0 && device < 64 && !(allowed >> device & 1)) {
    err = (int)cudaFuncSetAttribute(
        zbuffer_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == 0) allowed |= 1ull << device;
  }
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int slice = (num_pixels + kCluster - 1) / kCluster;
  return (int)cudaLaunchKernelEx(
      &cfg, zbuffer_kernel, (const int32_t*)pix, (const int32_t*)key,
      (const uint8_t*)valid, (const float*)payload, (unsigned long long*)grids,
      (float*)img, n, num_pixels, slice, min_height);
}

extern "C" const char* tf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
