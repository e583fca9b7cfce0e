// Nearest-wins range-view z-buffer for Hopper (sm_90a).
//
// Replaces the TPU kernel `nearest_wins_pallas_batch` / `_scatter_kernel`
// (tpufusion/ops/pallas_projection.py), which walks each frame's points in
// index order on the TPU's scalar core with a strict compare against an
// SMEM best-key grid. Contract (same as tpufusion/ops/scatter.py
// nearest_wins_sort): per frame and pixel, the valid point with the smallest
// sortable-bits L2 key wins, ties to the lowest point index; empty pixels get
// the fills (0, min_height, 0).
//
// What bounds it on the H100: not FLOPs (there are none) but the point
// stream and the atomics. Each valid point is one 64-bit atomicMin into a
// per-frame grid of 57,632 slots (461 KB a frame, 29.5 MB at batch 64, so
// the whole grid stays in the 50 MB L2 and the atomics resolve there), and
// collisions on one pixel serialise in L2. The gather pass reads the grid
// once and the winners' payload rows at random.
//
// Design: the sequential scan of the TPU kernel becomes one thread per
// point, and the order it gave (strict compare in index order) becomes the
// order of the packed key: (key_bits << 32) | point_idx. Keys are bit
// patterns of finite non-negative float32, so < 2^31, and every pack lies
// below the grid's fill INT64_MAX read as unsigned; atomicMin on the pack
// picks the smallest key and, among equal keys, the smallest index, in any
// arrival order — the result is exact and deterministic by construction.
// A second kernel, one thread per pixel, decodes the winner from the low 32
// bits and gathers the precomputed (sqrt(x^2+y^2), z, intensity) payload.
// The keys and payload are computed by the caller (as the Pallas kernel
// takes precomputed ids and keys), so no sqrt/atan2 rounding lives here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmpty = 0x7FFFFFFFFFFFFFFFull;  // INT64_MAX

__global__ void scatter_min_kernel(const int32_t* __restrict__ pix,
                                   const int32_t* __restrict__ key,
                                   const uint8_t* __restrict__ valid,
                                   unsigned long long* __restrict__ grid,
                                   int64_t total, int n, int num_pixels) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || !valid[i]) return;
  int32_t p = pix[i];
  if ((uint32_t)p >= (uint32_t)num_pixels) return;  // contract: never taken
  int64_t b = i / n;
  uint32_t idx = (uint32_t)(i - b * n);
  unsigned long long packed =
      ((unsigned long long)(uint32_t)key[i] << 32) | idx;
  atomicMin(grid + b * num_pixels + p, packed);
}

__global__ void gather_kernel(const unsigned long long* __restrict__ grid,
                              const float* __restrict__ payload,
                              float* __restrict__ img, int64_t total, int n,
                              int num_pixels, float min_height) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  unsigned long long g = grid[i];
  float d = 0.0f, h = min_height, it = 0.0f;
  if (g != kEmpty) {
    int64_t b = i / num_pixels;
    const float* row = payload + (b * n + (int64_t)(uint32_t)g) * 3;
    d = row[0];
    h = row[1];
    it = row[2];
  }
  img[i * 3 + 0] = d;
  img[i * 3 + 1] = h;
  img[i * 3 + 2] = it;
}

int blocks_for(int64_t total) { return (int)((total + kThreads - 1) / kThreads); }

}  // namespace

// pix, key: (B, N) int32; valid: (B, N) bool; payload: (B, N, 3) float32;
// grid: (B, P) int64 filled with INT64_MAX by the caller; img: (B, P, 3)
// float32 output. Launches on `stream`; returns cudaGetLastError().
extern "C" int tf_nearest_wins_image(const void* pix, const void* key,
                                     const void* valid, const void* payload,
                                     void* grid, void* img, int batch, int n,
                                     int num_pixels, float min_height,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int64_t points = (int64_t)batch * n;
  int64_t pixels = (int64_t)batch * num_pixels;
  if (points > 0) {
    scatter_min_kernel<<<blocks_for(points), kThreads, 0, s>>>(
        (const int32_t*)pix, (const int32_t*)key, (const uint8_t*)valid,
        (unsigned long long*)grid, points, n, num_pixels);
  }
  if (pixels > 0) {
    gather_kernel<<<blocks_for(pixels), kThreads, 0, s>>>(
        (const unsigned long long*)grid, (const float*)payload, (float*)img,
        pixels, n, num_pixels, min_height);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
