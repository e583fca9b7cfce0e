// Probe: are atomics on distributed shared memory exact on this card?
//
// A cluster of two CTAs; every thread of each CTA sends one value per slot
// to the other CTA's 64 slots (through `map_shared_rank`), by one of three
// operations, and the host checks each slot against the minimum it must
// hold. Prints one line per operation: the slots that differ, of 128.
//   min64  atomicMin on unsigned long long (what a one-pass z-buffer with
//          the packed (key << 32) | index would use)
//   cas64  a 64-bit atomicCAS loop computing the same minimum
//   min32  atomicMin on the high 32 bits alone (the two-pass form's key)
// On an H100 (sm_90a, CUDA 12.8) min64 differs in every slot and the other
// two in none: ptxas lowers the generic 64-bit min to ATOM.E.MIN.64 /
// ATOMS.CAST.SPIN.64, neither of which serves the cluster window. This is
// why csrc/nearest_wins.cu keeps its grid in L2. Built and run by
// `python -m tpufusion_torch.kernel_bench --dsmem-probe`.

#include <cooperative_groups.h>
#include <cstdint>
#include <cstdio>
#include <vector>

namespace cg = cooperative_groups;

constexpr int kSlots = 64, kThreads = 256;

__host__ __device__ unsigned long long value(int rank, int t, int slot) {
  unsigned long long x = (unsigned long long)(rank * 1000003 + t * 7919 + slot * 104729 + 12345);
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  x *= 0x9E3779B97F4A7C15ull;
  return (x >> 2) & 0x7FFFFFFFFFFFFFFFull;
}

template <int kOp>
__global__ void __cluster_dims__(2, 1, 1) probe(unsigned long long* out) {
  __shared__ unsigned long long slots[kSlots];
  cg::cluster_group cluster = cg::this_cluster();
  int rank = (int)cluster.block_rank();
  for (int i = threadIdx.x; i < kSlots; i += kThreads) slots[i] = ~0ull;
  cluster.sync();
  for (int j = 0; j < kSlots; ++j) {
    unsigned long long* dst = cluster.map_shared_rank(slots + j, 1 - rank);
    unsigned long long v = value(rank, threadIdx.x, j);
    if (kOp == 0) {
      atomicMin(dst, v);
    } else if (kOp == 1) {
      unsigned long long old = *(volatile unsigned long long*)dst;
      while (v < old) {
        unsigned long long prev = atomicCAS(dst, old, v);
        if (prev == old) break;
        old = prev;
      }
    } else {
      atomicMin((unsigned int*)dst + 1, (unsigned int)(v >> 32));  // the high word
    }
  }
  cluster.sync();
  for (int i = threadIdx.x; i < kSlots; i += kThreads) out[rank * kSlots + i] = slots[i];
}

template <int kOp>
int run(const char* name) {
  unsigned long long* d;
  cudaMalloc(&d, 2 * kSlots * sizeof(unsigned long long));
  probe<kOp><<<2, kThreads>>>(d);
  cudaError_t err = cudaDeviceSynchronize();
  std::vector<unsigned long long> h(2 * kSlots);
  cudaMemcpy(h.data(), d, h.size() * sizeof(h[0]), cudaMemcpyDeviceToHost);
  cudaFree(d);
  int bad = 0;
  for (int r = 0; r < 2; ++r) {
    for (int j = 0; j < kSlots; ++j) {
      unsigned long long want = ~0ull;  // CTA r's slot holds CTA (1 - r)'s values
      for (int t = 0; t < kThreads; ++t) want = value(1 - r, t, j) < want ? value(1 - r, t, j) : want;
      unsigned long long got = h[r * kSlots + j];
      bad += kOp == 2 ? (got >> 32) != (want >> 32) : got != want;
    }
  }
  printf("%s: %d of %d slots differ (%s)\n", name, bad, 2 * kSlots, cudaGetErrorString(err));
  return err != cudaSuccess;
}

int main() {
  return run<0>("min64") | run<1>("cas64") | run<2>("min32");
}
