// Probe: where a kernel's time goes, phase by phase.
//
// Includes one kernel source of csrc/ (-DTF_PROBE_SOURCE=\"name.cu\", with
// -I csrc) and defines its TF_STAMP(kernel, slot) hooks: thread 0 of each
// CTA records clock64() (the SM's cycles, for the phases inside a CTA) and
// %globaltimer (ns, one clock for the whole card, for a launch's span from
// its first CTA's start to its last CTA's end) when it reaches a slot. The
// source's own C entry is unchanged, so the port's wrapper drives it.
// tf_probe_reset() clears every stamp; tf_probe_read(clock, timer) copies
// them to the host, kProbeKernels x kProbeBlocks x kProbeSlots each, 0
// where a CTA never reached the slot. Not part of the shipped library:
// `python -m tpufusion_torch.probes.phase_split` builds and runs it.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kProbeKernels = 4;    // the launches of one C entry
constexpr int kProbeBlocks = 8192;  // CTAs a launch (more are not stamped)
constexpr int kProbeSlots = 12;     // stamps a CTA

__device__ unsigned long long tf_probe_clock[kProbeKernels][kProbeBlocks][kProbeSlots];
__device__ unsigned long long tf_probe_timer[kProbeKernels][kProbeBlocks][kProbeSlots];

__device__ __forceinline__ void tf_probe_stamp(int kernel, int slot) {
  if (threadIdx.x != 0 || threadIdx.y != 0 || threadIdx.z != 0) return;
  const unsigned int block = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (block >= (unsigned int)kProbeBlocks) return;
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  tf_probe_clock[kernel][block][slot] = clock64();
  tf_probe_timer[kernel][block][slot] = ns;
}

#define TF_STAMP(kernel, slot) tf_probe_stamp(kernel, slot)
#include TF_PROBE_SOURCE

extern "C" int tf_probe_shape(int* kernels, int* blocks, int* slots) {
  *kernels = kProbeKernels;
  *blocks = kProbeBlocks;
  *slots = kProbeSlots;
  return 0;
}

extern "C" int tf_probe_reset() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, tf_probe_clock);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(tf_probe_clock));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, tf_probe_timer);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(tf_probe_timer));
  return (int)err;
}

extern "C" int tf_probe_read(void* clock, void* timer) {
  cudaError_t err = cudaMemcpyFromSymbol(clock, tf_probe_clock, sizeof(tf_probe_clock));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(timer, tf_probe_timer, sizeof(tf_probe_timer));
  return (int)err;
}

extern "C" const char* tf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
