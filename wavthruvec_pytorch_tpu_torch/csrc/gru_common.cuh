// Pieces shared by the BiGRU's forward (gru_fwd.cu) and backward
// (gru_bwd.cu) kernels: the gate nonlinearity, the persistent routes'
// per-direction barrier and the shuffle reduce-scatter of partial sums.
// The library hash covers this file.

#pragma once

#include <cuda_runtime.h>

namespace gru {

// accurate expf: the libraries are built without --use_fast_math
__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// The per-direction barrier, in two halves so that work that no other block
// waits for runs while it is in flight.  arrive: after a bar.sync that
// follows the block's writes, thread 0 adds 1 with gpu-scope release
// semantics (cumulative: it orders the writes the bar.sync made visible to
// it).  wait: thread 0 polls with gpu-scope acquire loads until every block
// of the direction has arrived `target` times in all; the bar.sync after it
// orders the block's later reads after the others' writes.
__device__ __forceinline__ void barrier_arrive(unsigned* counter) {
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

__device__ __forceinline__ void barrier_wait(unsigned* counter, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// One step of the reduce-scatter of N partial sums over the lanes that
// differ in bit M of the lane index: the lanes with it set keep the upper
// half, the others the lower, each adding its partner's copy of that half.
template <int N, int M>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? v[i] : v[i + N / 2];
    const float keep = up ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

}  // namespace gru
