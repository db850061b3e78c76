// Pieces shared by the BiGRU's forward (gru_fwd.cu) and backward
// (gru_bwd.cu) kernels: the gate nonlinearity, the persistent routes'
// per-direction barrier, the shuffle reduce-scatter of partial sums, the
// cluster pieces and launch of the backward's pairs, and the phase stamps of
// tools/gru_f32.py.  The library hash covers this file.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace gru {

// Where a step of a persistent kernel goes, for tools/gru_f32.py: built with
// -DGRU_PROFILE, thread 0 of block 0 adds the %globaltimer nanoseconds since
// its previous mark to the phase each mark names (a nested mark times a span
// inside another phase), and the kernel's end stores the sums in gru_prof,
// which the library's gru_prof_read copies out.  Built without it, every
// mark compiles to nothing.
enum { PROF_BARRIER, PROF_STAGES, PROF_WAITS, PROF_REDUCE, PROF_UNIT, PROF_ARRIVAL, PROF_N };

#ifdef GRU_PROFILE
__device__ unsigned long long gru_prof[PROF_N];

struct Stamps {
  bool on;
  unsigned long long last, sum[PROF_N];
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ Stamps() : on(blockIdx.x == 0 && threadIdx.x == 0), last(now()) {
    for (int i = 0; i < PROF_N; ++i) sum[i] = 0;
  }
  __device__ void mark(int phase) {
    if (on) {
      const unsigned long long t = now();
      sum[phase] += t - last;
      last = t;
    }
  }
  __device__ unsigned long long start() const { return on ? now() : 0; }
  __device__ void nested(int phase, unsigned long long t0) {
    if (on) sum[phase] += now() - t0;
  }
  __device__ void store() {
    if (on)
      for (int i = 0; i < PROF_N; ++i) gru_prof[i] = sum[i];
  }
};
#define GRU_PROF_READER                                                                     \
  extern "C" int gru_prof_read(unsigned long long* out) {                                  \
    return static_cast<int>(cudaMemcpyFromSymbol(out, gru::gru_prof, sizeof(gru::gru_prof))); \
  }
#else
struct Stamps {
  __device__ void mark(int) {}
  __device__ unsigned long long start() const { return 0; }
  __device__ void nested(int, unsigned long long) {}
  __device__ void store() {}
};
#define GRU_PROF_READER
#endif

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

// ===========================================================================
// clusters: the backward's pairs (gru_bwd.cu)
// ===========================================================================

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; release / acquire at cluster scope
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// A float stored into shared address `addr` of block `rank` of the cluster,
// completing 4 bytes of the transaction count of that block's mbarrier at
// `bar` (st.async: no fence, no arrival).
__device__ __forceinline__ void st_async_remote(uint32_t addr, uint32_t bar, uint32_t rank,
                                                float v) {
  asm volatile(
      "{\n.reg .b32 a, m;\nmapa.shared::cluster.u32 a, %0, %2;\n"
      "mapa.shared::cluster.u32 m, %1, %2;\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [a], %3, [m];\n}\n" ::"r"(addr),
      "r"(bar), "r"(rank), "r"(__float_as_uint(v))
      : "memory");
}

}  // namespace gru

// ---------------------------------------------------------------------------
// host: the clustered persistent launch
// ---------------------------------------------------------------------------

namespace gru_host {

// The number of clusters of C blocks of `threads` threads and `smem` bytes of
// shared memory that can be resident at once (cudaOccupancyMaxActiveClusters).
template <typename... Args>
cudaError_t max_clusters(void (*kernel)(Args...), int blocks, int threads, size_t smem, int C,
                         int* n) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// A persistent grid of `blocks` blocks in clusters of C, every block
// resident or no launch: refused (cudaErrorCooperativeLaunchTooLarge) unless
// the card can hold all blocks / C clusters at once, then launched with the
// cluster dimension and the cooperative attribute together (the toolkit
// takes both: the cooperative launch alone guarantees residency, the
// occupancy check makes the refusal the wrapper's error, not a hang).
template <typename... Args, typename... Params>
cudaError_t launch_clustered(void (*kernel)(Args...), int blocks, int threads, size_t smem,
                             int C, cudaStream_t stream, Params... params) {
  if (C < 1 || blocks % C != 0) return cudaErrorInvalidValue;
  int n = 0;
  cudaError_t e = max_clusters(kernel, blocks, threads, smem, C, &n);
  if (e != cudaSuccess) return e;
  if (n * C < blocks) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Args>(params)...);
}

}  // namespace gru_host
