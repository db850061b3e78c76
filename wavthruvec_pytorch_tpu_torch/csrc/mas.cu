// Width-1 monotonic alignment search (MAS) for Hopper (sm_90a): a Viterbi
// pass over the T frames of a soft alignment [B, T, N] (frames x text), then
// a backtrack that writes the hard 0/1 map.  Per item b:
//
//   log_a[i, j] = max(log(max(a[i, j], 0)), -1e30), -1e30 for j >= in_len,
//                 and row 0 pinned to column 0 (-1e30 for j > 0)
//   log_p[0]    = log_a[0]
//   left        = log_p[i-1, j-1]  (-1e30 for j = 0)
//   take_left   = left >= log_p[i-1, j]      (a tie goes left)
//   log_p[i, j] = log_a[i, j] + max(left, log_p[i-1, j])
//
// then from (out_len-1, in_len-1) up to row 0: mark the cell, step one
// column left where take_left says so; rows >= out_len stay 0, and
// opt[0, 0] = 1 for every item with out_len > 0.  A backtrack that steps
// left of column 0 marks nothing more.  -1e30 is large-finite, as in the
// JAX package: sums of it stay finite and ties among them are exact.
//
// Replaces: wavthruvec_pytorch_tpu/ops/mas_pallas.py, mas_width1_pallas
// (Pallas kernel _mas_kernel), which computes what the JAX model's
// ops/mas.py mas_width1_batched computes.  Built without fast math, so logf
// is the accurate one and the result equals the plain PyTorch version's bit
// for bit.
//
// What bounds it on an H100: the serial chain of out_len dependent rows,
// not bytes or flops.  The bytes it must move (the [B, T, N] f32 input read
// once, the output written once) take microseconds at 3.35 TB/s; each row
// waits on the one before.  The TPU kernel keeps an f32 take_left plane
// [T, N] in VMEM (1.5 MB per item at T = 3000, N = 128), which no Hopper
// block can hold.  This design:
//   * one block per item, one thread per text column (N <= 1024): log_p
//     lives in a register; the left neighbour comes by __shfl_up_sync
//     within a warp and through one shared word per warp across warp
//     boundaries (double-buffered by row parity), so a row costs one
//     __syncthreads;
//   * each row's take_left goes into shared memory as bits, one
//     __ballot_sync word per warp: T * ceil(N/32) * 4 bytes, 48,000 bytes at
//     T = 3000, N = 128, held as dynamic shared memory.  Where that exceeds
//     the card's opt-in shared memory per block (294,912 bytes at T = 3072,
//     N = 768 against the H100's 232,448), the bits go to a global scratch
//     [B, T, ceil(N/32)] uint32 that the caller allocates (4.7 MB at
//     B = 16): the same words, written by lane 0 of each warp and read by
//     the backtrack after the block's barrier, mostly from L2;
//   * the input rows are loaded CHUNK at a time into registers, the next
//     chunk's loads issued before the current chunk is walked, so the
//     chain does not wait on device memory every row;
//   * rows at or past out_len are never read by the backtrack, so the
//     forward pass stops at out_len;
//   * all threads zero the item's output, then one thread walks the
//     backtrack from shared memory and writes the ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int CHUNK = 16;   // input rows in flight per thread

__device__ __forceinline__ float log_cell(float a) {
  return fmaxf(logf(fmaxf(a, 0.f)), NEG);
}

// attn: [B, T, N] f32; in_lens, out_lens: [B] int32; opt: [B, T, N] f32.
// blockDim.x = 32 * ceil(N / 32), W = ceil(N / 32).  The [T, W] take-left
// bits are dynamic shared memory of T * W words, or with GLOBAL_BITS the
// item's slice of gbits [B, T, W].
template <bool GLOBAL_BITS>
__global__ void mas_kernel(const float* __restrict__ attn, const int* __restrict__ in_lens,
                           const int* __restrict__ out_lens, float* __restrict__ opt,
                           uint32_t* __restrict__ gbits, int T, int N) {
  extern __shared__ uint32_t sbits[];
  __shared__ float edge[2][32];       // each warp's last log_p, by row parity
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j % 32, warp = j / 32;
  const int W = blockDim.x / 32;
  uint32_t* bits = GLOBAL_BITS ? gbits + static_cast<size_t>(b) * T * W : sbits;
  const int in_len = min(max(in_lens[b], 0), N);
  const int out_len = min(max(out_lens[b], 0), T);
  const float* a = attn + static_cast<size_t>(b) * T * N;
  float* o = opt + static_cast<size_t>(b) * T * N;

  // zero the item's output; the backtrack writes its ones after a barrier
  const size_t TN = static_cast<size_t>(T) * N;
  for (size_t k = j; k < TN; k += blockDim.x) o[k] = 0.f;

  const bool col_ok = j < in_len;  // columns >= in_len (and >= N) stay -1e30
  float lp = NEG;
  if (out_len > 0) {
    if (j == 0 && col_ok) lp = log_cell(a[0]);
    if (lane == 31) edge[0][warp] = lp;
  }
  __syncthreads();

  float cur[CHUNK], nxt[CHUNK];
#pragma unroll
  for (int r = 0; r < CHUNK; ++r) {
    const int i = 1 + r;
    cur[r] = (col_ok && i < out_len) ? a[static_cast<size_t>(i) * N + j] : 0.f;
  }
  for (int i0 = 1; i0 < out_len; i0 += CHUNK) {
#pragma unroll
    for (int r = 0; r < CHUNK; ++r) {
      const int i = i0 + CHUNK + r;
      nxt[r] = (col_ok && i < out_len) ? a[static_cast<size_t>(i) * N + j] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < CHUNK; ++r) {
      const int i = i0 + r;
      if (i >= out_len) break;  // uniform across the block
      float left = __shfl_up_sync(0xffffffffu, lp, 1);
      if (lane == 0) left = warp == 0 ? NEG : edge[(i - 1) & 1][warp - 1];
      const bool take_left = left >= lp;
      const float la = col_ok ? log_cell(cur[r]) : NEG;
      lp = la + fmaxf(left, lp);
      const uint32_t word = __ballot_sync(0xffffffffu, take_left);
      if (lane == 0) bits[static_cast<size_t>(i) * W + warp] = word;
      if (lane == 31) edge[i & 1][warp] = lp;
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < CHUNK; ++r) cur[r] = nxt[r];
  }
  __syncthreads();  // output zeroed, bits complete

  if (j == 0 && out_len > 0) {
    int curr = in_len - 1;
    for (int i = out_len - 1; i >= 0 && curr >= 0; --i) {
      o[static_cast<size_t>(i) * N + curr] = 1.f;
      if (i > 0 && ((bits[static_cast<size_t>(i) * W + curr / 32] >> (curr % 32)) & 1u)) --curr;
    }
    o[0] = 1.f;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the kernel needs for T frames, N columns.
size_t mas_shared_bytes(int T, int N) {
  return static_cast<size_t>(T) * ((N + 31) / 32) * sizeof(uint32_t);
}

// attn: [B, T, N] f32 contiguous; in_lens, out_lens: [B] int32; opt: [B, T,
// N] f32, written in full.  1 <= N <= 1024.  With bits == nullptr the
// take-left bits live in shared memory, and mas_shared_bytes(T, N) must fit
// the card's opt-in shared memory per block; else bits is a scratch of
// B * mas_shared_bytes(T, N) bytes on the card.  Returns the first
// cudaError_t (0 on success).
int mas_forward(const void* attn, const void* in_lens, const void* out_lens, void* opt,
                int B, int T, int N, void* bits, void* stream) {
  const int threads = 32 * ((N + 31) / 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits != nullptr) {
    mas_kernel<true><<<B, threads, 0, s>>>(
        static_cast<const float*>(attn), static_cast<const int*>(in_lens),
        static_cast<const int*>(out_lens), static_cast<float*>(opt),
        static_cast<uint32_t*>(bits), T, N);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = mas_shared_bytes(T, N);
  cudaError_t e = cudaFuncSetAttribute(mas_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  mas_kernel<false><<<B, threads, smem, s>>>(
      static_cast<const float*>(attn), static_cast<const int*>(in_lens),
      static_cast<const int*>(out_lens), static_cast<float*>(opt), nullptr, T, N);
  return static_cast<int>(cudaGetLastError());
}

// The card's opt-in shared memory per block, in bytes (0 on error).
int mas_max_shared_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return 0;
  return v;
}

const char* wtv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
