// Fused HiFi-GAN ResBlock2 unit for Hopper (sm_90a), f32:
//
//   out[b,t,o] = x[b,t,o] + bias[o]
//              + sum_j sum_i w[j,i,o] * lrelu(x[b, t + j*d - pad, i])
//
// with zeros outside [0, T) and pad = (k*d - d) / 2.
//
// Replaces: wavthruvec_pytorch_tpu/ops/fused_resblock.py, fused_conv_residual
// (Pallas kernel _kernel), which the JAX Generator(fused=True) runs for every
// ResBlock2 unit.  Unlike that kernel (C % 128 == 0, T % 8 == 0) this one
// takes every Generator width (256 down to 16), any T and any odd k.
//
// What bounds it on an H100: operations.  A unit does 2*k*C^2*T*B flops and
// moves about 2*B*T*C*4 + k*C*C*4 bytes; at C = 256, k = 11 and B = 1 over
// 512 latent frames (T = 2560) that is 455 flops per byte, far above the
// ridge.  The TPU kernel keeps f32 throughout (fused_resblock.py:117), so the
// kernel keeps f32 accuracy, on the tensor cores: 3xTF32 (hopper.cuh), three
// TF32 products a product, 165 TFLOP/s of f32-accurate work against the CUDA
// cores' 67.  (At C = 16 and 32 the unit is close to its byte bound.)
//
// Design: an implicit GEMM per unit, M = time rows, N = output channels,
// K = k taps x C input channels.
//   * one block (8 warps) owns a (batch item, 128 time rows, TN output
//     channels) tile, two blocks an SM: TN = 32 at every width above 16,
//     16 at 16.  A same-run reading of four tiles at the 30 units of a
//     512-frame forward (tools/fused_variants.py) put 32 channels ahead
//     of 64 at C = 128 and 64 (more blocks, two an SM) and within 4% of
//     the best at C = 256;
//   * for each chunk of KC = 16 input channels, cp.async brings x for the
//     tile plus its (k-1)*d halo and the chunk's weights for all k taps
//     ([k, 16, TN]: the [k, C, C] weight, 2.9 MB at k = 11, C = 256, never
//     fits on chip) into a double buffer, the next chunk's copy running
//     under this chunk's products;
//   * lrelu is applied once per element, in place, when a chunk lands;
//     every tap then reads the same x tile at its own row offset j*d, and
//     both operands are split into hi and lo in registers as their fragments
//     load (hi and lo tiles in shared memory would double the bytes read);
//   * each chunk's products go to fresh accumulators that are added to the
//     total in f32 after it: the tensor cores' adds truncate, and their error
//     grows with the size of the sum they add into and the number of adds;
//   * mma.sync m16n8k8, as the f32 flash forward: wgmma reads a TF32 B
//     operand only K-major from shared memory (w would need a transposed
//     copy), 3xTF32 would need its hi and lo tiles both there, and an A tile
//     in shared memory would have to start on an 8-row core matrix, which a
//     tap's shift j*d is not; mma.sync takes both fragments from registers,
//     from any row, split as they load.  The shared rows are padded (x: 20
//     words, w: TN + 8) so each fragment load of a warp hits 32 banks; at
//     TN = 32 the taps of the Generator's kernel sizes (3, 7, 11) are fixed
//     when compiled, so their loops unroll (7% on the 30 units in that
//     reading); at TN = 16 and for any other k they are taken at run time
//     (5% ahead of fixed taps at C = 16);
//   * bias and the residual are added in the epilogue, with one write.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::mma_3xtf32;
using hopper::smem_u32;
using hopper::split_tf32;

constexpr int THREADS = 256;  // 8 warps
constexpr int KC = 16;        // input channels a chunk
constexpr int XSTR = KC + 4;  // words a row of x: a fragment's 8 rows x 4 columns hit 32 banks

template <int TN>
__host__ __device__ constexpr int wstride() { return TN + 8; }  // 8 k-rows x 8 columns: 32 banks

// bytes of shared memory: x [2][rows][XSTR], weights [2][k][KC][TN + 8]
template <int TN>
size_t smem_bytes(int rows, int k) {
  return sizeof(float) * 2 * (static_cast<size_t>(rows) * XSTR +
                              static_cast<size_t>(k) * KC * wstride<TN>());
}

// TM x TN block tile, WM x WN warp tile (TM / WM * TN / WN = 8 warps), MINB
// blocks an SM; KT taps fixed when compiled (the tap loops unroll), or 0: k
// at run time
template <int TM, int TN, int WM, int WN, int MINB, int KT>
__global__ void __launch_bounds__(THREADS, MINB)
fused_resblock_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int T, int C, int k_run, int dil, int pad, float slope, int vec) {
  const int k = KT > 0 ? KT : k_run;
  constexpr int WGN = TN / WN;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int WS = wstride<TN>();
  static_assert((TM / WM) * WGN == THREADS / 32, "8 warps a block");
  extern __shared__ __align__(16) float smem[];
  const int rows = TM + (k - 1) * dil;
  float* xsm = smem;                   // [2][rows][XSTR]
  float* ws = smem + 2 * rows * XSTR;  // [2][k][KC][WS]
  const int wsize = k * KC * WS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm0 = (warp / WGN) * WM, wn0 = (warp % WGN) * WN;
  const int o0 = blockIdx.x * TN, t0 = blockIdx.y * TM;
  const float* xb = x + static_cast<size_t>(blockIdx.z) * T * C;
  float* ob = out + static_cast<size_t>(blockIdx.z) * T * C;
  const size_t tap = static_cast<size_t>(C) * C;

  // x rows t0 - pad .. t0 - pad + rows and w[:, c0 .. c0 + KC, o0 .. o0 + TN]
  // into stage s, zeros outside the tensors
  auto load = [&](int c0, int s) {
    float* xd = xsm + s * rows * XSTR;
    float* wd = ws + s * wsize;
    if (vec) {  // C % 4 == 0 and 16-byte aligned rows: 4 floats a copy
      for (int i = tid; i < rows * (KC / 4); i += THREADS) {
        const int r = i / (KC / 4), cc = (i % (KC / 4)) * 4, t = t0 - pad + r;
        const bool in = t >= 0 && t < T && c0 + cc < C;
        cp_async16(smem_u32(xd + r * XSTR + cc), in ? xb + static_cast<size_t>(t) * C + c0 + cc : xb,
                   in ? 16u : 0u);
      }
      for (int i = tid; i < KC * (TN / 4); i += THREADS) {
        const int kk = i / (TN / 4), oo = (i % (TN / 4)) * 4;
        const bool in = c0 + kk < C && o0 + oo < C;
        const float* src = in ? w + static_cast<size_t>(c0 + kk) * C + o0 + oo : w;
        float* dst = wd + kk * WS + oo;
#pragma unroll
        for (int j = 0; j < k; ++j)
          cp_async16(smem_u32(dst + j * KC * WS), in ? src + j * tap : w, in ? 16u : 0u);
      }
    } else {  // one float a copy
      for (int i = tid; i < rows * KC; i += THREADS) {
        const int r = i / KC, cc = i % KC, t = t0 - pad + r;
        const bool in = t >= 0 && t < T && c0 + cc < C;
        cp_async4(smem_u32(xd + r * XSTR + cc), in ? xb + static_cast<size_t>(t) * C + c0 + cc : xb,
                  in ? 4u : 0u);
      }
      for (int i = tid; i < KC * TN; i += THREADS) {
        const int kk = i / TN, oo = i % TN;
        const bool in = c0 + kk < C && o0 + oo < C;
        const float* src = in ? w + static_cast<size_t>(c0 + kk) * C + o0 + oo : w;
        float* dst = wd + kk * WS + oo;
#pragma unroll
        for (int j = 0; j < k; ++j)
          cp_async4(smem_u32(dst + j * KC * WS), in ? src + j * tap : w, in ? 4u : 0u);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

  const int chunks = (C + KC - 1) / KC;
  load(0, 0);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    const int s = ci & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ci is in; every warp is done with chunk ci - 1
    if (ci + 1 < chunks) {
      load((ci + 1) * KC, s ^ 1);
      cp_async_commit();
    }
    float* xs = xsm + s * rows * XSTR;
    for (int i = tid; i < rows * KC; i += THREADS) {
      float& v = xs[(i / KC) * XSTR + i % KC];
      v = v >= 0.f ? v : slope * v;
    }
    __syncthreads();

    float part[MT][NT][4];  // this chunk's sum
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        part[m][n][0] = part[m][n][1] = part[m][n][2] = part[m][n][3] = 0.f;
    const float* wsc = ws + s * wsize;
#pragma unroll
    for (int j = 0; j < k; ++j) {
      const float* xa = xs + (wm0 + j * dil + g) * XSTR + tq;
      const float* wj = wsc + j * KC * WS + wn0 + g;
#pragma unroll
      for (int k8 = 0; k8 < KC; k8 += 8) {
        uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int o = m * 16 * XSTR + k8;
          split_tf32(xa[o], a_hi[m][0], a_lo[m][0]);
          split_tf32(xa[o + 8 * XSTR], a_hi[m][1], a_lo[m][1]);
          split_tf32(xa[o + 4], a_hi[m][2], a_lo[m][2]);
          split_tf32(xa[o + 8 * XSTR + 4], a_hi[m][3], a_lo[m][3]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(wj[(k8 + tq) * WS + n * 8], bh0, bl0);
          split_tf32(wj[(k8 + tq + 4) * WS + n * 8], bh1, bl1);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_3xtf32(part[m][n], a_hi[m], a_lo[m], bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm0 + m * 16 + g + 8 * h;
      if (t >= T) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn0 + n * 8 + 2 * tq + e;
          if (o < C) {
            const size_t idx = static_cast<size_t>(t) * C + o;
            ob[idx] = acc[m][n][2 * h + e] + bias[o] + xb[idx];
          }
        }
    }
}

template <int TM, int TN, int WM, int WN, int MINB, int KT>
cudaError_t launch_k(const float* x, const float* w, const float* b, float* out,
                     int B, int T, int C, int k, int dil, float slope, int vec,
                     cudaStream_t stream) {
  const size_t smem = smem_bytes<TN>(TM + (k - 1) * dil, k);
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_resblock_kernel<TM, TN, WM, WN, MINB, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  dim3 grid((C + TN - 1) / TN, (T + TM - 1) / TM, B);
  fused_resblock_kernel<TM, TN, WM, WN, MINB, KT><<<grid, THREADS, smem, stream>>>(
      x, w, b, out, T, C, k, dil, (k * dil - dil) / 2, slope, vec);
  return cudaGetLastError();
}

// the Generator's kernel sizes (3, 7, 11) with their taps unrolled; any
// other odd k with k at run time
cudaError_t launch_tn32(const float* x, const float* w, const float* b, float* out,
                        int B, int T, int C, int k, int dil, float slope, int vec,
                        cudaStream_t stream) {
  switch (k) {
    case 3: return launch_k<128, 32, 32, 16, 2, 3>(x, w, b, out, B, T, C, k, dil, slope, vec, stream);
    case 7: return launch_k<128, 32, 32, 16, 2, 7>(x, w, b, out, B, T, C, k, dil, slope, vec, stream);
    case 11:
      return launch_k<128, 32, 32, 16, 2, 11>(x, w, b, out, B, T, C, k, dil, slope, vec, stream);
    default:
      return launch_k<128, 32, 32, 16, 2, 0>(x, w, b, out, B, T, C, k, dil, slope, vec, stream);
  }
}

}  // namespace

extern "C" {

// x, out: [B, T, C] f32 contiguous; w: [k, C, C] f32 contiguous (tap, in,
// out); b: [C] f32.  k must be odd so the output keeps length T.
// Returns the cudaError_t of the launch (0 on success).
int fused_resblock_forward(const void* x, const void* w, const void* b, void* out,
                           int B, int T, int C, int k, int dilation, float slope,
                           void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = C % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  if (C > 16)
    return static_cast<int>(launch_tn32(xf, wf, bf, of, B, T, C, k, dilation, slope, vec, s));
  return static_cast<int>(
      launch_k<128, 16, 16, 16, 2, 0>(xf, wf, bf, of, B, T, C, k, dilation, slope, vec, s));
}

const char* wtv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
