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
// card's f32 ridge (67 TFLOP/s over 3.35 TB/s, about 20).  The design therefore spends its effort on keeping the FMA
// units fed from on-chip memory:
//   * one block owns a (batch item, TT time rows, TO output channels) tile;
//   * for each chunk of KC input channels it stages lrelu(x) for the tile plus
//     its (k-1)*d halo in shared memory ONCE (so the activation is applied
//     once per element, not once per tap), and the chunk's weights for all k
//     taps; the [k, C, C] weight (2.9 MB at k = 11, C = 256) never has to fit
//     on chip, it streams through in [k, KC, TO] slices;
//   * each thread accumulates a 4x4 (time x channel) register tile with f32
//     FMAs over every tap and input channel;
//   * bias and the residual are added in the epilogue, with one write.
// It uses the CUDA cores in f32, as the TPU kernel kept f32 throughout
// (fused_resblock.py:117).  Tensor cores (TF32 or bf16 wgmma) would change
// the numbers, and are later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 16;   // input channels staged per chunk
constexpr int RPT = 4;   // output time rows per thread
constexpr int CPT = 4;   // output channels per thread (one float4)

template <int TO>
struct Tile {
  static constexpr int TX = TO / CPT;       // threads across output channels
  static constexpr int TY = THREADS / TX;   // threads across time
  static constexpr int TT = TY * RPT;       // time rows per block
};

// Shared-memory layout: xs [KC][xs_stride] (channel-major, odd stride so the
// transposed stores do not collide on banks), then ws [k][KC][TO].
// KC * xs_stride is a multiple of 16 floats, so ws stays 16-byte aligned.
__host__ __device__ inline int xs_stride(int tt, int halo) { return (tt + halo) | 1; }

template <int TO>
__global__ void __launch_bounds__(THREADS)
fused_resblock_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int T, int C, int k, int dil, int pad, float slope) {
  using L = Tile<TO>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int halo = (k - 1) * dil;
  const int rows = L::TT + halo;
  const int xstride = xs_stride(L::TT, halo);
  float* xs = smem;
  float* ws = smem + KC * xstride;

  const int tid = threadIdx.x;
  const int tx = tid % L::TX;
  const int ty = tid / L::TX;
  const int o0 = blockIdx.x * TO;
  const int t0 = blockIdx.y * L::TT;
  const float* xb = x + static_cast<size_t>(blockIdx.z) * T * C;
  float* ob = out + static_cast<size_t>(blockIdx.z) * T * C;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    // lrelu(x) for rows t0 - pad .. t0 - pad + rows, channels c0 .. c0 + KC
    for (int e = tid; e < rows * KC; e += THREADS) {
      const int r = e / KC, kk = e % KC;
      const int t = t0 - pad + r, c = c0 + kk;
      float v = 0.f;
      if (t >= 0 && t < T && c < C) {
        v = xb[static_cast<size_t>(t) * C + c];
        v = v >= 0.f ? v : slope * v;
      }
      xs[kk * xstride + r] = v;
    }
    // w[j, c0 + kk, o0 + oo] for every tap j
    for (int e = tid; e < k * KC * TO; e += THREADS) {
      const int oo = e % TO, kk = (e / TO) % KC, j = e / (TO * KC);
      const int c = c0 + kk, o = o0 + oo;
      ws[e] = (c < C && o < C) ? w[(static_cast<size_t>(j) * C + c) * C + o] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < k; ++j) {
      const float* xr = xs + ty * RPT + j * dil;
      const float* wr = ws + j * KC * TO + tx * CPT;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float a[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = xr[kk * xstride + i];
        const float4 wv = *reinterpret_cast<const float4*>(wr + kk * TO);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][0] = fmaf(a[i], wv.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], wv.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], wv.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], wv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = t0 + ty * RPT + i;
    if (t >= T) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int o = o0 + tx * CPT + c;
      if (o < C) {
        const size_t idx = static_cast<size_t>(t) * C + o;
        ob[idx] = acc[i][c] + bias[o] + xb[idx];
      }
    }
  }
}

template <int TO>
cudaError_t launch(const float* x, const float* w, const float* b, float* out,
                   int B, int T, int C, int k, int dil, float slope, cudaStream_t stream) {
  using L = Tile<TO>;
  const int halo = (k - 1) * dil;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(KC) * xs_stride(L::TT, halo) + static_cast<size_t>(k) * KC * TO);
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_resblock_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  dim3 grid((C + TO - 1) / TO, (T + L::TT - 1) / L::TT, B);
  fused_resblock_kernel<TO><<<grid, THREADS, smem, stream>>>(
      x, w, b, out, T, C, k, dil, (k * dil - dil) / 2, slope);
  return cudaGetLastError();
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
  if (C >= 64) return launch<64>(xf, wf, bf, of, B, T, C, k, dilation, slope, s);
  if (C >= 32) return launch<32>(xf, wf, bf, of, B, T, C, k, dilation, slope, s);
  return launch<16>(xf, wf, bf, of, B, T, C, k, dilation, slope, s);
}

const char* wtv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
