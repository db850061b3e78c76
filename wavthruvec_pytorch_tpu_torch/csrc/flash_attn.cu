// Flash attention with segment masking for Hopper (sm_90a): the forward and
// the two backward kernels, for bf16 or f32 q, k, v with f32 accumulation.
// Per (b, h), with s the scores of query row r and key column c:
//
//   s[r, c]  = sm_scale * (q[r] . k[c])            (f32 sums)
//   s[r, c]  = MASK (-0.7 * FLT_MAX)  where seg[r] != seg[c]
//   lse[r]   = log sum_c exp(s[r, c])              (online over key tiles)
//   out[r]   = sum_c round(exp(s[r, c] - m)) v[c] / sum_c exp(s[r, c] - m)
//
// where round() takes the unnormalised probability to the input dtype
// before the product, as the TPU kernel does, and m is the running row
// maximum.  The backward recomputes P = exp(s - lse) and, with
// delta[r] = rowsum(dO[r] * out[r]) (made by the caller):
//
//   dV = round(P)^T dO,  dP = dO v^T,  dS = P * (dP - delta) * sm_scale,
//   dK = round(dS)^T q,  dQ = round(dS) k
//
// all summed in f32; outputs return in the input dtype.  dK/dV run over key
// tiles and dQ over query tiles, so every output element is written by one
// block: deterministic, no atomics.  No score matrix goes to device memory.
//
// Replaces: jax.experimental.pallas.ops.tpu.flash_attention (jax 0.9.0),
// which the JAX package calls at wavthruvec_pytorch_tpu/models/fft_block.py
// :106-134: _flash_attention_impl (pallas_call :758), _flash_attention_bwd_dkv
// (:1121) and _flash_attention_bwd_dq (:1456).  The TPU kernel pads the
// head dim 224 to 256; these take D = 224 as it is (f32 and the bf16 dQ:
// any D <= 256, bf16 D % 16 == 0).
//
// What bounds them on an H100: at T = 3072, D = 224 the products (4 T^2 D
// operations a head forward, 10 T^2 D backward) put them far above the
// byte bound, so operations bound them: 989 TFLOP/s on bf16 tensor cores,
// 67 TFLOP/s for f32 on the CUDA cores.  Three designs:
//
//   * bf16 forward and dK/dV (training; D = 224 only): Hopper's own path.
//     One producer warpgroup streams tiles by TMA (64-byte swizzle, 32-column
//     boxes, so D = 224 needs no padding) into a two-stage ring under
//     mbarriers; two consumer warpgroups run wgmma with f32 accumulators in
//     registers (setmaxnreg moves the producer's registers to them).  The
//     scores' accumulator is the register A operand of the next product, so
//     P and dS never go to shared memory as bf16.  The forward gives each
//     consumer 64 of a block's 128 query rows; dK/dV gives one consumer S,
//     P and dV and the other dP, dS and dK over the same 64 keys, with P
//     passed between them through shared memory, so each product is
//     computed once.  Scores are taken in base 2 (x = s sm_scale log2 e)
//     with the mask at MASK in that domain, still finite.
//   * bf16 dQ: mma.sync m16n8k16 with f32 accumulators, operands from shared
//     memory by ldmatrix (.trans where the operand must be read down its
//     columns).  Each warp owns 16 rows; a product's f32 result tile is in
//     the register layout of the next product's A operand.  Shared rows are
//     padded by 16 bytes, which puts the 8 rows an ldmatrix reads in 8
//     different bank groups.
//   * f32 (serving): f32 FMAs on the CUDA cores, one block of 256 threads
//     per (b, h, tile of rows), each thread holding a 4 x 4 (or 2 x 4) block
//     of scores and a 4 x 16 (or 2 x 16) strip of output rows in registers;
//     shared rows padded to an odd number of words, so 16 threads reading 16
//     rows at one column hit 16 banks.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_D = 256;
constexpr float MASK = -0.7f * FLT_MAX;

// ===========================================================================
// f32: CUDA-core kernels
// ===========================================================================

constexpr int NT = 256;        // threads per block: 16 x 16
constexpr int NC = MAX_D / 16; // output columns per thread: 16 * NC >= D

// Row stride of a shared f32 [rows, D] tile: an odd number of words.
__host__ __device__ __forceinline__ int f32_ld(int D) { return D + 1; }

// Copy rows [r0, r0 + rows) of one head of a [B, T, H, D] tensor (row
// stride H * D) into a shared tile.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int rows, int D,
                                          int ld, size_t row_stride) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, d = idx - r * D;
    dst[r * ld + d] = src[static_cast<size_t>(r0 + r) * row_stride + d];
  }
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// forward: one block per (tile of FQ query rows, b * H + h)
constexpr int FQ = 64, FK = 64;

__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ seg, float* __restrict__ out,
              float* __restrict__ lse, int H, int T_, int D, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = f32_ld(D);
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + FQ * ld;
  float* Vs = Ks + FK * ld;
  float* Ps = Vs + FK * ld;  // [FQ, FK + 1]
  int* segk = reinterpret_cast<int*>(Ps + FQ * (FK + 1));

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * FQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile(Qs, q + base, q0, FQ, D, ld, rs);
  int segq[4];
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    segq[i] = seg[static_cast<size_t>(b) * T_ + q0 + ty + 16 * i];
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T_; k0 += FK) {
    __syncthreads();  // the previous tile's reads are done
    load_tile(Ks, k + base, k0, FK, D, ld, rs);
    load_tile(Vs, v + base, k0, FK, D, ld, rs);
    if (threadIdx.x < FK) segk[threadIdx.x] = seg[static_cast<size_t>(b) * T_ + k0 + threadIdx.x];
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // online softmax; the 16 threads of a row group are 16 lanes of a warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * sm_scale;
        if (segq[i] != segk[tx + 16 * j]) x = MASK;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m[i], group16_max(rmax));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        Ps[(ty + 16 * i) * (FK + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + group16_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < FK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (FK + 1) + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float vv = Vs[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    float* o = out + base + static_cast<size_t>(r) * rs;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) o[d] = acc[i][cc] / l[i];
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * T_ + r] = m[i] + logf(l[i]);
  }
}

// dK, dV: one block per (tile of BK_ key rows, b * H + h), looping over
// query tiles of BQ_ rows
constexpr int BK_ = 32, BQ_ = 64;

__global__ void __launch_bounds__(NT)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ seg,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int T_, int D, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = f32_ld(D);
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK_ * ld;
  float* Qs = Vs + BK_ * ld;
  float* dOs = Qs + BQ_ * ld;
  float* Ps = dOs + BQ_ * ld;  // [BK_, BQ_ + 1]
  float* dSs = Ps + BK_ * (BQ_ + 1);
  float* lse_s = dSs + BK_ * (BQ_ + 1);
  float* delta_s = lse_s + BQ_;
  int* segq = reinterpret_cast<int*>(delta_s + BQ_);

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * BK_;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * D;
  const int tc = threadIdx.x / 16;  // key rows tc, tc + 16
  const int tr = threadIdx.x % 16;  // query columns tr + 16 j; output columns tr + 16 cc

  load_tile(Ks, k + base, k0, BK_, D, ld, rs);
  load_tile(Vs, v + base, k0, BK_, D, ld, rs);
  int segk[2];
  float dK[2][NC], dV[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    segk[i] = seg[static_cast<size_t>(b) * T_ + k0 + tc + 16 * i];
#pragma unroll
    for (int c = 0; c < NC; ++c) dK[i][c] = dV[i][c] = 0.f;
  }

  for (int q0 = 0; q0 < T_; q0 += BQ_) {
    __syncthreads();
    load_tile(Qs, q + base, q0, BQ_, D, ld, rs);
    load_tile(dOs, dout + base, q0, BQ_, D, ld, rs);
    if (threadIdx.x < BQ_) {
      const size_t r = static_cast<size_t>(bh) * T_ + q0 + threadIdx.x;
      lse_s[threadIdx.x] = lse[r];
      delta_s[threadIdx.x] = delta[r];
      segq[threadIdx.x] = seg[static_cast<size_t>(b) * T_ + q0 + threadIdx.x];
    }
    __syncthreads();

    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kk[2], vv[2], qq[4], oo[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kk[i] = Ks[(tc + 16 * i) * ld + d];
        vv[i] = Vs[(tc + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qq[j] = Qs[(tr + 16 * j) * ld + d];
        oo[j] = dOs[(tr + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr + 16 * j;
        float x = s[i][j] * sm_scale;
        if (segk[i] != segq[r]) x = MASK;
        const float p = expf(x - lse_s[r]);
        Ps[(tc + 16 * i) * (BQ_ + 1) + r] = p;
        dSs[(tc + 16 * i) * (BQ_ + 1) + r] = p * (dp[i][j] - delta_s[r]) * sm_scale;
      }
    __syncthreads();

    for (int r = 0; r < BQ_; ++r) {
      float p[2], ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        p[i] = Ps[(tc + 16 * i) * (BQ_ + 1) + r];
        ds[i] = dSs[(tc + 16 * i) * (BQ_ + 1) + r];
      }
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int d = tr + 16 * cc;
        if (d < D) {
          const float o = dOs[r * ld + d];
          const float qv = Qs[r * ld + d];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dV[i][cc] = fmaf(p[i], o, dV[i][cc]);
            dK[i][cc] = fmaf(ds[i], qv, dK[i][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t off = base + static_cast<size_t>(k0 + tc + 16 * i) * rs;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = tr + 16 * cc;
      if (d < D) {
        dk[off + d] = dK[i][cc];
        dv[off + d] = dV[i][cc];
      }
    }
  }
}

// dQ: one block per (tile of QQ query rows, b * H + h), looping over key
// tiles of QK rows
constexpr int QQ = 64, QK = 32;

__global__ void __launch_bounds__(NT)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq, int H, int T_, int D,
                 float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = f32_ld(D);
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + QQ * ld;
  float* Ks = dOs + QQ * ld;
  float* Vs = Ks + QK * ld;
  float* dSs = Vs + QK * ld;  // [QQ, QK + 1]
  int* segk = reinterpret_cast<int*>(dSs + QQ * (QK + 1));

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * QQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile(Qs, q + base, q0, QQ, D, ld, rs);
  load_tile(dOs, dout + base, q0, QQ, D, ld, rs);
  int segq[4];
  float lse_r[4], delta_r[4], dQ[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    segq[i] = seg[static_cast<size_t>(b) * T_ + r];
    lse_r[i] = lse[static_cast<size_t>(bh) * T_ + r];
    delta_r[i] = delta[static_cast<size_t>(bh) * T_ + r];
#pragma unroll
    for (int c = 0; c < NC; ++c) dQ[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T_; k0 += QK) {
    __syncthreads();
    load_tile(Ks, k + base, k0, QK, D, ld, rs);
    load_tile(Vs, v + base, k0, QK, D, ld, rs);
    if (threadIdx.x < QK) segk[threadIdx.x] = seg[static_cast<size_t>(b) * T_ + k0 + threadIdx.x];
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qq[4], oo[4], kk[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qq[i] = Qs[(ty + 16 * i) * ld + d];
        oo[i] = dOs[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kk[j] = Ks[(tx + 16 * j) * ld + d];
        vv[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (segq[i] != segk[c]) x = MASK;
        const float p = expf(x - lse_r[i]);
        dSs[(ty + 16 * i) * (QK + 1) + c] = p * (dp[i][j] - delta_r[i]) * sm_scale;
      }
    __syncthreads();

    for (int c = 0; c < QK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * (QK + 1) + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float kv = Ks[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) dQ[i][cc] = fmaf(ds[i], kv, dQ[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* o = dq + base + static_cast<size_t>(q0 + ty + 16 * i) * rs;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) o[d] = dQ[i][cc];
    }
  }
}

// ===========================================================================
// bf16: shared helpers, and dQ on mma.sync m16n8k16 with f32 accumulators
// ===========================================================================

using bf16 = __nv_bfloat16;
constexpr int NDT = MAX_D / 8;  // 8-column tiles of a full row

// Row stride of a shared bf16 [rows, D] tile: D + 8 elements (16 bytes), so
// the 8 rows an ldmatrix reads start in 8 different 16-byte bank groups.
__host__ __device__ __forceinline__ int bf16_ld(int D) { return D + 8; }

// Copy rows [r0, r0 + rows) of one head into a shared tile, 16 bytes a load
// (D % 8 == 0; rows start 16-byte aligned).
__device__ __forceinline__ void load_tile16(bf16* dst, const bf16* src, int r0, int rows, int D,
                                            int ld, size_t row_stride) {
  const int vpr = D / 8;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += blockDim.x) {
    const int r = idx / vpr, c = (idx - r * vpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * row_stride + c);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A operand (16 x 16, row-major) at rows r0.., columns c0.. of a tile
__device__ __forceinline__ void ld_a(uint32_t a[4], const bf16* tile, int ld, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  const bf16* p = tile + (r0 + lane % 16) * ld + c0 + (lane / 16) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// B operand (16 x 8) whose columns n are tile rows r0..r0+7 and whose k runs
// along them from column c0 (B = rows^T: the key tile for Q K^T)
__device__ __forceinline__ void ld_b(uint32_t& b0, uint32_t& b1, const bf16* tile, int ld, int r0,
                                     int c0) {
  const int lane = threadIdx.x % 32;
  const bf16* p = tile + (r0 + lane % 8) * ld + c0 + ((lane / 8) % 2) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_addr(p)));
}

// B operand (16 x 8) whose k runs down tile rows r0..r0+15 and whose
// columns n are tile columns c0..c0+7 (B = the tile itself: V for P V)
__device__ __forceinline__ void ld_b_t(uint32_t& b0, uint32_t& b1, const bf16* tile, int ld,
                                       int r0, int c0) {
  const int lane = threadIdx.x % 32;
  const bf16* p = tile + (r0 + lane % 16) * ld + c0;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_addr(p)));
}

// c += a b (m16n8k16, bf16 in, f32 accumulate)
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of the 16 columns 16 s.. of a warp's f32 result tiles c (the
// m16n8 accumulator layout of tiles 2s and 2s + 1 is the A layout), rounded
// to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float (*c)[4], int s) {
  a[0] = pack(c[2 * s][0], c[2 * s][1]);
  a[1] = pack(c[2 * s][2], c[2 * s][3]);
  a[2] = pack(c[2 * s + 1][0], c[2 * s + 1][1]);
  a[3] = pack(c[2 * s + 1][2], c[2 * s + 1][3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// In an m16n8 tile, lane l holds rows g = l / 4 and g + 8, columns 2 t and
// 2 t + 1 (t = l % 4): c[0], c[1] in row g, c[2], c[3] in row g + 8.

// ===========================================================================
// bf16 forward and dK/dV on Hopper: TMA, mbarriers, wgmma, warp specialisation
// ===========================================================================
//
// A block is three warpgroups.  Warpgroup 0 is the producer: one thread
// starts every tile load by TMA into a ring of FSTAGES (BSTAGES) stages and
// gives its registers to the consumers (setmaxnreg).  Warpgroups 1 and 2
// consume: wgmma products with f32 accumulators in registers, the scores'
// A operand of the next product rounded to bf16 in registers.  Each stage
// has a full barrier (the producer's expected bytes, completed by TMA) and
// an empty barrier (one arrival per consumer warpgroup once its products on
// the stage are done).  Tiles are [rows, HD] in 32-column boxes with the
// 64-byte swizzle (hopper.cuh).

using hopper::smem_u32;

constexpr int HD = 224;        // the head dim these two kernels take (both FFT stacks)
constexpr int BOX = 32;        // columns of a TMA box: one 64-byte swizzle row
constexpr int WG = 128;        // threads of a warpgroup
constexpr int NACC = HD / 2;   // f32 registers a thread of a 64 x HD accumulator
constexpr int NS = 32;         // f32 registers a thread of a 64 x 64 score tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return static_cast<uint32_t>(rows) * HD * 2;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The wgmma A operand (4 registers) of score columns 16 ks.. of a 64 x 64
// accumulator s: the m64n8 layout of tiles 2 ks and 2 ks + 1, rounded to bf16.
__device__ __forceinline__ void scores_to_a(uint32_t (&a)[4], const float (&s)[NS], int ks) {
  a[0] = pack(s[8 * ks + 0], s[8 * ks + 1]);
  a[1] = pack(s[8 * ks + 2], s[8 * ks + 3]);
  a[2] = pack(s[8 * ks + 4], s[8 * ks + 5]);
  a[3] = pack(s[8 * ks + 6], s[8 * ks + 7]);
}

// acc = A B over k = 0..HD-1: A the 64 rows a0.. of tile ta (ta_rows rows),
// B the 64 rows of tile tb, both K-major.
__device__ __forceinline__ void product_kmajor(float (&acc)[NS], uint32_t ta, int ta_rows, int a0,
                                               uint32_t tb) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16)
    hopper::wgmma_m64n64k16_ss(acc, hopper::kmajor_desc(ta, ta_rows, a0, kk),
                               hopper::kmajor_desc(tb, 64, 0, kk), kk > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

// acc += round(s) B: B the 64 x HD tile tb read N-major (k down its rows).
__device__ __forceinline__ void product_nmajor(float (&acc)[NACC], const float (&s)[NS],
                                               uint32_t tb) {
  uint32_t a[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) scores_to_a(a[ks], s, ks);
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    hopper::wgmma_m64n224k16_rs(acc, a[ks], hopper::nmajor_desc(tb, 64, 16 * ks));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

// Write a 64 x HD f32 accumulator as bf16 rows r0 + 16 w + g (and + 8) of one
// head (row stride rs elements), times `mul0` (`mul1`); rows >= nrows skipped.
__device__ __forceinline__ void store_rows(bf16* base, size_t rs, int r0, int nrows,
                                           const float (&acc)[NACC], float mul0, float mul1) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, w = (threadIdx.x % WG) / 32;
  const int ra = r0 + 16 * w + g, rb = ra + 8;
  bf16* pa = base + static_cast<size_t>(ra) * rs + 2 * t;
  bf16* pb = base + static_cast<size_t>(rb) * rs + 2 * t;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (ra < nrows)
      *reinterpret_cast<uint32_t*>(pa + 8 * n) = pack(acc[4 * n] * mul0, acc[4 * n + 1] * mul0);
    if (rb < nrows)
      *reinterpret_cast<uint32_t*>(pb + 8 * n) = pack(acc[4 * n + 2] * mul1, acc[4 * n + 3] * mul1);
  }
}

// forward: one block per (128 query rows, b * H + h); consumer warpgroup c
// owns rows 64 c..64 c+63; key tiles of FN
constexpr int FM = 128, FN = 64, FSTAGES = 2;
constexpr uint32_t F_Q = 0;
constexpr uint32_t F_K = F_Q + tile_bytes(FM);
constexpr uint32_t F_V = F_K + FSTAGES * tile_bytes(FN);
constexpr uint32_t F_SEG = F_V + FSTAGES * tile_bytes(FN);  // int [FSTAGES][FN]
constexpr uint32_t F_BAR = F_SEG + FSTAGES * FN * 4;        // full_q, full_k[], full_v[], empty[]
constexpr uint32_t F_SMEM = F_BAR + 8 * (1 + 3 * FSTAGES) + 1024;  // + alignment slack

__global__ void __launch_bounds__(3 * WG, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
               bf16* __restrict__ out, float* __restrict__ lse, int H, int T_, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_q = sb + F_BAR;
  auto full_k = [&](int s) { return full_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return full_q + 8 * (1 + FSTAGES + s); };
  auto empty = [&](int s) { return full_q + 8 * (1 + 2 * FSTAGES + s); };

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * FM, nkt = T_ / FN;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < FSTAGES; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty(s), 2);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / WG == 0) {  // producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int row0 = b * T_;
      hopper::mbar_expect_tx(full_q, tile_bytes(FM));
      for (int c = 0; c < HD / BOX; ++c)
        hopper::tma_load_3d(sb + F_Q + c * FM * 64, &tm_q, full_q, c * BOX, h, row0 + q0);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % FSTAGES;
        if (j >= FSTAGES) hopper::mbar_wait(empty(s), (j / FSTAGES - 1) & 1);
        hopper::mbar_expect_tx(full_k(s), tile_bytes(FN) + FN * 4);
        for (int c = 0; c < HD / BOX; ++c)
          hopper::tma_load_3d(sb + F_K + s * tile_bytes(FN) + c * FN * 64, &tm_k, full_k(s),
                              c * BOX, h, row0 + j * FN);
        hopper::bulk_load(sb + F_SEG + s * FN * 4, seg + row0 + j * FN, FN * 4, full_k(s));
        hopper::mbar_expect_tx(full_v(s), tile_bytes(FN));
        for (int c = 0; c < HD / BOX; ++c)
          hopper::tma_load_3d(sb + F_V + s * tile_bytes(FN) + c * FN * 64, &tm_v, full_v(s),
                              c * BOX, h, row0 + j * FN);
      }
    }
  } else {  // consumers
    hopper::setmaxnreg_inc<240>();
    const int cw = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * cw + 16 * (tid / 32) + g, r1 = r0 + 8;
    const int segq0 = r0 < T_ ? seg[static_cast<size_t>(b) * T_ + r0] : -1;
    const int segq1 = r1 < T_ ? seg[static_cast<size_t>(b) * T_ + r1] : -1;
    float o[NACC], sc[NS];
#pragma unroll
    for (int i = 0; i < NACC; ++i) o[i] = 0.f;
    // running row maxima (base-2 scores) and this thread's share of the row sums
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    hopper::mbar_wait(full_q, 0);
    for (int j = 0; j < nkt; ++j) {
      const int s = j % FSTAGES;
      const uint32_t ph = (j / FSTAGES) & 1;
      hopper::mbar_wait(full_k(s), ph);
      product_kmajor(sc, sb + F_Q, FM, 64 * cw, sb + F_K + s * tile_bytes(FN));

      // online softmax in base 2: x = s * sm_scale * log2(e), masked x = MASK
      // (finite, so a tile masked for the whole row gives exp2(0) = 1,
      // which alpha = 0 wipes once a real key arrives)
      const int* segk = reinterpret_cast<const int*>(smem + F_SEG) + s * FN;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < FN / 8; ++n) {
        const int2 sk = *reinterpret_cast<const int2*>(segk + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e] * scale_log2;
          if ((e < 2 ? segq0 : segq1) != ((e & 1) ? sk.y : sk.x)) x = MASK;
          sc[4 * n + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);  // 0 on the first tile
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < FN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sc[4 * n + e] - (e < 2 ? mn0 : mn1));
          sc[4 * n + e] = p;
          if (e < 2) sum0 += p; else sum1 += p;
        }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n] *= al0; o[4 * n + 1] *= al0; o[4 * n + 2] *= al1; o[4 * n + 3] *= al1;
      }

      // O += round(P) V
      hopper::mbar_wait(full_v(s), ph);
      product_nmajor(o, sc, sb + F_V + s * tile_bytes(FN));
      if (tid == 0) hopper::mbar_arrive(empty(s));
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const size_t rs = static_cast<size_t>(H) * HD;
    store_rows(out + static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * HD, rs,
               q0 + 64 * cw, T_, o, 1.f / l0, 1.f / l1);
    if (t == 0) {
      if (r0 < T_) lse[static_cast<size_t>(bh) * T_ + r0] = m0 * LN2 + logf(l0);
      if (r1 < T_) lse[static_cast<size_t>(bh) * T_ + r1] = m1 * LN2 + logf(l1);
    }
  }
}

// dK, dV: one block per (64 keys, b * H + h), looping over query tiles of 64.
// Consumer warpgroup A computes S^T = K Q^T, P^T = exp(S^T - lse) and
// dV += round(P^T) dO; warpgroup B computes dP^T = V dO^T, takes P^T from A
// through shared memory (thread i of B holds the very elements thread i of
// A does), dS^T = P^T (dP^T - delta) sm_scale and dK += round(dS^T) Q.  Each
// of the four products is computed once; each warpgroup holds one 64 x HD
// accumulator.  Named barriers 1-2 (P^T written, by buffer) and 3-4 (P^T
// read) pace the exchange through two buffers.
constexpr int BK = 64, BQ = 64, BSTAGES = 2;
constexpr uint32_t B_K = 0;
constexpr uint32_t B_V = B_K + tile_bytes(BK);
constexpr uint32_t B_Q = B_V + tile_bytes(BK);                 // [BSTAGES]
constexpr uint32_t B_DO = B_Q + BSTAGES * tile_bytes(BQ);       // [BSTAGES]
constexpr uint32_t B_X = B_DO + BSTAGES * tile_bytes(BQ);       // f32 [2][NS][WG]
constexpr uint32_t B_ROWS = B_X + 2 * NS * WG * 4;  // [BSTAGES]: lse, delta f32, seg int [BQ]
constexpr uint32_t B_BAR = B_ROWS + BSTAGES * 3 * BQ * 4;       // full_kv, full[], empty[]
constexpr uint32_t B_SMEM = B_BAR + 8 * (1 + 2 * BSTAGES) + 1024;
constexpr int BAR_P_FULL = 1, BAR_P_FREE = 3;

__global__ void __launch_bounds__(3 * WG, 1)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const int* __restrict__ seg, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   int H, int T_, float scale_log2, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_kv = sb + B_BAR;
  auto full = [&](int s) { return full_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return full_kv + 8 * (1 + BSTAGES + s); };

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * BK, nqt = T_ / BQ;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_kv, 1);
    for (int s = 0; s < BSTAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 2);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / WG == 0) {  // producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int row0 = b * T_;
      hopper::mbar_expect_tx(full_kv, 2 * tile_bytes(BK));
      for (int c = 0; c < HD / BOX; ++c) {
        hopper::tma_load_3d(sb + B_K + c * BK * 64, &tm_k, full_kv, c * BOX, h, row0 + k0);
        hopper::tma_load_3d(sb + B_V + c * BK * 64, &tm_v, full_kv, c * BOX, h, row0 + k0);
      }
      for (int j = 0; j < nqt; ++j) {
        const int s = j % BSTAGES;
        if (j >= BSTAGES) hopper::mbar_wait(empty(s), (j / BSTAGES - 1) & 1);
        hopper::mbar_expect_tx(full(s), 2 * tile_bytes(BQ) + 3 * BQ * 4);
        for (int c = 0; c < HD / BOX; ++c) {
          hopper::tma_load_3d(sb + B_Q + s * tile_bytes(BQ) + c * BQ * 64, &tm_q, full(s),
                              c * BOX, h, row0 + j * BQ);
          hopper::tma_load_3d(sb + B_DO + s * tile_bytes(BQ) + c * BQ * 64, &tm_do, full(s),
                              c * BOX, h, row0 + j * BQ);
        }
        const uint32_t rows = sb + B_ROWS + s * 3 * BQ * 4;
        const size_t r = static_cast<size_t>(bh) * T_ + j * BQ;
        hopper::bulk_load(rows, lse + r, BQ * 4, full(s));
        hopper::bulk_load(rows + BQ * 4, delta + r, BQ * 4, full(s));
        hopper::bulk_load(rows + 2 * BQ * 4, seg + row0 + j * BQ, BQ * 4, full(s));
      }
    }
  } else {  // consumers: A (cw 0) and B (cw 1)
    hopper::setmaxnreg_inc<240>();
    const int cw = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int kr = k0 + 16 * (tid / 32) + g;  // this thread's key rows kr, kr + 8
    const int segk0 = seg[static_cast<size_t>(b) * T_ + kr];
    const int segk1 = seg[static_cast<size_t>(b) * T_ + kr + 8];
    // A: S^T = K Q^T, then dV += P^T dO; B: dP^T = V dO^T, then dK += dS^T Q
    const uint32_t ta = sb + (cw == 0 ? B_K : B_V);
    const uint32_t tb1 = sb + (cw == 0 ? B_Q : B_DO), tb2 = sb + (cw == 0 ? B_DO : B_Q);
    float acc[NACC], sc[NS];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

    hopper::mbar_wait(full_kv, 0);
    for (int j = 0; j < nqt; ++j) {
      const int s = j % BSTAGES;
      hopper::mbar_wait(full(s), (j / BSTAGES) & 1);
      product_kmajor(sc, ta, BK, 0, tb1 + s * tile_bytes(BQ));

      const float* lse_s = reinterpret_cast<const float*>(smem + B_ROWS + s * 3 * BQ * 4);
      const float* delta_s = lse_s + BQ;
      const int* segq = reinterpret_cast<const int*>(lse_s + 2 * BQ);
      float* xbuf = reinterpret_cast<float*>(smem + B_X) + (j & 1) * NS * WG;
      if (cw == 0) {
        // P^T = exp2(s * sm_scale * log2(e) - lse * log2(e)); masked: MASK
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const int c = 8 * n + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
          const int2 sq = *reinterpret_cast<const int2*>(segq + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * n + e] * scale_log2;
            if ((e < 2 ? segk0 : segk1) != ((e & 1) ? sq.y : sq.x)) x = MASK;
            sc[4 * n + e] = ex2(x - ((e & 1) ? l2.y : l2.x) * LOG2E);
          }
        }
        if (j >= 2) hopper::named_sync(BAR_P_FREE + (j & 1), 2 * WG);
#pragma unroll
        for (int i = 0; i < NS; ++i) xbuf[i * WG + tid] = sc[i];
        hopper::named_arrive(BAR_P_FULL + (j & 1), 2 * WG);
      } else {
        hopper::named_sync(BAR_P_FULL + (j & 1), 2 * WG);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * n + e;
            sc[i] = xbuf[i * WG + tid] * (sc[i] - ((e & 1) ? dl.y : dl.x)) * sm_scale;
          }
        }
        if (j < nqt - 2) hopper::named_arrive(BAR_P_FREE + (j & 1), 2 * WG);
      }
      product_nmajor(acc, sc, tb2 + s * tile_bytes(BQ));
      if (tid == 0) hopper::mbar_arrive(empty(s));
    }

    const size_t rs = static_cast<size_t>(H) * HD;
    const size_t head = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * HD;
    store_rows((cw == 0 ? dv : dk) + head, rs, k0, T_, acc, 1.f, 1.f);
  }
}

// dQ: 4 warps x 16 query rows a block, key tiles of MQK
constexpr int MQ = 64, MQK = 32;

__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ seg,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq, int H, int T_, int D,
                  float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = bf16_ld(D);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + MQ * ld;
  bf16* Ks = dOs + MQ * ld;
  bf16* Vs = Ks + MQK * ld;
  int* segk = reinterpret_cast<int*>(Vs + MQK * ld);

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * MQ;
  const size_t rs = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp * 16;

  load_tile16(Qs, q + base, q0, MQ, D, ld, rs);
  load_tile16(dOs, dout + base, q0, MQ, D, ld, rs);
  const size_t r0 = static_cast<size_t>(bh) * T_ + q0 + wr + g;
  const float lse0 = lse[r0], lse1 = lse[r0 + 8], dl0 = delta[r0], dl1 = delta[r0 + 8];
  const int segq0 = seg[static_cast<size_t>(b) * T_ + q0 + wr + g];
  const int segq1 = seg[static_cast<size_t>(b) * T_ + q0 + wr + g + 8];
  float dQ[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) dQ[n][0] = dQ[n][1] = dQ[n][2] = dQ[n][3] = 0.f;

  for (int k0 = 0; k0 < T_; k0 += MQK) {
    __syncthreads();
    load_tile16(Ks, k + base, k0, MQK, D, ld, rs);
    load_tile16(Vs, v + base, k0, MQK, D, ld, rs);
    if (threadIdx.x < MQK) segk[threadIdx.x] = seg[static_cast<size_t>(b) * T_ + k0 + threadIdx.x];
    __syncthreads();

    float s[MQK / 8][4], dp[MQK / 8][4];
#pragma unroll
    for (int n = 0; n < MQK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ao[4];
      ld_a(aq, Qs, ld, wr, kk);
      ld_a(ao, dOs, ld, wr, kk);
#pragma unroll
      for (int n = 0; n < MQK / 8; ++n) {
        uint32_t b0, b1;
        ld_b(b0, b1, Ks, ld, n * 8, kk);
        mma(s[n], aq, b0, b1);
        ld_b(b0, b1, Vs, ld, n * 8, kk);
        mma(dp[n], ao, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < MQK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float x = s[n][e] * sm_scale;
        if ((lo ? segq0 : segq1) != segk[n * 8 + 2 * t + (e & 1)]) x = MASK;
        const float p = expf(x - (lo ? lse0 : lse1));
        dp[n][e] = p * (dp[n][e] - (lo ? dl0 : dl1)) * sm_scale;
      }

    // dQ += round(dS) K
#pragma unroll
    for (int ks = 0; ks < MQK / 16; ++ks) {
      uint32_t a[4];
      acc_to_a(a, dp, ks);
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        if (n * 8 < D) {
          uint32_t b0, b1;
          ld_b_t(b0, b1, Ks, ld, ks * 16, n * 8);
          mma(dQ[n], a, b0, b1);
        }
      }
    }
  }

  bf16* o0 = dq + base + static_cast<size_t>(q0 + wr + g) * rs;
  bf16* o1 = o0 + 8 * rs;
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
    if (n * 8 < D) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(o0 + c) = pack(dQ[n][0], dQ[n][1]);
      *reinterpret_cast<uint32_t*>(o1 + c) = pack(dQ[n][2], dQ[n][3]);
    }
  }
}

// ===========================================================================
// launches
// ===========================================================================

bool shape_ok(int B, int H, int T, int D, int is_bf16) {
  return B > 0 && H > 0 && T > 0 && T % 64 == 0 && D > 0 && D <= MAX_D &&
         (!is_bf16 || D % 16 == 0);
}

// Set the kernel's dynamic shared memory, launch it, and return the first
// error.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, stream>>>(static_cast<Params>(args)...);
  return static_cast<int>(cudaGetLastError());
}

// Errors of cuTensorMapEncodeTiled are returned as TMAP_ERROR + its CUresult.
constexpr int TMAP_ERROR = 100000;

// A TMA map of one [B, T, H, HD] bf16 tensor as {HD, H, B * T}: boxes of
// BOX columns x 1 head x box_rows rows, 64-byte swizzle.  Returns 0 or an
// error code.
int bf16_map(CUtensorMap* map, const void* ptr, int B, int H, int T, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return TMAP_ERROR + CUDA_ERROR_NOT_FOUND;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B) * T};
  const cuuint64_t strides[2] = {HD * sizeof(bf16), static_cast<cuuint64_t>(H) * HD * sizeof(bf16)};
  const cuuint32_t box[3] = {BOX, 1, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERROR + static_cast<int>(r);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// All tensors contiguous: q, k, v, out, dout, dq, dk, dv [B, T, H, D] in
// bf16 (is_bf16 = 1) or f32; seg [B, T] int32 (keys and queries attend
// where their ids are equal); lse, delta [B, H, T] f32.  T % 64 == 0 and
// D <= 256; in bf16 the forward and dK/dV take D = 224 only (HD) and every
// pointer 16-byte aligned, dQ any D % 16 == 0.  Each returns the first
// cudaError_t (0 on success), cudaErrorInvalidValue for a shape it does not
// take, or TMAP_ERROR + the CUresult of a failed tensor-map encode.

int flash_fwd(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse,
              int B, int H, int T, int D, float sm_scale, int is_bf16, void* stream) {
  if (!shape_ok(B, H, T, D, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D != HD) return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned16(seg)) return static_cast<int>(cudaErrorMisalignedAddress);
    CUtensorMap mq, mk, mv;
    int e;
    if ((e = bf16_map(&mq, q, B, H, T, FM)) || (e = bf16_map(&mk, k, B, H, T, FN)) ||
        (e = bf16_map(&mv, v, B, H, T, FN)))
      return e;
    return launch(flash_fwd_bf16, dim3((T + FM - 1) / FM, B * H), 3 * WG, F_SMEM, s, mq, mk, mv,
                  seg, out, lse, H, T, sm_scale * LOG2E);
  }
  const size_t smem = (FQ + 2 * FK) * f32_ld(D) * sizeof(float) +
                      FQ * (FK + 1) * sizeof(float) + FK * sizeof(int);
  return launch(flash_fwd_f32, dim3(T / FQ, B * H), NT, smem, s, q, k, v, seg, out, lse, H, T, D,
                sm_scale);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* seg, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int B, int H, int T,
                  int D, float sm_scale, int is_bf16, void* stream) {
  if (!shape_ok(B, H, T, D, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D != HD) return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned16(seg) || !aligned16(lse) || !aligned16(delta))
      return static_cast<int>(cudaErrorMisalignedAddress);
    CUtensorMap mq, mk, mv, mdo;
    int e;
    if ((e = bf16_map(&mq, q, B, H, T, BQ)) || (e = bf16_map(&mk, k, B, H, T, BK)) ||
        (e = bf16_map(&mv, v, B, H, T, BK)) || (e = bf16_map(&mdo, dout, B, H, T, BQ)))
      return e;
    return launch(flash_bwd_dkv_bf16, dim3(T / BK, B * H), 3 * WG, B_SMEM, s, mq, mk, mv, mdo, seg,
                  lse, delta, dk, dv, H, T, sm_scale * LOG2E, sm_scale);
  }
  const size_t smem = (2 * BK_ + 2 * BQ_) * f32_ld(D) * sizeof(float) +
                      (2 * BK_ * (BQ_ + 1) + 2 * BQ_) * sizeof(float) + BQ_ * sizeof(int);
  return launch(flash_bwd_dkv_f32, dim3(T / BK_, B * H), NT, smem, s, q, k, v, seg, dout, lse,
                delta, dk, dv, H, T, D, sm_scale);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* seg, const void* dout,
                 const void* lse, const void* delta, void* dq, int B, int H, int T, int D,
                 float sm_scale, int is_bf16, void* stream) {
  if (!shape_ok(B, H, T, D, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const size_t smem = (2 * MQ + 2 * MQK) * bf16_ld(D) * sizeof(bf16) + MQK * sizeof(int);
    return launch(flash_bwd_dq_bf16, dim3(T / MQ, B * H), 128, smem, s, q, k, v, seg, dout, lse,
                  delta, dq, H, T, D, sm_scale);
  }
  const size_t smem = (2 * QQ + 2 * QK) * f32_ld(D) * sizeof(float) +
                      QQ * (QK + 1) * sizeof(float) + QK * sizeof(int);
  return launch(flash_bwd_dq_f32, dim3(T / QQ, B * H), NT, smem, s, q, k, v, seg, dout, lse,
                delta, dq, H, T, D, sm_scale);
}

const char* wtv_error_string(int err) {
  if (err >= TMAP_ERROR) {
    static char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed: CUresult %d", err - TMAP_ERROR);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
