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
// (:1121) and _flash_attention_bwd_dq (:1456).  The JAX package zero-pads a
// head dim above 128 to a multiple of 128 for it (224 -> 256) and so takes
// any head dim.  Here every kernel is a template on the head dim HD, built
// for HD = 64, 128, 224 and 256 (a multiple of 32: a TMA box is 32 columns,
// a wgmma k-step 16; the f32 backward splits dQ's columns in halves of
// 8-column tiles); past 256 the wide kernels (below) take any multiple of
// 64.  The wrapper zero-pads any other D to the next width, which is exact
// (padded columns add 0 to every q.k; padded v columns give output columns
// that are dropped).
//
// What bounds them on an H100: at T = 3072, D = 224 the products (4 T^2 D
// operations a head forward, 10 T^2 D backward) put them far above the
// byte bound, so operations bound them: 989 TFLOP/s on bf16 tensor cores;
// for f32, three TF32 products per product (below) at 495 TFLOP/s, i.e.
// 165 TFLOP/s of f32-accurate work.  Two designs:
//
//   * bf16 (training), all three kernels: Hopper's own path.  One producer
//     warpgroup streams tiles by TMA (64-byte swizzle, 32-column boxes) into
//     a two-stage ring under mbarriers; two consumer warpgroups run wgmma
//     with f32 accumulators in registers (setmaxnreg moves the producer's
//     registers to them).  The scores' accumulator is the register A operand
//     of the next product, so P and dS never go to shared memory as bf16.
//     The forward and dQ give each consumer 64 of a block's 128 query rows;
//     dK/dV gives one consumer S, P and dV and the other dP, dS and dK over
//     the same 64 keys, with P passed between them through shared memory, so
//     each product is computed once.  Scores are taken in base 2
//     (x = s sm_scale log2 e) with the mask at MASK in that domain, still
//     finite.
//   * f32 forward (serving) and f32 backward (f32 training): 3xTF32 on the
//     tensor cores with mma.sync, operands split in registers (below).  The
//     backward pairs warps as the bf16 dK/dV does, so each product is
//     computed once, and streams its tiles by cp.async.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::mma_3xtf32;
using hopper::smem_u32;
using hopper::split_tf32;

constexpr int MAX_D = 256;
constexpr uint32_t SMEM_MAX = 232448;  // dynamic shared memory a block may opt into
constexpr float MASK = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// In an m16n8 (mma.sync) or m64n8 (wgmma, per warp: rows 16 w..) accumulator
// tile, lane l holds rows g = l / 4 and g + 8, columns 2 t and 2 t + 1
// (t = l % 4): c[0], c[1] in row g, c[2], c[3] in row g + 8.

// ===========================================================================
// f32 forward: 3xTF32 on the tensor cores (mma.sync m16n8k8)
// ===========================================================================
//
// One TF32 product keeps 10 mantissa bits, ~1e-3 of a logit at D = 224.  So
// each operand x is split into hi = x with its low 13 mantissa bits cleared
// (a TF32 value) and lo = x - hi (exact in f32; the tensor core reads its top
// 19 bits), and a product is summed as lo_a hi_b + hi_a lo_b + hi_a hi_b in
// f32 (CUTLASS's OpMultiplyAddFastF32 scheme): about 2^-20 of each term, f32
// accuracy at three times TF32's work.  Both S = Q K^T and O += P V.
//
// Route: mma.sync rather than wgmma.  wgmma reads .tf32 operands from shared
// memory K-major only (V would need a transposed copy), and hi and lo tiles
// of Q, K and V would all have to sit in shared memory, which leaves no room
// for a ring at D = 224.  mma.sync takes its fragments from registers: each
// is read once from an f32 tile and split there, and P stays in registers
// as the A operand of P V.  The m16n8 accumulator holds keys 2 t, 2 t + 1
// where the m16n8k8 A operand wants columns t, t + 4, so the P V sum runs
// over the 8 keys of a tile in the order (0, 2, 4, 6, 1, 3, 5, 7): A column
// t is key 2 t, column t + 4 key 2 t + 1, and V's fragment rows follow.
//
// A block is 8 warps, each owning 16 query rows (128 a block); K and V
// tiles of 32 keys, one buffer each, loaded by cp.async so that K's next
// tile streams during the softmax and P V, and V's during the next S.
// Shared rows are HD + 4 words (4 mod 32), so each fragment load of a warp
// hits 32 banks.  Q, K, V: 175 KB at HD = 224, one block an SM.  At
// serving's B H = 2 the query tiles alone are 12 (T = 768) or 48
// (T = 3072) blocks for 132 SMs, so the wrapper splits the keys over
// blockIdx.z: each split writes its unnormalised O and (m, l) rows, and a
// second kernel merges them (exact up to the sums' order).

constexpr int XQ = 128;  // query rows a block
constexpr int XK = 32;   // keys a tile
constexpr int XT = 256;  // threads a block: 8 warps

template <int HD>
constexpr size_t x_smem() {
  return static_cast<size_t>(XQ + 2 * XK) * (HD + 4) * sizeof(float);
}

// Start copying rows [r0, r0 + rows) of one head (row stride rs floats) into
// a shared [rows, HD + 4] tile; rows at or past `limit` are zero-filled.
template <int HD>
__device__ __forceinline__ void x_load(float* dst, const float* src, int r0, int rows, int limit,
                                       size_t rs) {
  constexpr int CPR = HD / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CPR; i += XT) {
    const int r = i / CPR, c = (i - r * CPR) * 4;
    const bool in = r0 + r < limit;
    cp_async16(smem_u32(dst + r * (HD + 4) + c), src + static_cast<size_t>(in ? r0 + r : 0) * rs + c,
               in ? 16u : 0u);
  }
}

// forward: one block per (128 query rows, b * H + h, split of the key
// tiles); part_o / part_ml (null without a split): the split's unnormalised
// output rows [split][B H][T][HD] and (m, l) [split][B H][T][2]
template <int HD>
__global__ void __launch_bounds__(XT, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ seg, float* __restrict__ out,
              float* __restrict__ lse, float* __restrict__ part_o, float* __restrict__ part_ml,
              int H, int T_, int tiles_per_split, float scale_log2) {
  constexpr int LD = HD + 4, NO = HD / 8;
  extern __shared__ __align__(16) float xs[];
  float* Qs = xs;
  float* Ks = Qs + XQ * LD;
  float* Vs = Ks + XK * LD;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * XQ;
  const int kt0 = blockIdx.z * tiles_per_split, kt1 = min(T_ / XK, kt0 + tiles_per_split);
  const size_t rs = static_cast<size_t>(H) * HD;
  const size_t head = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ra = q0 + 16 * warp + g, rb = ra + 8;  // this thread's two query rows
  const int* segb = seg + static_cast<size_t>(b) * T_;
  const int sqa = ra < T_ ? segb[ra] : -1, sqb = rb < T_ ? segb[rb] : -1;

  x_load<HD>(Qs, q + head, q0, XQ, T_, rs);
  cp_async_commit();
  x_load<HD>(Ks, k + head, kt0 * XK, XK, T_, rs);
  cp_async_commit();
  x_load<HD>(Vs, v + head, kt0 * XK, XK, T_, rs);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running row maxima (base-2 scores) and this thread's share of the row sums
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  const float* qa = Qs + (16 * warp + g) * LD + t;

  for (int j = kt0; j < kt1; ++j) {
    int2 sk[XK / 8];  // segment ids of keys 8 n + 2 t, + 1
#pragma unroll
    for (int n = 0; n < XK / 8; ++n)
      sk[n] = *reinterpret_cast<const int2*>(segb + j * XK + 8 * n + 2 * t);
    cp_async_wait<1>();  // all but the newest group (V_j): Q and K_j are in
    __syncthreads();

    // S = Q K^T
    float s[XK / 8][4];
#pragma unroll
    for (int n = 0; n < XK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t ah[4], al[4];
      split_tf32(qa[kk], ah[0], al[0]);
      split_tf32(qa[kk + 8 * LD], ah[1], al[1]);
      split_tf32(qa[kk + 4], ah[2], al[2]);
      split_tf32(qa[kk + 8 * LD + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < XK / 8; ++n) {
        const float* kb = Ks + (8 * n + g) * LD + kk + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kb[0], bh0, bl0);
        split_tf32(kb[4], bh1, bl1);
        mma_3xtf32(s[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();  // every warp is done with K_j
    if (j + 1 < kt1) x_load<HD>(Ks, k + head, (j + 1) * XK, XK, T_, rs);
    cp_async_commit();

    // online softmax in base 2, masked scores at MASK (as the bf16 forward)
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int n = 0; n < XK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if ((e < 2 ? sqa : sqb) != ((e & 1) ? sk[n].y : sk[n].x)) x = MASK;
        s[n][e] = x;
        if (e < 2) mxa = fmaxf(mxa, x); else mxb = fmaxf(mxb, x);
      }
    const float mna = fmaxf(ma, quad_max(mxa)), mnb = fmaxf(mb, quad_max(mxb));
    const float ala = ex2(ma - mna), alb = ex2(mb - mnb);  // 0 on the first tile
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int n = 0; n < XK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[n][e] - (e < 2 ? mna : mnb));
        s[n][e] = p;
        if (e < 2) suma += p; else sumb += p;
      }
    la = la * ala + suma;
    lb = lb * alb + sumb;
    ma = mna;
    mb = mnb;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= ala; o[n][1] *= ala; o[n][2] *= alb; o[n][3] *= alb;
    }

    cp_async_wait<1>();  // all but K_{j+1}: V_j is in
    __syncthreads();
    // O += P V over the keys of each 8-key step in the order (0, 2, 4, 6, 1, 3, 5, 7)
#pragma unroll
    for (int ks = 0; ks < XK / 8; ++ks) {
      uint32_t ph[4], pl[4];
      split_tf32(s[ks][0], ph[0], pl[0]);
      split_tf32(s[ks][2], ph[1], pl[1]);
      split_tf32(s[ks][1], ph[2], pl[2]);
      split_tf32(s[ks][3], ph[3], pl[3]);
      const float* vb = Vs + (8 * ks + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vb[8 * n], bh0, bl0);
        split_tf32(vb[LD + 8 * n], bh1, bl1);
        mma_3xtf32(o[n], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();  // every warp is done with V_j
    if (j + 1 < kt1) x_load<HD>(Vs, v + head, (j + 1) * XK, XK, T_, rs);
    cp_async_commit();
  }
  cp_async_wait<0>();

  la = quad_sum(la);
  lb = quad_sum(lb);
  if (part_o == nullptr) {
    const float ia = 1.f / la, ib = 1.f / lb;
    float* pa = out + head + static_cast<size_t>(ra) * rs + 2 * t;
    float* pb = out + head + static_cast<size_t>(rb) * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (ra < T_) *reinterpret_cast<float2*>(pa + 8 * n) = make_float2(o[n][0] * ia, o[n][1] * ia);
      if (rb < T_) *reinterpret_cast<float2*>(pb + 8 * n) = make_float2(o[n][2] * ib, o[n][3] * ib);
    }
    if (t == 0) {
      if (ra < T_) lse[static_cast<size_t>(bh) * T_ + ra] = ma * LN2 + logf(la);
      if (rb < T_) lse[static_cast<size_t>(bh) * T_ + rb] = mb * LN2 + logf(lb);
    }
  } else {
    const size_t row = (static_cast<size_t>(blockIdx.z) * gridDim.y + bh) * T_;
    float* pa = part_o + (row + ra) * HD + 2 * t;
    float* pb = part_o + (row + rb) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (ra < T_) *reinterpret_cast<float2*>(pa + 8 * n) = make_float2(o[n][0], o[n][1]);
      if (rb < T_) *reinterpret_cast<float2*>(pb + 8 * n) = make_float2(o[n][2], o[n][3]);
    }
    if (t == 0) {
      if (ra < T_) *reinterpret_cast<float2*>(part_ml + 2 * (row + ra)) = make_float2(ma, la);
      if (rb < T_) *reinterpret_cast<float2*>(part_ml + 2 * (row + rb)) = make_float2(mb, lb);
    }
  }
}

// Merge the key splits of the f32 forward: one warp per query row (8 a
// block); lane s < nsplit weighs split s by exp2(m_s - M), M the largest m.
__global__ void __launch_bounds__(256)
flash_fwd_f32_merge(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                    float* __restrict__ out, float* __restrict__ lse, int H, int T_, int HD,
                    int nsplit) {
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, BH = gridDim.y;
  const int r = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= T_) return;
  const size_t row = static_cast<size_t>(lane) * BH * T_ + static_cast<size_t>(bh) * T_ + r;
  float2 ml = make_float2(-INFINITY, 0.f);
  if (lane < nsplit) ml = *reinterpret_cast<const float2*>(part_ml + 2 * row);
  float M = ml.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  const float w = lane < nsplit ? ex2(ml.x - M) : 0.f;
  float L = w * ml.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
  const float inv = 1.f / L;
  float* o = out + (static_cast<size_t>(b) * T_ + r) * H * HD + static_cast<size_t>(h) * HD;
  for (int c = lane; c < HD; c += 32) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s)
      acc += __shfl_sync(0xffffffffu, w, s) *
             part_o[((static_cast<size_t>(s) * BH + bh) * T_ + r) * HD + c];
    o[c] = acc * inv;
  }
  if (lane == 0) lse[static_cast<size_t>(bh) * T_ + r] = M * LN2 + logf(L);
}

// ===========================================================================
// f32 backward: 3xTF32 on the tensor cores (mma.sync m16n8k8)
// ===========================================================================
//
// Both kernels take the forward's operand scheme: each A and B fragment is
// read once from an f32 shared tile (rows of HD + 4 words, so each fragment
// load of a warp hits 32 banks) and split into TF32 hi and lo in registers;
// a tile of P or dS that feeds the next product stays in registers as its A
// operand, the 8 columns of each k-step summed in the order (0, 2, 4, 6, 1,
// 3, 5, 7) with the B operand's rows in that order.  Scores are in base 2
// (x = s sm_scale log2 e, P = exp2(x - lse log2 e)) with masked scores at
// MASK.  The second product of a tile (dV, dK or dQ) sums over the tile's 16
// rows into fresh registers, which are added to the running sum on the CUDA
// cores: the tensor cores' adds truncate, and the running sums run over up
// to T = 3072 rows.
//
// A block is 8 warps: 4 pairs over 16 rows each.  The two warps of a pair
// split the products, so each is computed once and a thread holds one
// accumulator of 16 rows:
//
//   dK/dV: one block per (64 keys, b * H + h), keys as the M rows.  K and V
//     stay in shared memory; Q, dO and their lse, delta and segment ids
//     stream in tiles of 16 queries through a two-stage cp.async ring.
//     Warp 0 of a pair computes S^T = K Q^T, P^T and dV += P^T dO; warp 1
//     computes dP^T = V dO^T, takes P^T through shared memory (lane i of one
//     holds the very elements lane i of the other does), dS^T = P^T (dP^T -
//     delta) sm_scale and dK += dS^T Q.  Q and dO rows are read as the
//     forward reads K in the first product and as it reads V in the second.
//   dQ: one block per (64 queries, b * H + h), queries as the M rows, the
//     forward's own layout.  Q and dO stay in shared memory; K, V and the key
//     segment ids stream in tiles of 16 keys through a two-stage ring.  Warp
//     0 of a pair computes S = Q K^T and P, warp 1 dP = dO V^T; they swap P
//     and dP through shared memory, both form dS = P (dP - delta) sm_scale,
//     and each sums dQ += dS K over half of the HD columns.
//
// At HD = 224 the K and V (Q and dO) tiles take 116,736 bytes, a stage
// 29,376 (dK/dV) or 29,248 (dQ), one block an SM; both kernels are checked
// against SMEM_MAX below for every HD.

constexpr int BT = 256;  // threads of a backward block: 8 warps, 4 pairs

// Start copying n (a multiple of 4) contiguous 4-byte values into shared
// memory; both addresses 16-byte aligned.
__device__ __forceinline__ void row_load(void* dst, const void* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += BT)
    cp_async16(smem_u32(static_cast<char*>(dst) + 16 * i), static_cast<const char*>(src) + 16 * i,
               16u);
}

// Shared memory of the f32 backward kernels, in floats: a resident pair of
// [R, HD + 4] tiles, then two stages of two streamed [N, HD + 4] tiles and
// ROWS arrays of N 4-byte values, then XBUF floats of exchange buffers.
template <int HD, int R, int N, int ROWS, int XBUF>
struct F32BwdLayout {
  static constexpr int LD = HD + 4;
  static constexpr size_t TILE = static_cast<size_t>(N) * LD;
  static constexpr size_t STAGE = 2 * TILE + ROWS * N;
  static constexpr size_t A = 0, B = static_cast<size_t>(R) * LD, S0 = 2 * B;
  static constexpr size_t X = S0 + 2 * STAGE;
  static constexpr size_t SMEM = (X + XBUF) * sizeof(float);
  static_assert(SMEM <= SMEM_MAX, "f32 backward shared memory");
  static_assert((LD * 4) % 16 == 0 && (STAGE * 4) % 16 == 0, "cp.async alignment");
};

constexpr int FB_ROWS = 64;  // keys (dK/dV) or queries (dQ) a block
constexpr int FB_N = 16;     // queries (dK/dV) or keys (dQ) a streamed tile
constexpr int FB_NS = FB_N / 8;
// dK/dV: K, V resident; Q, dO, lse, delta, seg streamed; P^T [4][FB_NS * 4][32]
template <int HD>
using DkvF32 = F32BwdLayout<HD, FB_ROWS, FB_N, 3, 4 * FB_NS * 4 * 32>;
// dQ: Q, dO resident; K, V, seg streamed; P and dP [4][2][FB_NS * 4][32]
template <int HD>
using DqF32 = F32BwdLayout<HD, FB_ROWS, FB_N, 1, 8 * FB_NS * 4 * 32>;

// s = A B^T over HD for 16 rows: `ta` points at A's element (g, t) (row
// stride LD), `tb` at the streamed tile's row 0; B's rows 8 n + g of the
// 16-row tile, read as the forward reads K.  The hi-hi and the two cross
// terms go to separate accumulators, and so do even and odd k-steps: each
// score sums four chains of 14-28 tensor-core adds on the CUDA cores rather
// than one of 84 (at HD = 224), which keeps the adds' truncation smaller.
template <int HD>
__device__ __forceinline__ void scores_f32(float (&s)[FB_NS][4], const float* ta,
                                           const float* tb) {
  constexpr int LD = HD + 4;
  static_assert(HD % 16 == 0, "k-steps in even and odd pairs");
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float hh[2][FB_NS][4], hl[2][FB_NS][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int n = 0; n < FB_NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[p][n][e] = hl[p][n][e] = 0.f;
#pragma unroll 2
  for (int k2 = 0; k2 < HD; k2 += 16) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int kk = k2 + 8 * p;
      uint32_t ah[4], al[4];
      split_tf32(ta[kk], ah[0], al[0]);
      split_tf32(ta[kk + 8 * LD], ah[1], al[1]);
      split_tf32(ta[kk + 4], ah[2], al[2]);
      split_tf32(ta[kk + 8 * LD + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < FB_NS; ++n) {
        const float* bp = tb + (8 * n + g) * LD + kk + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bp[0], bh0, bl0);
        split_tf32(bp[4], bh1, bl1);
        hopper::mma_tf32(hl[p][n], al, bh0, bh1);
        hopper::mma_tf32(hl[p][n], ah, bl0, bl1);
        hopper::mma_tf32(hh[p][n], ah, bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < FB_NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = (hl[0][n][e] + hl[1][n][e]) + (hh[0][n][e] + hh[1][n][e]);
}

// acc[n] += x B over the tile's 16 rows, NO 8-column tiles of B: x (16 x 16,
// accumulator layout) is the A operand in the key order above, `vb` points
// at B's row 2 t, column g (the forward's V read); each 8-column tile is
// summed into fresh registers first.
template <int HD, int NO>
__device__ __forceinline__ void accumulate_f32(float (&acc)[NO][4], const float (&x)[FB_NS][4],
                                               const float* vb) {
  constexpr int LD = HD + 4;
  uint32_t xh[FB_NS][4], xl[FB_NS][4];
#pragma unroll
  for (int ks = 0; ks < FB_NS; ++ks) {
    split_tf32(x[ks][0], xh[ks][0], xl[ks][0]);
    split_tf32(x[ks][2], xh[ks][1], xl[ks][1]);
    split_tf32(x[ks][1], xh[ks][2], xl[ks][2]);
    split_tf32(x[ks][3], xh[ks][3], xl[ks][3]);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < FB_NS; ++ks) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(vb[8 * ks * LD + 8 * n], bh0, bl0);
      split_tf32(vb[(8 * ks + 1) * LD + 8 * n], bh1, bl1);
      mma_3xtf32(part, xh[ks], xl[ks], bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// Write a 16-row accumulator of NO 8-column tiles: rows r and r + 8 (row
// stride rs floats from `base`), columns 8 n + 2 t, + 1.
template <int NO>
__device__ __forceinline__ void store_f32(float* base, size_t rs, int r,
                                          const float (&acc)[NO][4]) {
  const int t = threadIdx.x % 4;
  float* pa = base + static_cast<size_t>(r) * rs + 2 * t;
  float* pb = pa + 8 * rs;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(pa + 8 * n) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(pb + 8 * n) = make_float2(acc[n][2], acc[n][3]);
  }
}

// dK, dV: one block per (64 keys, b * H + h)
template <int HD>
__global__ void __launch_bounds__(BT, 1)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ seg,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int T_, float scale_log2, float sm_scale) {
  using L = DkvF32<HD>;
  constexpr int LD = L::LD, NO = HD / 8;
  extern __shared__ __align__(16) float xs[];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * FB_ROWS, nqt = T_ / FB_N;
  const size_t rs = static_cast<size_t>(H) * HD;
  const size_t head = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * HD;
  const size_t rows = static_cast<size_t>(bh) * T_;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pair = warp % 4, role = warp / 4;  // role 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int* segb = seg + static_cast<size_t>(b) * T_;
  const int kr = k0 + 16 * pair + g;  // this thread's key rows kr, kr + 8
  const int segk0 = segb[kr], segk1 = segb[kr + 8];

  // stage s: Q, dO [FB_N][LD], lse, delta f32 and seg int [FB_N]
  auto load_tile = [&](int j) {
    float* st = xs + L::S0 + (j & 1) * L::STAGE;
    x_load<HD>(st, q + head, j * FB_N, FB_N, T_, rs);
    x_load<HD>(st + L::TILE, dout + head, j * FB_N, FB_N, T_, rs);
    row_load(st + 2 * L::TILE, lse + rows + j * FB_N, FB_N);
    row_load(st + 2 * L::TILE + FB_N, delta + rows + j * FB_N, FB_N);
    row_load(st + 2 * L::TILE + 2 * FB_N, segb + j * FB_N, FB_N);
    cp_async_commit();
  };
  x_load<HD>(xs + L::A, k + head, k0, FB_ROWS, T_, rs);
  x_load<HD>(xs + L::B, v + head, k0, FB_ROWS, T_, rs);
  load_tile(0);  // one group with K and V

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* ta = xs + (role == 0 ? L::A : L::B) + (16 * pair + g) * LD + t;
  float* xbuf = xs + L::X + pair * (FB_NS * 4 * 32) + lane;

  for (int j = 0; j < nqt; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1 and its buffers
    if (j + 1 < nqt) load_tile(j + 1);
    const float* st = xs + L::S0 + (j & 1) * L::STAGE;
    const float* lse_s = st + 2 * L::TILE;
    const float* delta_s = lse_s + FB_N;
    const int* segq = reinterpret_cast<const int*>(lse_s + 2 * FB_N);

    // S^T = K Q^T (role 0) or dP^T = V dO^T (role 1); this thread: keys kr
    // (e < 2) and kr + 8, queries 8 n + 2 t (+ 1 for odd e)
    float s[FB_NS][4];
    scores_f32<HD>(s, ta, st + (role == 0 ? 0 : L::TILE));
    if (role == 0) {
#pragma unroll
      for (int n = 0; n < FB_NS; ++n) {
        const int c = 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const int2 sq = *reinterpret_cast<const int2*>(segq + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if ((e < 2 ? segk0 : segk1) != ((e & 1) ? sq.y : sq.x)) x = MASK;
          s[n][e] = ex2(x - ((e & 1) ? l2.y : l2.x) * LOG2E);
          xbuf[(4 * n + e) * 32] = s[n][e];
        }
      }
      hopper::named_arrive(1 + pair, 64);
    } else {
      hopper::named_sync(1 + pair, 64);
#pragma unroll
      for (int n = 0; n < FB_NS; ++n) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = xbuf[(4 * n + e) * 32] * (s[n][e] - ((e & 1) ? dl.y : dl.x)) * sm_scale;
      }
    }

    // dV += P^T dO (role 0) or dK += dS^T Q (role 1)
    accumulate_f32<HD>(acc, s, st + (role == 0 ? L::TILE : 0) + 2 * t * LD + g);
  }

  const size_t out = head + static_cast<size_t>(k0 + 16 * pair) * rs;
  store_f32<NO>((role == 0 ? dv : dk) + out, rs, g, acc);
}

// dQ: one block per (64 queries, b * H + h)
template <int HD>
__global__ void __launch_bounds__(BT, 1)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq, int H, int T_,
                 float scale_log2, float sm_scale) {
  using L = DqF32<HD>;
  constexpr int LD = L::LD, NO = HD / 16;  // 8-column tiles of a half of dQ's columns
  constexpr int XB = FB_NS * 4 * 32;
  extern __shared__ __align__(16) float xs[];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * FB_ROWS, nkt = T_ / FB_N;
  const size_t rs = static_cast<size_t>(H) * HD;
  const size_t head = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * HD;
  const size_t rows = static_cast<size_t>(bh) * T_;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pair = warp % 4, role = warp / 4;  // role 0: S, P; 1: dP; both: dS, half of dQ
  const int* segb = seg + static_cast<size_t>(b) * T_;
  const int ra = q0 + 16 * pair + g, rb = ra + 8;  // this thread's query rows
  const int sqa = segb[ra], sqb = segb[rb];
  const float la = lse[rows + ra] * LOG2E, lb = lse[rows + rb] * LOG2E;
  const float da = delta[rows + ra], db = delta[rows + rb];

  // stage s: K, V [FB_N][LD], seg int [FB_N]
  auto load_tile = [&](int j) {
    float* st = xs + L::S0 + (j & 1) * L::STAGE;
    x_load<HD>(st, k + head, j * FB_N, FB_N, T_, rs);
    x_load<HD>(st + L::TILE, v + head, j * FB_N, FB_N, T_, rs);
    row_load(st + 2 * L::TILE, segb + j * FB_N, FB_N);
    cp_async_commit();
  };
  x_load<HD>(xs + L::A, q + head, q0, FB_ROWS, T_, rs);
  x_load<HD>(xs + L::B, dout + head, q0, FB_ROWS, T_, rs);
  load_tile(0);  // one group with Q and dO

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* ta = xs + (role == 0 ? L::A : L::B) + (16 * pair + g) * LD + t;
  float* xmine = xs + L::X + (2 * pair + role) * XB + lane;
  const float* xother = xs + L::X + (2 * pair + (role ^ 1)) * XB + lane;

  for (int j = 0; j < nkt; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1 and its buffers
    if (j + 1 < nkt) load_tile(j + 1);
    const float* st = xs + L::S0 + (j & 1) * L::STAGE;

    // S = Q K^T (role 0) or dP = dO V^T (role 1); this thread: query rows ra
    // (e < 2) and rb, keys 8 n + 2 t (+ 1 for odd e)
    float s[FB_NS][4];
    scores_f32<HD>(s, ta, st + (role == 0 ? 0 : L::TILE));
    if (role == 0) {
      const int* segk = reinterpret_cast<const int*>(st + 2 * L::TILE);
#pragma unroll
      for (int n = 0; n < FB_NS; ++n) {
        const int2 sk = *reinterpret_cast<const int2*>(segk + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if ((e < 2 ? sqa : sqb) != ((e & 1) ? sk.y : sk.x)) x = MASK;
          s[n][e] = ex2(x - (e < 2 ? la : lb));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * FB_NS; ++i) xmine[i * 32] = s[i / 4][i % 4];
    hopper::named_sync(1 + pair, 64);
    // dS = P (dP - delta) sm_scale, the same in both warps of the pair
#pragma unroll
    for (int i = 0; i < 4 * FB_NS; ++i) {
      const float o = xother[i * 32], mine = s[i / 4][i % 4];
      const float p = role == 0 ? mine : o, dp = role == 0 ? o : mine;
      s[i / 4][i % 4] = p * (dp - ((i & 2) ? db : da)) * sm_scale;
    }

    // dQ[:, half] += dS K[:, half]
    accumulate_f32<HD>(acc, s, st + 2 * t * LD + role * (HD / 2) + g);
  }

  store_f32<NO>(dq + head + role * (HD / 2) + static_cast<size_t>(q0 + 16 * pair) * rs, rs, g, acc);
}

// ===========================================================================
// bf16 forward, dK/dV and dQ on Hopper: TMA, mbarriers, wgmma, warp
// specialisation; templates on the head dim HD
// ===========================================================================
//
// A block is three warpgroups.  Warpgroup 0 is the producer: one thread
// starts every tile load by TMA into a ring of stages and gives its
// registers to the consumers (setmaxnreg).  Warpgroups 1 and 2 consume:
// wgmma products with f32 accumulators in registers, the scores' A operand
// of the next product rounded to bf16 in registers.  Each stage has a full
// barrier (the producer's expected bytes, completed by TMA) and an empty
// barrier (one arrival per consumer warpgroup once its products on the
// stage are done).  Tiles are [rows, HD] in 32-column boxes with the 64-byte
// swizzle (hopper.cuh).  Every layout is checked against SMEM_MAX below.

using bf16 = __nv_bfloat16;

constexpr int BOX = 32;        // columns of a TMA box: one 64-byte swizzle row
constexpr int WG = 128;        // threads of a warpgroup
constexpr int NS = 32;         // f32 registers a thread of a 64 x 64 score tile

template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return static_cast<uint32_t>(rows) * HD * 2;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma A operand (4 registers) of score columns 16 ks.. of a 64 x 64
// accumulator s: the m64n8 layout of tiles 2 ks and 2 ks + 1, rounded to bf16.
__device__ __forceinline__ void scores_to_a(uint32_t (&a)[4], const float (&s)[NS], int ks) {
  a[0] = pack(s[8 * ks + 0], s[8 * ks + 1]);
  a[1] = pack(s[8 * ks + 2], s[8 * ks + 3]);
  a[2] = pack(s[8 * ks + 4], s[8 * ks + 5]);
  a[3] = pack(s[8 * ks + 6], s[8 * ks + 7]);
}

// Issue acc = A B over k = 0..HD-1 (not committed): A the 64 rows a0.. of
// tile ta (ta_rows rows), B the 64 rows of tile tb, both K-major.
template <int HD>
__device__ __forceinline__ void issue_kmajor(float (&acc)[NS], uint32_t ta, int ta_rows, int a0,
                                             uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16)
    hopper::wgmma_m64n64k16_ss(acc, hopper::kmajor_desc(ta, ta_rows, a0, kk),
                               hopper::kmajor_desc(tb, 64, 0, kk), kk > 0);
}

template <int HD>
__device__ __forceinline__ void product_kmajor(float (&acc)[NS], uint32_t ta, int ta_rows, int a0,
                                               uint32_t tb) {
  hopper::wgmma_fence();
  issue_kmajor<HD>(acc, ta, ta_rows, a0, tb);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

// acc += round(s) B: B the 64 x HD tile tb read N-major (k down its rows).
template <int HD>
__device__ __forceinline__ void product_nmajor(float (&acc)[HD / 2], const float (&s)[NS],
                                               uint32_t tb) {
  uint32_t a[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) scores_to_a(a[ks], s, ks);
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    hopper::wgmma_rs<HD>(acc, a[ks], hopper::nmajor_desc(tb, 64, 16 * ks));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
}

// Write a 64 x HD f32 accumulator as bf16 rows r0 + 16 w + g (and + 8) of one
// head (row stride rs elements), times `mul0` (`mul1`); rows >= nrows and
// columns >= ncols (a multiple of 8) skipped.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* base, size_t rs, int r0, int nrows,
                                           const float (&acc)[HD / 2], float mul0, float mul1,
                                           int ncols = HD) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, w = (threadIdx.x % WG) / 32;
  const int ra = r0 + 16 * w + g, rb = ra + 8;
  bf16* pa = base + static_cast<size_t>(ra) * rs + 2 * t;
  bf16* pb = base + static_cast<size_t>(rb) * rs + 2 * t;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (8 * n >= ncols) break;
    if (ra < nrows)
      *reinterpret_cast<uint32_t*>(pa + 8 * n) = pack(acc[4 * n] * mul0, acc[4 * n + 1] * mul0);
    if (rb < nrows)
      *reinterpret_cast<uint32_t*>(pb + 8 * n) = pack(acc[4 * n + 2] * mul1, acc[4 * n + 3] * mul1);
  }
}

// Shared memory of the bf16 smem_raw, aligned up to 1024 bytes.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// forward: one block per (128 query rows, b * H + h); consumer warpgroup c
// owns rows 64 c..64 c+63; key tiles of 64
template <int HD>
struct FwdLayout {
  static constexpr int M = 128, N = 64, STAGES = 2;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + tile_bytes<HD>(M);
  static constexpr uint32_t V = K + STAGES * tile_bytes<HD>(N);
  static constexpr uint32_t SEG = V + STAGES * tile_bytes<HD>(N);  // int [STAGES][N]
  static constexpr uint32_t BAR = SEG + STAGES * N * 4;  // full_q, full_k[], full_v[], empty[]
  static constexpr uint32_t SMEM = BAR + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
  static_assert(SMEM <= SMEM_MAX, "forward shared memory");
};

template <int HD>
__global__ void __launch_bounds__(3 * WG, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
               bf16* __restrict__ out, float* __restrict__ lse, int H, int T_, float scale_log2) {
  using L = FwdLayout<HD>;
  constexpr int FM = L::M, FN = L::N, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_q = sb + L::BAR;
  auto full_k = [&](int s) { return full_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return full_q + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return full_q + 8 * (1 + 2 * ST + s); };

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * FM, nkt = T_ / FN;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
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
      hopper::mbar_expect_tx(full_q, tile_bytes<HD>(FM));
      for (int c = 0; c < HD / BOX; ++c)
        hopper::tma_load_3d(sb + L::Q + c * FM * 64, &tm_q, full_q, c * BOX, h, row0 + q0);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % ST;
        if (j >= ST) hopper::mbar_wait(empty(s), (j / ST - 1) & 1);
        hopper::mbar_expect_tx(full_k(s), tile_bytes<HD>(FN) + FN * 4);
        for (int c = 0; c < HD / BOX; ++c)
          hopper::tma_load_3d(sb + L::K + s * tile_bytes<HD>(FN) + c * FN * 64, &tm_k, full_k(s),
                              c * BOX, h, row0 + j * FN);
        hopper::bulk_load(sb + L::SEG + s * FN * 4, seg + row0 + j * FN, FN * 4, full_k(s));
        hopper::mbar_expect_tx(full_v(s), tile_bytes<HD>(FN));
        for (int c = 0; c < HD / BOX; ++c)
          hopper::tma_load_3d(sb + L::V + s * tile_bytes<HD>(FN) + c * FN * 64, &tm_v, full_v(s),
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
    float o[HD / 2], sc[NS];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    // running row maxima (base-2 scores) and this thread's share of the row sums
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    hopper::mbar_wait(full_q, 0);
    for (int j = 0; j < nkt; ++j) {
      const int s = j % ST;
      const uint32_t ph = (j / ST) & 1;
      hopper::mbar_wait(full_k(s), ph);
      product_kmajor<HD>(sc, sb + L::Q, FM, 64 * cw, sb + L::K + s * tile_bytes<HD>(FN));

      // online softmax in base 2: x = s * sm_scale * log2(e), masked x = MASK
      // (finite, so a tile masked for the whole row gives exp2(0) = 1,
      // which alpha = 0 wipes once a real key arrives)
      const int* segk = reinterpret_cast<const int*>(smem + L::SEG) + s * FN;
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
      product_nmajor<HD>(o, sc, sb + L::V + s * tile_bytes<HD>(FN));
      if (tid == 0) hopper::mbar_arrive(empty(s));
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const size_t rs = static_cast<size_t>(H) * HD;
    store_rows<HD>(out + static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * HD, rs,
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
// read) pace the exchange through two buffers.  At HD = 256 the two-stage
// ring takes 231,976 bytes.
template <int HD>
struct DkvLayout {
  static constexpr int BK = 64, BQ = 64, STAGES = 2;
  static constexpr uint32_t K = 0;
  static constexpr uint32_t V = K + tile_bytes<HD>(BK);
  static constexpr uint32_t Q = V + tile_bytes<HD>(BK);                // [STAGES]
  static constexpr uint32_t DO = Q + STAGES * tile_bytes<HD>(BQ);      // [STAGES]
  static constexpr uint32_t X = DO + STAGES * tile_bytes<HD>(BQ);      // f32 [2][NS][WG]
  static constexpr uint32_t ROWS = X + 2 * NS * WG * 4;  // [STAGES]: lse, delta f32, seg int [BQ]
  static constexpr uint32_t BAR = ROWS + STAGES * 3 * BQ * 4;         // full_kv, full[], empty[]
  static constexpr uint32_t SMEM = BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(SMEM <= SMEM_MAX, "dK/dV shared memory");
};
constexpr int BAR_P_FULL = 1, BAR_P_FREE = 3;

template <int HD>
__global__ void __launch_bounds__(3 * WG, 1)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const int* __restrict__ seg, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   int H, int T_, float scale_log2, float sm_scale) {
  using L = DkvLayout<HD>;
  constexpr int BK = L::BK, BQ = L::BQ, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_kv = sb + L::BAR;
  auto full = [&](int s) { return full_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return full_kv + 8 * (1 + ST + s); };

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * BK, nqt = T_ / BQ;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_kv, 1);
    for (int s = 0; s < ST; ++s) {
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
      hopper::mbar_expect_tx(full_kv, 2 * tile_bytes<HD>(BK));
      for (int c = 0; c < HD / BOX; ++c) {
        hopper::tma_load_3d(sb + L::K + c * BK * 64, &tm_k, full_kv, c * BOX, h, row0 + k0);
        hopper::tma_load_3d(sb + L::V + c * BK * 64, &tm_v, full_kv, c * BOX, h, row0 + k0);
      }
      for (int j = 0; j < nqt; ++j) {
        const int s = j % ST;
        if (j >= ST) hopper::mbar_wait(empty(s), (j / ST - 1) & 1);
        hopper::mbar_expect_tx(full(s), 2 * tile_bytes<HD>(BQ) + 3 * BQ * 4);
        for (int c = 0; c < HD / BOX; ++c) {
          hopper::tma_load_3d(sb + L::Q + s * tile_bytes<HD>(BQ) + c * BQ * 64, &tm_q, full(s),
                              c * BOX, h, row0 + j * BQ);
          hopper::tma_load_3d(sb + L::DO + s * tile_bytes<HD>(BQ) + c * BQ * 64, &tm_do, full(s),
                              c * BOX, h, row0 + j * BQ);
        }
        const uint32_t rows = sb + L::ROWS + s * 3 * BQ * 4;
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
    const uint32_t ta = sb + (cw == 0 ? L::K : L::V);
    const uint32_t tb1 = sb + (cw == 0 ? L::Q : L::DO), tb2 = sb + (cw == 0 ? L::DO : L::Q);
    float acc[HD / 2], sc[NS];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    hopper::mbar_wait(full_kv, 0);
    for (int j = 0; j < nqt; ++j) {
      const int s = j % ST;
      hopper::mbar_wait(full(s), (j / ST) & 1);
      product_kmajor<HD>(sc, ta, BK, 0, tb1 + s * tile_bytes<HD>(BQ));

      const float* lse_s = reinterpret_cast<const float*>(smem + L::ROWS + s * 3 * BQ * 4);
      const float* delta_s = lse_s + BQ;
      const int* segq = reinterpret_cast<const int*>(lse_s + 2 * BQ);
      float* xbuf = reinterpret_cast<float*>(smem + L::X) + (j & 1) * NS * WG;
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
      product_nmajor<HD>(acc, sc, tb2 + s * tile_bytes<HD>(BQ));
      if (tid == 0) hopper::mbar_arrive(empty(s));
    }

    const size_t rs = static_cast<size_t>(H) * HD;
    const size_t head = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * HD;
    store_rows<HD>((cw == 0 ? dv : dk) + head, rs, k0, T_, acc, 1.f, 1.f);
  }
}

// dQ: one block per (128 query rows, b * H + h); consumer warpgroup c owns
// rows 64 c..64 c+63, with their lse, delta and segment ids in registers.
// Q and dO come once by TMA; K and V in 64-key tiles (segment ids by bulk
// copy) through a ring.  Per key tile: S = Q K^T and dP = dO V^T issued
// back to back (14 m64n64k16 each at HD = 224, shared x shared), P =
// exp2(x - lse log2 e) on S while dP finishes, dS = P (dP - delta) sm_scale,
// and dQ += round(dS) K with dS the register A operand and K read N-major
// (4 m64nHDk16).  A thread holds dQ (HD / 2), S and dP (32 each) in
// registers.  Shared memory at HD = 224: Q and dO 57,344 bytes each, K and V
// 28,672 each a stage, two stages: 230,952 bytes in all.  At HD = 256 two
// stages would take 263,208 bytes, so that instantiation runs one stage
// (the next tile's load waits for both consumers to finish the last).
template <int HD>
struct DqLayout {
  static constexpr int M = 128, N = 64;
  static constexpr int STAGES =
      2 * tile_bytes<HD>(M) + 2 * (2 * tile_bytes<HD>(N) + N * 4) + 8 * 5 + 1024 <= SMEM_MAX ? 2
                                                                                               : 1;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t DO = Q + tile_bytes<HD>(M);
  static constexpr uint32_t K = DO + tile_bytes<HD>(M);                // [STAGES]
  static constexpr uint32_t V = K + STAGES * tile_bytes<HD>(N);        // [STAGES]
  static constexpr uint32_t SEG = V + STAGES * tile_bytes<HD>(N);      // int [STAGES][N]
  static constexpr uint32_t BAR = SEG + STAGES * N * 4;                // full_qd, full[], empty[]
  static constexpr uint32_t SMEM = BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(SMEM <= SMEM_MAX, "dQ shared memory");
};

template <int HD>
__global__ void __launch_bounds__(3 * WG, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, const int* __restrict__ seg,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int H, int T_, float scale_log2, float sm_scale) {
  using L = DqLayout<HD>;
  constexpr int QM = L::M, KN = L::N, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_qd = sb + L::BAR;
  auto full = [&](int s) { return full_qd + 8 * (1 + s); };
  auto empty = [&](int s) { return full_qd + 8 * (1 + ST + s); };

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * QM, nkt = T_ / KN;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_qd, 1);
    for (int s = 0; s < ST; ++s) {
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
      hopper::mbar_expect_tx(full_qd, 2 * tile_bytes<HD>(QM));
      for (int c = 0; c < HD / BOX; ++c) {
        hopper::tma_load_3d(sb + L::Q + c * QM * 64, &tm_q, full_qd, c * BOX, h, row0 + q0);
        hopper::tma_load_3d(sb + L::DO + c * QM * 64, &tm_do, full_qd, c * BOX, h, row0 + q0);
      }
      for (int j = 0; j < nkt; ++j) {
        const int s = j % ST;
        if (j >= ST) hopper::mbar_wait(empty(s), (j / ST - 1) & 1);
        hopper::mbar_expect_tx(full(s), 2 * tile_bytes<HD>(KN) + KN * 4);
        for (int c = 0; c < HD / BOX; ++c) {
          hopper::tma_load_3d(sb + L::K + s * tile_bytes<HD>(KN) + c * KN * 64, &tm_k, full(s),
                              c * BOX, h, row0 + j * KN);
          hopper::tma_load_3d(sb + L::V + s * tile_bytes<HD>(KN) + c * KN * 64, &tm_v, full(s),
                              c * BOX, h, row0 + j * KN);
        }
        hopper::bulk_load(sb + L::SEG + s * KN * 4, seg + row0 + j * KN, KN * 4, full(s));
      }
    }
  } else {  // consumers
    hopper::setmaxnreg_inc<240>();
    const int cw = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * cw + 16 * (tid / 32) + g, r1 = r0 + 8;
    const size_t rr = static_cast<size_t>(bh) * T_;
    const int segq0 = r0 < T_ ? seg[static_cast<size_t>(b) * T_ + r0] : -1;
    const int segq1 = r1 < T_ ? seg[static_cast<size_t>(b) * T_ + r1] : -1;
    const float lse0 = r0 < T_ ? lse[rr + r0] * LOG2E : 0.f;
    const float lse1 = r1 < T_ ? lse[rr + r1] * LOG2E : 0.f;
    const float dl0 = r0 < T_ ? delta[rr + r0] : 0.f, dl1 = r1 < T_ ? delta[rr + r1] : 0.f;
    float acc[HD / 2], sc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    hopper::mbar_wait(full_qd, 0);
    for (int j = 0; j < nkt; ++j) {
      const int s = j % ST;
      hopper::mbar_wait(full(s), (j / ST) & 1);
      const uint32_t tk = sb + L::K + s * tile_bytes<HD>(KN);
      hopper::wgmma_fence();
      issue_kmajor<HD>(sc, sb + L::Q, QM, 64 * cw, tk);
      hopper::wgmma_commit();
      issue_kmajor<HD>(dp, sb + L::DO, QM, 64 * cw, sb + L::V + s * tile_bytes<HD>(KN));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S is in; dP may still run
      hopper::fence_regs(sc);

      // P = exp2(s * sm_scale * log2(e) - lse * log2(e)); masked: MASK
      const int* segk = reinterpret_cast<const int*>(smem + L::SEG) + s * KN;
#pragma unroll
      for (int n = 0; n < KN / 8; ++n) {
        const int2 sk = *reinterpret_cast<const int2*>(segk + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e] * scale_log2;
          if ((e < 2 ? segq0 : segq1) != ((e & 1) ? sk.y : sk.x)) x = MASK;
          sc[4 * n + e] = ex2(x - (e < 2 ? lse0 : lse1));
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] *= (dp[i] - ((i & 2) ? dl1 : dl0)) * sm_scale;

      // dQ += round(dS) K
      product_nmajor<HD>(acc, sc, tk);
      if (tid == 0) hopper::mbar_arrive(empty(s));
    }

    const size_t rs = static_cast<size_t>(H) * HD;
    store_rows<HD>(dq + static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * HD, rs,
                   q0 + 64 * cw, T_, acc, 1.f, 1.f);
  }
}

// ===========================================================================
// Head dims past 256: the wide kernels
// ===========================================================================
//
// JAX's flash branch takes any head dim: it zero-pads d_k above 128 to a
// multiple of 128.  Past 256 the templates above run out of room, since
// their output accumulator grows with HD (HD / 2 registers a thread in the
// bf16 forward; flash_bwd_dkv_f32<256> takes 255) and so do their resident
// tiles.  The wide kernels take any head dim DP that is a multiple of WK =
// 64 (the caller zero-pads to it: 448 runs as 448) and hold the accumulator
// fixed whatever DP:
//
//   * the output's columns are split over blockIdx.z in chunks, so a thread
//     holds the accumulator of one chunk at most;
//   * the score products (S = Q K^T, and dP = dO V^T in the backward) run
//     over all DP columns in stages through shared memory; their
//     accumulators do not grow with DP.  Every chunk's block recomputes
//     them.  In the forward they run with the same code on the same data in
//     the same order, so all chunks see the same scores, maxima and row sums
//     and normalise alike; chunk 0 alone writes lse.
//
// Four designs:
//
//   * bf16 forward and dK/dV (training): the templates' Hopper design, one
//     TMA producer warpgroup and two wgmma consumer warpgroups, with chunks
//     of WCH = 256 columns (wgmma's widest N; 128 accumulator registers a
//     consumer thread, as flash_fwd_bf16<256>), so D = 288-512 takes two
//     chunks and the scores are computed twice, not once per 128 columns.
//     The last chunk may be narrower (448 = 256 + 192): its missing V (or Q
//     and dO) boxes are not loaded, and the accumulator columns they feed
//     are not stored (chunks of 224 would do 5% less work at D = 448; a
//     224-column dK/dV drew more of ptxas's injected wgmma fences, C7519,
//     and was not kept).  The operand the block keeps (the forward's 128 rows
//     of Q; dK/dV's 64 keys of K and V) stays in shared memory while it
//     fits beside the rest (DP <= 576 forward, DP <= 512 dK/dV); past that
//     it streams through the ring with the other operand.  WidePlan, made on
//     the host from DP, lays shared memory out.
//   * bf16 dQ (training): the same machinery with the two consumers sharing
//     64 query rows, so the scores are computed once for up to 512 columns
//     of dQ: A computes S and dS, B dP, and each sums 256 of dQ's columns
//     (wide_dq_bf16 below).
//   * f32 forward (serving), f32 dK/dV and f32 dQ (f32 training): 3xTF32
//     mma.sync (f32 accuracy), 8 warps, the score products streamed in
//     cp.async stages, and the keys (forward, dQ) or queries (dK/dV) split
//     over blocks, since one head gives few blocks: flash_fwd_f32_merge,
//     wide_dkv_f32_merge and wide_dq_f32_merge sum the splits.  The forward
//     and dK/dV take the bf16 kernels' chunks; dQ takes all of DP up to
//     DQ_COLS = 512 columns as one chunk, so its scores are computed once.

constexpr int WK = 64;    // head-dim columns a stage of the score products; DP is a multiple
constexpr int WQ = 128;   // forward: query rows a block
constexpr int WN = 32;    // the f32 forward: keys a tile
constexpr int WT = 256;   // threads of an mma.sync block: 8 warps
constexpr int WNT = WN / 8;
constexpr int WCH = 256;  // all but the f32 dQ: output columns a chunk (bf16 dQ: two)

// ---------------------------------------------------------------------------
// bf16 forward, dK/dV and dQ on wgmma + TMA
// ---------------------------------------------------------------------------
//
// Tiles are 32-column boxes of 64 rows (BOXB bytes; the forward's Q boxes
// 128 rows) in the 64-byte swizzle, as the templates keep them.
//
// Forward: one block per (128 query rows, b * H + h, chunk).  A ring stage
// is 64 columns of the key tile (with Q's, when Q streams); per key tile
// the consumers run S = Q K^T over the DP / 64 stages (four m64n64k16 a
// stage), the base-2 online softmax, and
// O += round(P) V with the chunk's V as the N-major B operand and P the
// register A operand (wgmma_rs<256>).  V and the key segment ids come
// through a ring of two.
//
// dK/dV: one block per (64 keys, b * H + h, chunk), query tiles of 64, the
// consumers split as flash_bwd_dkv_bf16: A computes S^T = K Q^T, P^T and
// dV += round(P^T) dO_c; B computes dP^T = V dO^T, takes P^T through shared
// memory (named barriers), dS^T and dK += round(dS^T) Q_c, where Q_c and dO_c
// are the chunk's columns of the query tile.  Those columns are the last
// stages of the score products: they arrive once, into a chunk buffer that
// stays for the second products, with the tile's lse, delta and segment
// ids; the other DP - 256 columns stream through the ring, two boxes of Q
// and dO a stage.  So a query tile moves DP columns of Q and dO, not
// DP + 256.
//
// dQ: one block per (64 queries, b * H + h, pair of chunks: 512 columns).
// Q and dO stay in shared memory while they fit (DP <= 448), else stream
// with K and V.  A computes S = Q K^T and B dP = dO V^T over the DP / 64
// ring stages (K and V boxes, two each); B hands dP to A through shared
// memory, A forms P and dS = P (dP - delta) sm_scale and hands round(dS),
// as bf16 A-operand registers, back to B (named barriers BAR_WX_*); then A
// sums dQ[:, c0..c0+255] += round(dS) K_c and B dQ[:, c0+256..c0+511], K_c
// the key tile's columns of the pair read N-major from a buffer of 512
// columns, loaded by a second producer thread once both consumers are done
// with the last tile's, so it streams while the next S and dP run.  K
// moves twice a key tile (ring and K_c), not once per chunk.  Where the
// pair is narrower than 512 (448 = 256 + 192), B's product still runs 256
// columns wide (the tensor cores' work at 448 is 1.05x the function's, and
// A's 256 columns set the time) and the columns past the pair are not
// stored.
//
// What bounds them: the products.  A chunk multiplies over DP + 256
// columns forward (S, then P V) and 2 DP + 512 in dK/dV, against the
// function's 2 D and 4 D in all: at D = 448 (two chunks) 1.57x the
// function's work in both; dQ's pair 2 DP + 512 against 3 D, 1.05x.  At
// 64 query rows dQ streams K and V (and K_c) through L2 for every block, so
// at D = 448 its 172 KB a key tile per block may bound it before the
// tensor cores do.

constexpr uint32_t BOXB = 64 * 64;  // bytes of a 32-column box of 64 rows
constexpr int WRING = 8;            // ring stages at most
constexpr int WSB = 2;              // boxes of each streamed operand a ring stage
constexpr uint32_t WBARS = 8 * (5 + 2 * WRING);
constexpr int BAR_WP_FULL = 1, BAR_WP_FREE = 2;  // dK/dV: P^T written, P^T read

// Shared memory of a wide bf16 kernel (byte offsets from the 1024-aligned
// base): [the resident operand, at 0][ring][c: the forward's two V stages,
// dK/dV's chunk buffer Q_c, dO_c, or dQ's K_c of 2 WCH columns][x: dK/dV's
// P^T, or dQ's dP and dS, f32 [NS][WG]][rows: the forward's two stages of
// key segment ids, dK/dV's lse, delta and segment ids of the query tile, or
// dQ's key segment ids][barriers].  The f32 dK/dV and dQ lay their own out
// in the same fields (wide_dkv_f32_plan, wide_dq_f32_plan).
struct WidePlan {
  int res;         // 1: the block's own operand stays in shared memory
  int stages;      // ring stages
  uint32_t stage;  // bytes a ring stage
  uint32_t ring, c, x, rows, bar, smem;
  int step_cols;   // the f32 dK/dV and dQ: columns a ring step at most
};

enum WideKind { WIDE_FWD, WIDE_DKV, WIDE_DQ };

WidePlan wide_plan(int DP, WideKind kind) {
  // Q of 128 rows (forward), K and V of 64 (dK/dV), or Q and dO of 64 (dQ)
  const uint32_t own = 256u * static_cast<uint32_t>(DP);
  const uint32_t c = 2 * (WCH / BOX) * BOXB;
  const uint32_t x = kind == WIDE_FWD ? 0 : NS * WG * 4;
  const uint32_t rows = (kind == WIDE_FWD ? 2 : kind == WIDE_DKV ? 3 : 1) * 64 * 4;
  const uint32_t fixed = c + x + rows + WBARS + 1024;  // + alignment slack
  // a stage: WSB boxes of the streamed operands (forward: K; dK/dV: Q and
  // dO; dQ: K and V), and without the resident operand WSB of it too
  // (forward: Q of 128 rows; dQ: Q and dO)
  const uint32_t res_stage = (kind == WIDE_FWD ? 1 : 2) * WSB * BOXB;
  const uint32_t str_stage = (kind == WIDE_FWD ? 3 : 4) * WSB * BOXB;
  const uint32_t min_res = kind == WIDE_DKV ? 1 : 2;
  WidePlan p{};
  if (own + fixed + min_res * res_stage <= SMEM_MAX) {
    p.res = 1;
    p.stage = res_stage;
    p.stages = static_cast<int>((SMEM_MAX - own - fixed) / res_stage);
    p.ring = own;
  } else {
    p.res = 0;
    p.stage = str_stage;
    p.stages = static_cast<int>((SMEM_MAX - fixed) / str_stage);
    p.ring = 0;
  }
  if (p.stages > WRING) p.stages = WRING;
  p.c = p.ring + p.stages * p.stage;
  p.x = p.c + c;
  p.rows = p.x + x;
  p.bar = p.rows + rows;
  p.smem = p.bar + WBARS + 1024;
  return p;
}

__global__ void __launch_bounds__(3 * WG, 1)
wide_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
              bf16* __restrict__ out, float* __restrict__ lse, int H, int T_, int DP,
              const WidePlan p, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_q = sb + p.bar;
  auto full_k = [&](int s) { return full_q + 8 * (1 + s); };
  auto empty_k = [&](int s) { return full_q + 8 * (1 + WRING + s); };
  auto full_v = [&](int s) { return full_q + 8 * (1 + 2 * WRING + s); };
  auto empty_v = [&](int s) { return full_q + 8 * (3 + 2 * WRING + s); };
  auto v_tile = [&](int s) { return sb + p.c + s * (WCH / BOX) * BOXB; };

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * WQ, c0 = blockIdx.z * WCH;
  const int nkt = T_ / 64, nd = DP / WK, ST = p.stages;
  const int ncols = min(WCH, DP - c0);
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(empty_k(s), 2);
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty_v(s), 2);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / WG == 0) {  // producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int row0 = b * T_;
      if (p.res) {
        hopper::mbar_expect_tx(full_q, static_cast<uint32_t>(WQ) * DP * 2);
        for (int c = 0; c < DP / BOX; ++c)
          hopper::tma_load_3d(sb + c * 2 * BOXB, &tm_q, full_q, c * BOX, h, row0 + q0);
      }
      int it = 0;
      for (int j = 0; j < nkt; ++j) {
        for (int d = 0; d < nd; ++d, ++it) {
          const int s = it % ST;
          if (it >= ST) hopper::mbar_wait(empty_k(s), (it / ST - 1) & 1);
          const uint32_t st = sb + p.ring + s * p.stage;
          hopper::mbar_expect_tx(full_k(s), p.stage);
          if (!p.res)
            for (int x = 0; x < 2; ++x)
              hopper::tma_load_3d(st + x * 2 * BOXB, &tm_q, full_k(s), (2 * d + x) * BOX, h,
                                  row0 + q0);
          const uint32_t kt = st + (p.res ? 0 : 4 * BOXB);
          for (int x = 0; x < 2; ++x)
            hopper::tma_load_3d(kt + x * BOXB, &tm_k, full_k(s), (2 * d + x) * BOX, h,
                                row0 + j * 64);
        }
        const int sv = j & 1;
        if (j >= 2) hopper::mbar_wait(empty_v(sv), (j / 2 - 1) & 1);
        hopper::mbar_expect_tx(full_v(sv), (ncols / BOX) * BOXB + 64 * 4);
        for (int x = 0; x < ncols / BOX; ++x)
          hopper::tma_load_3d(v_tile(sv) + x * BOXB, &tm_v, full_v(sv), c0 + x * BOX, h,
                              row0 + j * 64);
        hopper::bulk_load(sb + p.rows + sv * 64 * 4, seg + row0 + j * 64, 64 * 4, full_v(sv));
      }
    }
  } else {  // consumers
    hopper::setmaxnreg_inc<232>();
    const int cw = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * cw + 16 * (tid / 32) + g, r1 = r0 + 8;
    const int segq0 = r0 < T_ ? seg[static_cast<size_t>(b) * T_ + r0] : -1;
    const int segq1 = r1 < T_ ? seg[static_cast<size_t>(b) * T_ + r1] : -1;
    float o[WCH / 2], sc[NS];
#pragma unroll
    for (int i = 0; i < WCH / 2; ++i) o[i] = 0.f;
    // running row maxima (base-2 scores) and this thread's share of the row sums
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    if (p.res) hopper::mbar_wait(full_q, 0);
    int it = 0;
    for (int j = 0; j < nkt; ++j) {
      // S = Q K^T over DP, a 64-column stage at a time, each stage's products
      // done before it is released: left in flight across the next stage's,
      // ptxas serialized them (C7515) and the forward took 1.39x the time at
      // D = 448 on an H100 80GB HBM3 at 700 W (tools/wide_variants.py)
      for (int d = 0; d < nd; ++d, ++it) {
        const int s = it % ST;
        hopper::mbar_wait(full_k(s), (it / ST) & 1);
        const uint32_t st = sb + p.ring + s * p.stage;
        const uint32_t qa = p.res ? sb + d * 4 * BOXB : st;
        const uint32_t kt = st + (p.res ? 0 : 4 * BOXB);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WK; kk += 16)
          hopper::wgmma_m64n64k16_ss(sc, hopper::kmajor_desc(qa, WQ, 64 * cw, kk),
                                     hopper::kmajor_desc(kt, 64, 0, kk), d > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (tid == 0) hopper::mbar_arrive(empty_k(s));
      }

      // online softmax in base 2: x = s * sm_scale * log2(e), masked x = MASK
      // (flash_fwd_bf16's)
      const int sv = j & 1;
      hopper::mbar_wait(full_v(sv), (j / 2) & 1);
      const int* segk = reinterpret_cast<const int*>(smem + p.rows) + sv * 64;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
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
      for (int i = 0; i < NS; ++i) {
        const float pr = ex2(sc[i] - ((i & 2) ? mn1 : mn0));
        sc[i] = pr;
        if (i & 2) sum1 += pr; else sum0 += pr;
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < WCH / 8; ++n) {
        o[4 * n] *= al0; o[4 * n + 1] *= al0; o[4 * n + 2] *= al1; o[4 * n + 3] *= al1;
      }

      // O += round(P) V over the chunk's columns
      product_nmajor<WCH>(o, sc, v_tile(sv));
      if (tid == 0) hopper::mbar_arrive(empty_v(sv));
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const size_t rs = static_cast<size_t>(H) * DP;
    store_rows<WCH>(out + static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * DP + c0, rs,
                    q0 + 64 * cw, T_, o, 1.f / l0, 1.f / l1, ncols);
    if (blockIdx.z == 0 && t == 0) {
      if (r0 < T_) lse[static_cast<size_t>(bh) * T_ + r0] = m0 * LN2 + logf(l0);
      if (r1 < T_) lse[static_cast<size_t>(bh) * T_ + r1] = m1 * LN2 + logf(l1);
    }
  }
}

__global__ void __launch_bounds__(3 * WG, 1)
wide_dkv_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
              const int* __restrict__ seg, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int H, int T_, int DP, const WidePlan p, float scale_log2, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_kv = sb + p.bar, full_c = full_kv + 8, empty_c = full_kv + 16;
  auto full = [&](int s) { return full_kv + 8 * (3 + s); };
  auto empty = [&](int s) { return full_kv + 8 * (3 + WRING + s); };

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * 64, c0 = blockIdx.z * WCH, nqt = T_ / 64, ST = p.stages;
  const int nb = DP / BOX, cb0 = c0 / BOX, ncols = min(WCH, DP - c0), ncb = ncols / BOX;
  // boxes a query tile sends through the ring: all but the chunk's while K
  // and V stay (the chunk's come last, into the chunk buffer), else all
  const int nring = p.res ? nb - ncb : nb, nrs = (nring + WSB - 1) / WSB;
  auto box = [&](int i) { return p.res && i >= cb0 ? i + ncb : i; };
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_kv, 1);
    hopper::mbar_init(full_c, 1);
    hopper::mbar_init(empty_c, 2);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 2);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / WG == 0) {  // producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int row0 = b * T_;
      if (p.res) {
        hopper::mbar_expect_tx(full_kv, 2u * 64 * DP * 2);
        for (int c = 0; c < nb; ++c) {
          hopper::tma_load_3d(sb + c * BOXB, &tm_k, full_kv, c * BOX, h, row0 + k0);
          hopper::tma_load_3d(sb + (nb + c) * BOXB, &tm_v, full_kv, c * BOX, h, row0 + k0);
        }
      }
      int it = 0;
      for (int j = 0; j < nqt; ++j) {
        for (int r = 0; r < nrs; ++r, ++it) {
          const int s = it % ST, nbx = min(WSB, nring - WSB * r);
          if (it >= ST) hopper::mbar_wait(empty(s), (it / ST - 1) & 1);
          const uint32_t st = sb + p.ring + s * p.stage;
          hopper::mbar_expect_tx(full(s), nbx * (p.res ? 2 : 4) * BOXB);
          for (int x = 0; x < nbx; ++x) {
            const int col = box(WSB * r + x) * BOX;
            hopper::tma_load_3d(st + x * BOXB, &tm_q, full(s), col, h, row0 + j * 64);
            hopper::tma_load_3d(st + (WSB + x) * BOXB, &tm_do, full(s), col, h, row0 + j * 64);
            if (!p.res) {
              hopper::tma_load_3d(st + (2 * WSB + x) * BOXB, &tm_k, full(s), col, h, row0 + k0);
              hopper::tma_load_3d(st + (3 * WSB + x) * BOXB, &tm_v, full(s), col, h, row0 + k0);
            }
          }
        }
        if (j >= 1) hopper::mbar_wait(empty_c, (j - 1) & 1);
        hopper::mbar_expect_tx(full_c, 2 * ncb * BOXB + 3 * 64 * 4);
        for (int x = 0; x < ncb; ++x) {
          hopper::tma_load_3d(sb + p.c + x * BOXB, &tm_q, full_c, c0 + x * BOX, h, row0 + j * 64);
          hopper::tma_load_3d(sb + p.c + (WCH / BOX + x) * BOXB, &tm_do, full_c, c0 + x * BOX, h,
                              row0 + j * 64);
        }
        const size_t rr = static_cast<size_t>(bh) * T_ + j * 64;
        hopper::bulk_load(sb + p.rows, lse + rr, 64 * 4, full_c);
        hopper::bulk_load(sb + p.rows + 64 * 4, delta + rr, 64 * 4, full_c);
        hopper::bulk_load(sb + p.rows + 2 * 64 * 4, seg + row0 + j * 64, 64 * 4, full_c);
      }
    }
  } else {  // consumers: A (cw 0) and B (cw 1)
    hopper::setmaxnreg_inc<232>();
    const int cw = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
    const int lane = tid % 32, t = lane % 4;
    const int kr = k0 + 16 * (tid / 32) + lane / 4;  // this thread's key rows kr, kr + 8
    const int segk0 = seg[static_cast<size_t>(b) * T_ + kr];
    const int segk1 = seg[static_cast<size_t>(b) * T_ + kr + 8];
    // A: S^T = K Q^T, then dV += P^T dO_c; B: dP^T = V dO^T, then dK += dS^T Q_c
    const uint32_t own = sb + (cw == 0 ? 0 : nb * BOXB);  // resident K or V
    const uint32_t chunk_a = sb + p.c + cw * (WCH / BOX) * BOXB;         // Q_c or dO_c
    const uint32_t chunk_b = sb + p.c + (1 - cw) * (WCH / BOX) * BOXB;   // dO_c or Q_c
    const float* lse_s = reinterpret_cast<const float*>(smem + p.rows);
    const float* delta_s = lse_s + 64;
    const int* segq = reinterpret_cast<const int*>(lse_s + 128);
    float* xbuf = reinterpret_cast<float*>(smem + p.x);
    float acc[WCH / 2], sc[NS];
#pragma unroll
    for (int i = 0; i < WCH / 2; ++i) acc[i] = 0.f;

    if (p.res) hopper::mbar_wait(full_kv, 0);
    int it = 0;
    for (int j = 0; j < nqt; ++j) {
      // each stage's products done before its release, as in the forward (in
      // flight, dK/dV took 1.18x the time at D = 448), and the box loops
      // unrolled (over runtime bounds, 1.03x; H100 80GB HBM3 at 700 W,
      // tools/wide_variants.py)
      for (int r = 0; r < nrs; ++r, ++it) {
        const int s = it % ST, nbx = min(WSB, nring - WSB * r);
        hopper::mbar_wait(full(s), (it / ST) & 1);
        const uint32_t st = sb + p.ring + s * p.stage;
        hopper::wgmma_fence();
#pragma unroll
        for (int x = 0; x < WSB; ++x) {
          if (x >= nbx) break;
          const uint32_t ta =
              p.res ? own + box(WSB * r + x) * BOXB : st + ((2 + cw) * WSB + x) * BOXB;
          const uint32_t tb = st + (cw * WSB + x) * BOXB;
#pragma unroll
          for (int kk = 0; kk < BOX; kk += 16)
            hopper::wgmma_m64n64k16_ss(sc, hopper::kmajor_desc(ta, 64, 0, kk),
                                       hopper::kmajor_desc(tb, 64, 0, kk), r > 0 || x > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (tid == 0) hopper::mbar_arrive(empty(s));
      }
      hopper::mbar_wait(full_c, j & 1);
      if (p.res) {  // the chunk's columns, last
        hopper::wgmma_fence();
#pragma unroll
        for (int x = 0; x < WCH / BOX; ++x) {
          if (x >= ncb) break;
          const uint32_t ta = own + (cb0 + x) * BOXB, tb = chunk_a + x * BOXB;
#pragma unroll
          for (int kk = 0; kk < BOX; kk += 16)
            hopper::wgmma_m64n64k16_ss(sc, hopper::kmajor_desc(ta, 64, 0, kk),
                                       hopper::kmajor_desc(tb, 64, 0, kk),
                                       nring > 0 || x > 0 || kk > 0);
        }
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // this thread: keys kr (e < 2) and kr + 8, queries 8 n + 2 t (+ 1 for odd e)
      if (cw == 0) {
        // P^T = exp2(s * sm_scale * log2(e) - lse * log2(e)); masked: MASK
#pragma unroll
        for (int n = 0; n < 8; ++n) {
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
        if (j >= 1) hopper::named_sync(BAR_WP_FREE, 2 * WG);
#pragma unroll
        for (int i = 0; i < NS; ++i) xbuf[i * WG + tid] = sc[i];
        hopper::named_arrive(BAR_WP_FULL, 2 * WG);
      } else {
        hopper::named_sync(BAR_WP_FULL, 2 * WG);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * n + e;
            sc[i] = xbuf[i * WG + tid] * (sc[i] - ((e & 1) ? dl.y : dl.x)) * sm_scale;
          }
        }
        if (j < nqt - 1) hopper::named_arrive(BAR_WP_FREE, 2 * WG);
      }
      product_nmajor<WCH>(acc, sc, chunk_b);
      if (tid == 0) hopper::mbar_arrive(empty_c);
    }

    const size_t rs = static_cast<size_t>(H) * DP;
    const size_t head = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * DP;
    store_rows<WCH>((cw == 0 ? dv : dk) + head + c0, rs, k0, T_, acc, 1.f, 1.f, ncols);
  }
}

constexpr int BAR_WX_DP = 1, BAR_WX_DS = 2;  // dQ: dP written (by B), dS written (by A)

__global__ void __launch_bounds__(3 * WG, 1)
wide_dq_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
             const int* __restrict__ seg, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq, int H, int T_, int DP,
             const WidePlan p, float scale_log2, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_qd = sb + p.bar, full_c = full_qd + 8, empty_c = full_qd + 16;
  auto full = [&](int s) { return full_qd + 8 * (3 + s); };
  auto empty = [&](int s) { return full_qd + 8 * (3 + WRING + s); };

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * 64, c0 = blockIdx.z * 2 * WCH, nkt = T_ / 64, ST = p.stages;
  const int nb = DP / BOX, nd = DP / WK, ncols = min(2 * WCH, DP - c0), ncb = ncols / BOX;
  if (threadIdx.x == 0) {
    hopper::mbar_init(full_qd, 1);
    hopper::mbar_init(full_c, 1);
    hopper::mbar_init(empty_c, 2);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 2);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / WG == 0) {  // producer: thread 0 the ring, thread 32 the chunk buffer
    hopper::setmaxnreg_dec<40>();
    const int row0 = b * T_;
    if (threadIdx.x == 0) {
      if (p.res) {
        hopper::mbar_expect_tx(full_qd, 2u * 64 * DP * 2);
        for (int c = 0; c < nb; ++c) {
          hopper::tma_load_3d(sb + c * BOXB, &tm_q, full_qd, c * BOX, h, row0 + q0);
          hopper::tma_load_3d(sb + (nb + c) * BOXB, &tm_do, full_qd, c * BOX, h, row0 + q0);
        }
      }
      int it = 0;
      for (int j = 0; j < nkt; ++j) {
        for (int d = 0; d < nd; ++d, ++it) {
          const int s = it % ST;
          if (it >= ST) hopper::mbar_wait(empty(s), (it / ST - 1) & 1);
          const uint32_t st = sb + p.ring + s * p.stage;
          hopper::mbar_expect_tx(full(s), p.stage);
          for (int x = 0; x < WSB; ++x) {
            const int col = (WSB * d + x) * BOX;
            hopper::tma_load_3d(st + x * BOXB, &tm_k, full(s), col, h, row0 + j * 64);
            hopper::tma_load_3d(st + (WSB + x) * BOXB, &tm_v, full(s), col, h, row0 + j * 64);
            if (!p.res) {
              hopper::tma_load_3d(st + (2 * WSB + x) * BOXB, &tm_q, full(s), col, h, row0 + q0);
              hopper::tma_load_3d(st + (3 * WSB + x) * BOXB, &tm_do, full(s), col, h, row0 + q0);
            }
          }
        }
      }
    } else if (threadIdx.x == 32) {
      for (int j = 0; j < nkt; ++j) {
        if (j >= 1) hopper::mbar_wait(empty_c, (j - 1) & 1);
        hopper::mbar_expect_tx(full_c, ncb * BOXB + 64 * 4);
        for (int x = 0; x < ncb; ++x)
          hopper::tma_load_3d(sb + p.c + x * BOXB, &tm_k, full_c, c0 + x * BOX, h, row0 + j * 64);
        hopper::bulk_load(sb + p.rows, seg + row0 + j * 64, 64 * 4, full_c);
      }
    }
  } else {  // consumers: A (cw 0) and B (cw 1)
    hopper::setmaxnreg_inc<232>();
    const int cw = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
    const int lane = tid % 32, t = lane % 4;
    const int r0 = q0 + 16 * (tid / 32) + lane / 4, r1 = r0 + 8;  // this thread's query rows
    const size_t rr = static_cast<size_t>(bh) * T_;
    const int segq0 = seg[static_cast<size_t>(b) * T_ + r0];
    const int segq1 = seg[static_cast<size_t>(b) * T_ + r1];
    const float lse0 = lse[rr + r0] * LOG2E, lse1 = lse[rr + r1] * LOG2E;
    const float dl0 = delta[rr + r0], dl1 = delta[rr + r1];
    // A: S = Q K^T, then dQ[:, c0..c0+255] += round(dS) K_c; B: dP = dO V^T, then
    // dQ[:, c0+256..] += round(dS) K_c, over this consumer's columns of the pair
    const uint32_t own = sb + (cw == 0 ? 0 : nb * BOXB);  // resident Q or dO
    const int my_cols = cw == 0 ? min(WCH, ncols) : ncols - WCH;  // <= 0: none
    const int* segk = reinterpret_cast<const int*>(smem + p.rows);
    float* xbuf = reinterpret_cast<float*>(smem + p.x);
    float acc[WCH / 2], sc[NS];
#pragma unroll
    for (int i = 0; i < WCH / 2; ++i) acc[i] = 0.f;

    if (p.res) hopper::mbar_wait(full_qd, 0);
    int it = 0;
    for (int j = 0; j < nkt; ++j) {
      // S (A) or dP (B) over DP, each ring stage's products done before its
      // release, as in wide_dkv_bf16
      for (int d = 0; d < nd; ++d, ++it) {
        const int s = it % ST;
        hopper::mbar_wait(full(s), (it / ST) & 1);
        const uint32_t st = sb + p.ring + s * p.stage;
        hopper::wgmma_fence();
#pragma unroll
        for (int x = 0; x < WSB; ++x) {
          const uint32_t ta =
              p.res ? own + (WSB * d + x) * BOXB : st + ((2 + cw) * WSB + x) * BOXB;
          const uint32_t tb = st + (cw * WSB + x) * BOXB;
#pragma unroll
          for (int kk = 0; kk < BOX; kk += 16)
            hopper::wgmma_m64n64k16_ss(sc, hopper::kmajor_desc(ta, 64, 0, kk),
                                       hopper::kmajor_desc(tb, 64, 0, kk), d > 0 || x > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (tid == 0) hopper::mbar_arrive(empty(s));
      }

      // this thread: query rows r0 (e < 2) and r1, keys 8 n + 2 t (+ 1 for odd e).
      // B hands dP to A through its slots of xbuf; A forms dS = P (dP - delta)
      // sm_scale and hands back round(dS), the A operand of both dQ products,
      // in the same slots (each pair of threads tid owns its own).
      uint32_t a[4][4];
      uint32_t* xw = reinterpret_cast<uint32_t*>(xbuf) + tid;
      hopper::mbar_wait(full_c, j & 1);
      if (cw == 0) {
        // P = exp2(s * sm_scale * log2(e) - lse * log2(e)); masked: MASK
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int2 sk = *reinterpret_cast<const int2*>(segk + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * n + e] * scale_log2;
            if ((e < 2 ? segq0 : segq1) != ((e & 1) ? sk.y : sk.x)) x = MASK;
            sc[4 * n + e] = ex2(x - (e < 2 ? lse0 : lse1));
          }
        }
        hopper::named_sync(BAR_WX_DP, 2 * WG);
#pragma unroll
        for (int i = 0; i < NS; ++i)
          sc[i] *= (xbuf[i * WG + tid] - ((i & 2) ? dl1 : dl0)) * sm_scale;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          scores_to_a(a[ks], sc, ks);
#pragma unroll
          for (int i = 0; i < 4; ++i) xw[(4 * ks + i) * WG] = a[ks][i];
        }
        hopper::named_arrive(BAR_WX_DS, 2 * WG);
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) xbuf[i * WG + tid] = sc[i];
        hopper::named_arrive(BAR_WX_DP, 2 * WG);
        hopper::named_sync(BAR_WX_DS, 2 * WG);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) a[ks][i] = xw[(4 * ks + i) * WG];
      }

      // dQ[:, this consumer's columns] += round(dS) K_c, K_c read N-major; the
      // columns past the pair's (a narrower last chunk) feed accumulator
      // columns that are not stored
      if (my_cols > 0) {
        const uint32_t kc = sb + p.c + cw * (WCH / BOX) * BOXB;
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          hopper::wgmma_rs<WCH>(acc, a[ks], hopper::nmajor_desc(kc, 64, 16 * ks));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      }
      if (tid == 0) hopper::mbar_arrive(empty_c);
    }

    const size_t rs = static_cast<size_t>(H) * DP;
    store_rows<WCH>(dq + static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * DP + c0 +
                        cw * WCH,
                    rs, q0, T_, acc, 1.f, 1.f, my_cols);
  }
}

// ---------------------------------------------------------------------------
// mma.sync kernels: the f32 forward, dK/dV and dQ
// ---------------------------------------------------------------------------
//
// They take the f32 kernels' fragment scheme on mma.sync m16n8k8: 3xTF32
// (f32 accuracy), each operand split into TF32 hi and lo where it is read.
// Tiles stream by cp.async in stages of WK columns.
//
// Blocks are 8 warps.  Forward: 128 query rows (16 a warp), key tiles of
// WN = 32, chunks of up to WCH columns (a warp's accumulator 16 x 256, as
// flash_fwd_f32<256>), the keys split over blocks.  dK/dV: see
// wide_dkv_f32; dQ, its mirror image: see wide_dq_f32.  Operations bound
// them; a chunk recomputes the score products, so the chunk count
// multiplies that part of the work.

// Shared row stride of a COLS-column f32 tile: 16 bytes of padding keep
// rows 16-byte aligned for cp.async and spread a fragment load over the
// banks.
__host__ __device__ constexpr int wld(int cols) { return cols + 4; }

// Start copying rows [r0, r0 + rows) of COLS columns (src: the first column
// of the head's row 0, row stride rs floats) into a shared tile of row
// stride wld(COLS); rows at or past `limit`, and columns at or past `cols`
// (a multiple of 4), are zero-filled.
template <int COLS>
__device__ __forceinline__ void w_load(float* dst, const float* src, int r0, int rows, int limit,
                                       size_t rs, int cols = COLS) {
  constexpr int CPR = COLS / 4, LD = wld(COLS);
  for (int i = threadIdx.x; i < rows * CPR; i += WT) {
    const int r = i / CPR, c = (i - r * CPR) * 4;
    const bool in = r0 + r < limit && c < cols;
    cp_async16(smem_u32(dst + r * LD + c),
               src + (in ? static_cast<size_t>(r0 + r) * rs + c : 0), in ? 16u : 0u);
  }
}

// s += A B^T over one stage's WK columns: A's 16 rows at `ta` (the warp's
// element (g, t)), B's WN rows from `tb` (row 0), both of row stride
// wld(WK), B read as the f32 forward reads K.  The stage sums into fresh
// registers, added to s on the CUDA cores, so no tensor-core chain of adds
// runs past a stage.
__device__ __forceinline__ void w_scores(float (&s)[WNT][4], const float* ta, const float* tb) {
  constexpr int LD = wld(WK);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float part[WNT][4];
#pragma unroll
  for (int n = 0; n < WNT; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < WK; kk += 8) {
    uint32_t ah[4], al[4];
    split_tf32(ta[kk], ah[0], al[0]);
    split_tf32(ta[kk + 8 * LD], ah[1], al[1]);
    split_tf32(ta[kk + 4], ah[2], al[2]);
    split_tf32(ta[kk + 8 * LD + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < WNT; ++n) {
      const float* bp = tb + (8 * n + g) * LD + kk + t;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(bp[0], bh0, bl0);
      split_tf32(bp[4], bh1, bl1);
      mma_3xtf32(part[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int n = 0; n < WNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += part[n][e];
}

// acc[n] += x B over a tile's WN rows, NO 8-column tiles of B (those from
// column `cols` on skipped): x (16 x WN, accumulator layout) is the A
// operand with the keys of each 8-key step in the order (0, 2, 4, 6, 1, 3, 5,
// 7), as in the f32 kernels; `vb` points at B's row 2 t, column g (row stride
// LD).  Each 8-column tile sums the tile's rows into fresh registers first.
template <int NO, int LD>
__device__ __forceinline__ void w_accumulate(float (&acc)[NO][4], const float (&x)[WNT][4],
                                             const float* vb, int cols = 8 * NO) {
  uint32_t xh[WNT][4], xl[WNT][4];
#pragma unroll
  for (int ks = 0; ks < WNT; ++ks) {
    split_tf32(x[ks][0], xh[ks][0], xl[ks][0]);
    split_tf32(x[ks][2], xh[ks][1], xl[ks][1]);
    split_tf32(x[ks][1], xh[ks][2], xl[ks][2]);
    split_tf32(x[ks][3], xh[ks][3], xl[ks][3]);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (8 * n >= cols) break;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < WNT; ++ks) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(vb[8 * ks * LD + 8 * n], bh0, bl0);
      split_tf32(vb[(8 * ks + 1) * LD + 8 * n], bh1, bl1);
      mma_3xtf32(part, xh[ks], xl[ks], bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// Write a 16-row accumulator of NO 8-column tiles: rows r and r + 8 of
// `base` (row stride rs; rows at or past `limit` skipped), columns 8 n + 2 t
// and + 1 below `cols`, times mul0 (row r) and mul1 (row r + 8).
template <int NO>
__device__ __forceinline__ void w_store(float* base, size_t rs, int r, int limit,
                                        const float (&acc)[NO][4], float mul0, float mul1,
                                        int cols = 8 * NO) {
  const int t = threadIdx.x % 4;
  float* pa = base + static_cast<size_t>(r) * rs + 2 * t;
  float* pb = pa + 8 * rs;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (8 * n >= cols) break;
    if (r < limit)
      *reinterpret_cast<float2*>(pa + 8 * n) = make_float2(acc[n][0] * mul0, acc[n][1] * mul0);
    if (r + 8 < limit)
      *reinterpret_cast<float2*>(pb + 8 * n) = make_float2(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

// Shared memory of the f32 wide forward, in floats: two stages of
// Q [WQ][wld(WK)] and K [WN][wld(WK)], then V [WN][wld(WCH)].
struct WideFwdF32 {
  static constexpr int LK = wld(WK), LC = wld(WCH);
  static constexpr int STAGE = (WQ + WN) * LK;
  static constexpr int V = 2 * STAGE;
  static constexpr size_t SMEM = static_cast<size_t>(V + WN * LC) * sizeof(float);
  static_assert(SMEM <= SMEM_MAX, "wide forward shared memory");
  static_assert((WQ * LK * 4) % 16 == 0 && (STAGE * 4) % 16 == 0, "cp.async alignment");
};

// f32 forward: one block per (128 query rows, b * H + h, split of the key
// tiles x chunk of WCH output columns: blockIdx.z = split * chunks +
// chunk); part_o / part_ml (null without a split) as flash_fwd_f32's, with
// DP columns: each chunk writes its columns of the split's unnormalised
// output, chunk 0 its (m, l) rows.
__global__ void __launch_bounds__(WT, 1)
wide_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const int* __restrict__ seg, float* __restrict__ out, float* __restrict__ lse,
             float* __restrict__ part_o, float* __restrict__ part_ml, int H, int T_, int DP,
             int tiles_per_split, float scale_log2) {
  using L = WideFwdF32;
  constexpr int NO = WCH / 8;
  extern __shared__ __align__(16) unsigned char wsm[];
  float* sm = reinterpret_cast<float*>(wsm);

  const int nc = (DP + WCH - 1) / WCH, chunk = blockIdx.z % nc, split = blockIdx.z / nc;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * WQ, c0 = chunk * WCH, ncols = min(WCH, DP - c0);
  const int kt0 = split * tiles_per_split, kt1 = min(T_ / WN, kt0 + tiles_per_split);
  const int nd = DP / WK, total = (kt1 - kt0) * nd;
  const size_t rs = static_cast<size_t>(H) * DP;
  const size_t head = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * DP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ra = q0 + 16 * warp + g, rb = ra + 8;  // this thread's two query rows
  const int* segb = seg + static_cast<size_t>(b) * T_;
  const int sqa = ra < T_ ? segb[ra] : -1, sqb = rb < T_ ? segb[rb] : -1;

  // stage i: columns WK (i % nd).. of the block's Q rows and of key tile kt0 + i / nd
  auto load_stage = [&](int i) {
    const int j = kt0 + i / nd, d = i % nd;
    float* st = sm + (i & 1) * L::STAGE;
    w_load<WK>(st, q + head + d * WK, q0, WQ, T_, rs);
    w_load<WK>(st + WQ * L::LK, k + head + d * WK, j * WN, WN, T_, rs);
  };
  load_stage(0);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running row maxima (base-2 scores) and this thread's share of the row sums
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;

  for (int j = kt0; j < kt1; ++j) {
    int2 sk[WNT];  // segment ids of keys 8 n + 2 t, + 1
#pragma unroll
    for (int n = 0; n < WNT; ++n)
      sk[n] = *reinterpret_cast<const int2*>(segb + j * WN + 8 * n + 2 * t);
    float s[WNT][4];
#pragma unroll
    for (int n = 0; n < WNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int d = 0; d < nd; ++d) {
      const int i = (j - kt0) * nd + d;
      cp_async_wait<0>();
      __syncthreads();  // stage i is in; every warp is done with stage i - 1 (and V at d = 0)
      if (i + 1 < total) load_stage(i + 1);
      if (d == 0) w_load<WCH>(sm + L::V, v + head + c0, j * WN, WN, T_, rs, ncols);
      cp_async_commit();
      const float* st = sm + (i & 1) * L::STAGE;
      w_scores(s, st + (16 * warp + g) * L::LK + t, st + WQ * L::LK);
    }

    // online softmax in base 2, masked scores at MASK (flash_fwd_f32's)
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int n = 0; n < WNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if ((e < 2 ? sqa : sqb) != ((e & 1) ? sk[n].y : sk[n].x)) x = MASK;
        s[n][e] = x;
        if (e < 2) mxa = fmaxf(mxa, x); else mxb = fmaxf(mxb, x);
      }
    const float mna = fmaxf(ma, quad_max(mxa)), mnb = fmaxf(mb, quad_max(mxb));
    const float ala = ex2(ma - mna), alb = ex2(mb - mnb);  // 0 on the first tile
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int n = 0; n < WNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[n][e] - (e < 2 ? mna : mnb));
        s[n][e] = p;
        if (e < 2) suma += p; else sumb += p;
      }
    la = la * ala + suma;
    lb = lb * alb + sumb;
    ma = mna;
    mb = mnb;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= ala; o[n][1] *= ala; o[n][2] *= alb; o[n][3] *= alb;
    }

    cp_async_wait<0>();
    __syncthreads();  // V's columns c0.. of key tile j are in
    // O += P V over the chunk's columns
    w_accumulate<NO, L::LC>(o, s, sm + L::V + 2 * t * L::LC + g, ncols);
  }

  la = quad_sum(la);
  lb = quad_sum(lb);
  if (part_o == nullptr) {
    w_store<NO>(out + head + c0, rs, ra, T_, o, 1.f / la, 1.f / lb, ncols);
    if (chunk == 0 && t == 0) {
      if (ra < T_) lse[static_cast<size_t>(bh) * T_ + ra] = ma * LN2 + logf(la);
      if (rb < T_) lse[static_cast<size_t>(bh) * T_ + rb] = mb * LN2 + logf(lb);
    }
  } else {
    const size_t row = (static_cast<size_t>(split) * gridDim.y + bh) * T_;
    w_store<NO>(part_o + row * DP + c0, DP, ra, T_, o, 1.f, 1.f, ncols);
    if (chunk == 0 && t == 0) {
      if (ra < T_) *reinterpret_cast<float2*>(part_ml + 2 * (row + ra)) = make_float2(ma, la);
      if (rb < T_) *reinterpret_cast<float2*>(part_ml + 2 * (row + rb)) = make_float2(mb, lb);
    }
  }
}

// dK, dV (f32): one block per (FK = 32 keys, b * H + h, chunk of WCH output
// columns x split of the query tiles: blockIdx.z = split * chunks + chunk),
// query tiles of FQ = 16.  K and V of the block's keys stay in shared
// memory while they fit (WidePlan res; DP <= 640), else stream with Q and
// dO.  Per query tile the score products run over DP in steps of a
// cp.async ring (Q and dO, and K and V when they stream) as wide as shared
// memory allows two of (step_cols: 256 at DP = 448, 64 at 640; one
// __syncthreads a step), all but the chunk's own columns, which arrive last
// into a chunk buffer kept for dV and dK with the tile's lse, delta and
// segment ids.  The 8 warps are (kg, role,
// hf): key group kg of 16 keys; role 0 computes S^T = K Q^T, role 1
// dP^T = V dO^T, each warp over the k-steps of parity hf of every step
// (both n-tiles of the 16 queries from one A fragment); the four partial
// sums of a key group meet in shared memory, every warp adds them in the
// same order, role 0 forms P^T and dV += P^T dO_c, role 1 P^T, dS^T = P^T
// (dP^T - delta) sm_scale and dK += dS^T Q_c, each over half hf of the
// chunk's columns (a 16 x 128 accumulator, 64 registers a thread).  With
// splits (gridDim.z > chunks) each split writes its partial dK and dV at
// `split_stride` floats from the last and wide_dkv_f32_merge sums them.
constexpr int FK = 32, FQ = 16;
constexpr int FLC = WCH + 4;  // row stride (floats) of the chunk buffer
constexpr int FXB = 2 * 2 * 2 * 8 * 32;     // exchange: [kg][role][hf][8 values][32 lanes]

// Byte offsets of wide_dkv_f32's shared memory: [K, V [FK][DP + 4] while
// resident][ring: steps of Q, dO [FQ][step_cols + 4] (+ K, V [FK][...]
// streamed)][c: Q_c, dO_c [FQ][FLC] (+ K_c, V_c [FK][FLC])][x: FXB floats]
// [rows: lse, delta, seg [FQ]].  step_cols: the widest of 256, 192, 128, 64
// that leaves room for two ring steps.
WidePlan wide_dkv_f32_plan(int DP) {
  const uint32_t kv = 2u * FK * (DP + 4) * 4;
  WidePlan p{};
  for (int res = 1; res >= 0; --res) {
    const uint32_t rows_a = 2 * FQ + (res ? 0 : 2 * FK);  // rows a ring step or the chunk holds
    p.res = res;
    p.ring = res ? kv : 0;
    const uint32_t fixed = p.ring + rows_a * FLC * 4 + FXB * 4 + 3 * FQ * 4;
    for (p.step_cols = WCH; p.step_cols >= WK; p.step_cols -= WK) {
      p.stage = rows_a * (p.step_cols + 4) * 4;
      if (fixed + 2 * p.stage > SMEM_MAX) continue;
      p.stages = static_cast<int>((SMEM_MAX - fixed) / p.stage);
      if (p.stages > WRING) p.stages = WRING;
      p.c = p.ring + p.stages * p.stage;
      p.x = p.c + rows_a * FLC * 4;
      p.rows = p.x + FXB * 4;
      p.bar = p.smem = p.rows + 3 * FQ * 4;
      return p;
    }
  }
  p.stages = 0;  // refused
  return p;
}

// cp.async.wait_group n for a run-time n < 8
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Start copying `rows` rows (a multiple of 16) of `cols` floats (a multiple
// of 64; src: row 0, row stride rs) into shared rows of `ld` floats: each
// pass a thread copies 16 bytes of 16 rows x 64 columns.
__device__ __forceinline__ void f32_rows_load(float* dst, int ld, const float* src, int rows,
                                              int cols, size_t rs) {
  const int r = threadIdx.x / 16, c = (threadIdx.x % 16) * 4;
  for (int r0 = 0; r0 < rows; r0 += 16)
    for (int c0 = 0; c0 < cols; c0 += WK)
      cp_async16(smem_u32(dst + (r0 + r) * ld + c0 + c), src + (r0 + r) * rs + c0 + c, 16u);
}

// s += A B^T over `cols` columns (a multiple of 32), k-steps 16 m + 8 hf:
// A's 16 rows at `ta` (the warp's element (g, t), row stride lda), B's 8 NT
// rows at `tb` (row 0, row stride ldb), read as the f32 forward reads K.
// The hi-hi and the cross terms, of even and odd m, go to separate
// accumulators (as in scores_f32): eight independent chains rather than two,
// summed on the CUDA cores into s; the loop is unrolled to four k-steps so
// the next fragments load under the current products.
template <int NT = 2>
__device__ __forceinline__ void f32_step_scores(float (&s)[NT][4], const float* ta, int lda,
                                                const float* tb, int ldb, int hf, int cols) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float hh[2][NT][4], hl[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[p][n][e] = hl[p][n][e] = 0.f;
#pragma unroll 2
  for (int m2 = 0; m2 < cols / 16; m2 += 2) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int kk = 16 * (m2 + p) + 8 * hf;
      uint32_t ah[4], al[4];
      split_tf32(ta[kk], ah[0], al[0]);
      split_tf32(ta[kk + 8 * lda], ah[1], al[1]);
      split_tf32(ta[kk + 4], ah[2], al[2]);
      split_tf32(ta[kk + 8 * lda + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* bp = tb + (8 * n + g) * ldb + kk + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bp[0], bh0, bl0);
        split_tf32(bp[4], bh1, bl1);
        hopper::mma_tf32(hl[p][n], al, bh0, bh1);
        hopper::mma_tf32(hl[p][n], ah, bl0, bl1);
        hopper::mma_tf32(hh[p][n], ah, bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += (hl[0][n][e] + hl[1][n][e]) + (hh[0][n][e] + hh[1][n][e]);
}

// acc[n] += x B for the NO 8-column tiles of B over 8 KS rows: x (16 x 8 KS,
// accumulator layout) the A operand split in xh, xl with the rows of each
// 8-row step in the order (0, 2, 4, 6, 1, 3, 5, 7), `vb` at B's row 2 t,
// column g (row stride ldb), as accumulate_f32; every tile sums into fresh
// registers, and NO is a constant, so the tiles' chains interleave.
template <int NO, int KS = 2>
__device__ __forceinline__ void f32_accumulate(float (&acc)[WCH / 16][4],
                                               const uint32_t (&xh)[KS][4],
                                               const uint32_t (&xl)[KS][4], const float* vb,
                                               int ldb) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(vb[8 * ks * ldb + 8 * n], bh0, bl0);
      split_tf32(vb[(8 * ks + 1) * ldb + 8 * n], bh1, bl1);
      mma_3xtf32(part, xh[ks], xl[ks], bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

__global__ void __launch_bounds__(WT, 1)
wide_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const int* __restrict__ seg, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, size_t split_stride, int H, int T_,
             int DP, const WidePlan p, int tiles_per_split, float scale_log2, float sm_scale) {
  constexpr int NO = WCH / 16;  // 8-column tiles of a warp's half of the chunk
  extern __shared__ __align__(16) unsigned char wsm[];
  float* ring = reinterpret_cast<float*>(wsm + p.ring);
  float* chunk_s = reinterpret_cast<float*>(wsm + p.c);
  float* xs = reinterpret_cast<float*>(wsm + p.x);
  float* rows_s = reinterpret_cast<float*>(wsm + p.rows);

  const int nc = (DP + WCH - 1) / WCH, chunk = blockIdx.z % nc, split = blockIdx.z / nc;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * FK, c0 = chunk * WCH, ncols = min(WCH, DP - c0);
  const int jt0 = split * tiles_per_split, ntile = min(T_ / FQ, jt0 + tiles_per_split) - jt0;
  // steps a query tile: the ring's over the columns before the chunk (nbef
  // steps) and after it, each at most step_cols wide; then the chunk's
  const int sw = p.step_cols, ldr = sw + 4;
  const int nbef = (c0 + sw - 1) / sw, nring = nbef + (DP - c0 - ncols + sw - 1) / sw;
  const int nstep = nring + 1, total = ntile * nstep;
  const int ahead = min(nring, p.stages - 1);  // steps in flight beyond the current one
  const size_t rs = static_cast<size_t>(H) * DP;
  const size_t head = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * DP;
  const size_t rows = static_cast<size_t>(bh) * T_;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kg = warp & 1, role = (warp >> 1) & 1, hf = warp >> 2;
  const int* segb = seg + static_cast<size_t>(b) * T_;
  const int kr = k0 + 16 * kg + g;  // this thread's key rows kr, kr + 8
  const int segk0 = segb[kr], segk1 = segb[kr + 8];
  const int half_cols = min(WCH / 2, ncols - hf * (WCH / 2));  // this warp's columns (<= 0: none)
  const int rows_a = p.res ? 2 * FQ : 2 * FQ + 2 * FK;

  // ring step r: its first column and width
  auto step_col = [&](int r) { return r < nbef ? r * sw : c0 + ncols + (r - nbef) * sw; };
  auto step_width = [&](int r) { return min(sw, (r < nbef ? c0 : DP) - step_col(r)); };
  // step (jj, r) of query tile jt0 + jj: ring step r < nring into ring slot
  // `slot`, then step nring, the chunk's columns
  auto load_step = [&](int jj, int r, int slot) {
    const int j = jt0 + jj;
    if (r < nring) {
      const int col = step_col(r), w = step_width(r);
      float* st = ring + slot * (rows_a * ldr);
      const size_t qrow = head + static_cast<size_t>(j) * FQ * rs + col;
      f32_rows_load(st, ldr, q + qrow, FQ, w, rs);
      f32_rows_load(st + FQ * ldr, ldr, dout + qrow, FQ, w, rs);
      if (!p.res) {
        const size_t krow = head + static_cast<size_t>(k0) * rs + col;
        f32_rows_load(st + 2 * FQ * ldr, ldr, k + krow, FK, w, rs);
        f32_rows_load(st + (2 * FQ + FK) * ldr, ldr, v + krow, FK, w, rs);
      }
    } else {
      w_load<WCH>(chunk_s, q + head + c0, j * FQ, FQ, T_, rs, ncols);
      w_load<WCH>(chunk_s + FQ * FLC, dout + head + c0, j * FQ, FQ, T_, rs, ncols);
      if (!p.res) {
        w_load<WCH>(chunk_s + 2 * FQ * FLC, k + head + c0, k0, FK, T_, rs, ncols);
        w_load<WCH>(chunk_s + (2 * FQ + FK) * FLC, v + head + c0, k0, FK, T_, rs, ncols);
      }
      row_load(rows_s, lse + rows + j * FQ, FQ);
      row_load(rows_s + FQ, delta + rows + j * FQ, FQ);
      row_load(rows_s + 2 * FQ, segb + j * FQ, FQ);
    }
  };
  // one cp.async group a step (the first also K and V), so step i is in
  // once all but the `ahead` newest groups are
  if (p.res) {
    float* kv = reinterpret_cast<float*>(wsm);
    f32_rows_load(kv, DP + 4, k + head + static_cast<size_t>(k0) * rs, FK, DP, rs);
    f32_rows_load(kv + FK * (DP + 4), DP + 4, v + head + static_cast<size_t>(k0) * rs, FK, DP, rs);
  }
  // the steps loaded (lj, lr, lslot) and consumed (jj, r, slot), advanced
  // step by step; a ring step takes the next ring slot
  int lj = 0, lr = 0, lslot = 0;
  auto next = [&](int& sj, int& sr, int& sslot) {
    if (sr < nring && ++sslot == p.stages) sslot = 0;
    if (++sr == nstep) sr = 0, ++sj;
  };
  for (int i = 0; i < ahead; ++i) {
    if (i < total) load_step(lj, lr, lslot);
    next(lj, lr, lslot);
    cp_async_commit();
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float s[2][4];
  // A's element (g, t) of this warp's 16 keys: resident, or in a step of the ring or the chunk
  const int arow = role * FK + 16 * kg + g;
  const float* ta_res = reinterpret_cast<const float*>(wsm) + arow * (DP + 4) + t;

  for (int i = 0, jj = 0, r = 0, slot = 0; i < total; ++i, next(jj, r, slot)) {
    cp_async_wait_n(ahead - 1);
    __syncthreads();  // step i is in; every warp is done with step i - 1 (and its buffers)
    if (i + ahead < total) load_step(lj, lr, lslot);
    next(lj, lr, lslot);
    cp_async_commit();
    if (r == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
    if (r < nring) {
      // S^T = K Q^T (role 0) or dP^T = V dO^T (role 1) over the step's columns
      const int col = step_col(r), w = step_width(r);
      const float* st = ring + slot * (rows_a * ldr);
      if (p.res)
        f32_step_scores(s, ta_res + col, DP + 4, st + role * FQ * ldr, ldr, hf, w);
      else
        f32_step_scores(s, st + (2 * FQ + arow) * ldr + t, ldr, st + role * FQ * ldr, ldr, hf, w);
      continue;
    }
    // the chunk's columns
    if (p.res)
      f32_step_scores(s, ta_res + c0, DP + 4, chunk_s + role * FQ * FLC, FLC, hf, ncols);
    else
      f32_step_scores(s, chunk_s + (2 * FQ + arow) * FLC + t, FLC, chunk_s + role * FQ * FLC, FLC,
                      hf, ncols);

    // the key group's four partial sums (its warps meet at named barrier
    // 1 + kg), added in one order by every warp; this thread: keys kr (e < 2)
    // and kr + 8, queries 8 n + 2 t (+ 1 for odd e)
    float* mine = xs + ((kg * 2 + role) * 2 + hf) * 256 + lane;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32] = s[n][e];
    hopper::named_sync(1 + kg, 128);
    const float* xst = xs + kg * 4 * 256 + lane;  // S^T halves, then dP^T halves
    const float* lse_s = rows_s;
    const float* delta_s = rows_s + FQ;
    const int* segq = reinterpret_cast<const int*>(rows_s + 2 * FQ);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c = 8 * n + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
      const int2 sq = *reinterpret_cast<const int2*>(segq + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = (4 * n + e) * 32;
        // P^T = exp2(s * sm_scale * log2(e) - lse * log2(e)); masked: MASK
        float x = (xst[o] + xst[256 + o]) * scale_log2;
        if ((e < 2 ? segk0 : segk1) != ((e & 1) ? sq.y : sq.x)) x = MASK;
        const float pt = ex2(x - ((e & 1) ? l2.y : l2.x) * LOG2E);
        if (role == 0)
          s[n][e] = pt;
        else  // dS^T = P^T (dP^T - delta) sm_scale
          s[n][e] = pt * ((xst[512 + o] + xst[768 + o]) - ((e & 1) ? dl.y : dl.x)) * sm_scale;
      }
    }
    // dV += P^T dO_c (role 0) or dK += dS^T Q_c (role 1) over this warp's half
    // of the chunk, the queries of each 8-query step in the order (0, 2, 4, 6,
    // 1, 3, 5, 7) as in accumulate_f32
    if (half_cols > 0) {
      const float* vb = chunk_s + (role == 0 ? FQ * FLC : 0) + 2 * t * FLC + hf * (WCH / 2) + g;
      uint32_t xh[2][4], xl[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        split_tf32(s[ks][0], xh[ks][0], xl[ks][0]);
        split_tf32(s[ks][2], xh[ks][1], xl[ks][1]);
        split_tf32(s[ks][1], xh[ks][2], xl[ks][2]);
        split_tf32(s[ks][3], xh[ks][3], xl[ks][3]);
      }
      // a warp's columns are 128 or, in a last chunk of 64 or 192, 64
      if (half_cols == WCH / 2)
        f32_accumulate<WCH / 16>(acc, xh, xl, vb, FLC);
      else
        f32_accumulate<WCH / 32>(acc, xh, xl, vb, FLC);
    }
  }
  cp_async_wait<0>();

  float* out = (role == 0 ? dv : dk) + split * split_stride + head + c0 + hf * (WCH / 2);
  w_store<NO>(out, rs, kr, T_, acc, 1.f, 1.f, half_cols);
}

// Sum wide_dkv_f32's nsplit partial dK (blockIdx.y 0) or dV (1), n floats
// each ([nsplit][n] at part, dV's after dK's), in split order: 4 floats a thread.
__global__ void __launch_bounds__(256)
wide_dkv_f32_merge(const float* __restrict__ part, float* __restrict__ dk, float* __restrict__ dv,
                   size_t n, int nsplit) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  const float* src = part + blockIdx.y * nsplit * n + i;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < nsplit; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * n);
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
  *reinterpret_cast<float4*>((blockIdx.y == 0 ? dk : dv) + i) = acc;
}

// dQ (f32): wide_dkv_f32's mirror image, queries and keys swapped.  One
// block per (DQ_Q = 32 queries, b * H + h, chunk of dQ's columns x split of
// the key tiles: blockIdx.z = split * chunks + chunk), key tiles of DQ_N =
// 16.  A chunk is all of DP up to DQ_COLS (dq_f32_chunk: 448 is one chunk),
// so S and dP are computed once a key tile and the tensor cores do the
// function's work; past DQ_COLS the chunks are as even as multiples of 64
// allow.  Q and dO of the block's queries stay in shared memory while they
// fit (WidePlan res; DP <= 640), else stream with K and V.  Per key tile
// the score products run over DP in steps of a cp.async ring (V; K outside
// the chunk; Q and dO when they stream) as wide as shared memory allows two
// of (step_cols: 256 at DP = 448; one __syncthreads a step); the chunk's K
// columns go instead into K_c, a buffer for each parity of the tile, with
// the tile's segment ids, and stay there for dQ += dS K_c.  The 8 warps are
// (qg, role, hf): query group qg of 16 queries; role 0 computes S = Q K^T,
// role 1 dP = dO V^T, each over the k-steps of parity hf of every step; at
// the tile's last step the four partial sums of a query group meet in
// shared memory, every warp of the group adds them in the same order and
// forms P and dS = P (dP - delta) sm_scale, and warp (role, hf) sums dQ over
// quarter 2 role + hf of the chunk's columns (at most 16 x 128, 64
// registers a thread).  With splits (gridDim.z > chunks) each split writes
// its partial dQ at `split_stride` floats from the last and
// wide_dq_f32_merge sums them.
constexpr int DQ_Q = 32, DQ_N = 16;
constexpr int DQ_COLS = 512;           // dQ columns a chunk at most: 4 warps x 128
constexpr int DQ_NT = DQ_N / 8;        // 8-key n-tiles of a key tile
constexpr int DQ_XW = 4 * DQ_NT * 32;  // exchange floats a warp writes
constexpr int DQ_XB = 8 * DQ_XW;       // exchange: [qg][role][hf][4 DQ_NT values][32 lanes]

// The f32 dQ's chunk width at head dim DP: DP in as few chunks of at most
// DQ_COLS as will do, each a multiple of WK and all but the last equal
// (448 -> 448; 576 -> 320 + 256; 768 -> 384 + 384).
__host__ __device__ constexpr int dq_f32_chunk(int DP) {
  return WK * ((DP / WK + (DP + DQ_COLS - 1) / DQ_COLS - 1) / ((DP + DQ_COLS - 1) / DQ_COLS));
}

// Byte offsets of wide_dq_f32's shared memory: [Q, dO [DQ_Q][DP + 4] while
// resident][ring: steps of V [DQ_N][step_cols + 4] (+ K [DQ_N][...] where
// the chunk is narrower than DP, + Q, dO [DQ_Q][...] streamed)][c: K_c
// [2][DQ_N][chunk + 4]][x: DQ_XB floats][rows: key segment ids [2][DQ_N]].
// step_cols: the widest of 256, 192, 128, 64 that leaves room for two ring
// steps.
WidePlan wide_dq_f32_plan(int DP) {
  const int cw = dq_f32_chunk(DP);
  const uint32_t kc = 2u * DQ_N * (cw + 4) * 4, rest = kc + DQ_XB * 4 + 2 * DQ_N * 4;
  WidePlan p{};
  for (int res = 1; res >= 0; --res) {
    const uint32_t rows_r = DQ_N + (cw < DP ? DQ_N : 0) + (res ? 0 : 2 * DQ_Q);
    p.res = res;
    p.ring = res ? 2u * DQ_Q * (DP + 4) * 4 : 0;
    for (int sw = WCH; sw >= WK; sw -= WK) {
      p.step_cols = sw;
      p.stage = rows_r * (sw + 4) * 4;
      if (p.ring + rest + 2 * p.stage > SMEM_MAX) continue;
      p.stages = static_cast<int>((SMEM_MAX - p.ring - rest) / p.stage);
      if (p.stages > WRING) p.stages = WRING;
      p.c = p.ring + p.stages * p.stage;
      p.x = p.c + kc;
      p.rows = p.x + DQ_XB * 4;
      p.bar = p.smem = p.rows + 2 * DQ_N * 4;
      return p;
    }
  }
  p.stages = 0;  // refused
  return p;
}

// acc += x B over the first `no` 8-column tiles of B (no even, 2 <= no <=
// WCH / 16) as f32_accumulate<no>, so the tiles' chains interleave.
template <int NO = 2>
__device__ __forceinline__ void dq_accumulate(float (&acc)[WCH / 16][4],
                                              const uint32_t (&xh)[DQ_NT][4],
                                              const uint32_t (&xl)[DQ_NT][4], const float* vb,
                                              int ldb, int no) {
  if constexpr (NO < WCH / 16) {
    if (no > NO) {
      dq_accumulate<NO + 2>(acc, xh, xl, vb, ldb, no);
      return;
    }
  }
  f32_accumulate<NO, DQ_NT>(acc, xh, xl, vb, ldb);
}

__global__ void __launch_bounds__(WT, 1)
wide_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const int* __restrict__ seg, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
            size_t split_stride, int H, int T_, int DP, const WidePlan p, int tiles_per_split,
            float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) unsigned char wsm[];
  float* ring = reinterpret_cast<float*>(wsm + p.ring);
  float* kc_s = reinterpret_cast<float*>(wsm + p.c);
  float* xs = reinterpret_cast<float*>(wsm + p.x);
  int* segk_s = reinterpret_cast<int*>(wsm + p.rows);

  const int cw = dq_f32_chunk(DP), nc = (DP + cw - 1) / cw;
  const int chunk = blockIdx.z % nc, split = blockIdx.z / nc;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * DQ_Q, c0 = chunk * cw, ncols = min(cw, DP - c0);
  const int kt0 = split * tiles_per_split, ntile = min(T_ / DQ_N, kt0 + tiles_per_split) - kt0;
  // steps a key tile: over the columns before the chunk (nbef steps), in it
  // (nin) and after it, each at most step_cols wide
  const int sw = p.step_cols, ldr = sw + 4, ldc = cw + 4, ldq = DP + 4;
  const int nbef = (c0 + sw - 1) / sw, nin = (ncols + sw - 1) / sw;
  const int nstep = nbef + nin + (DP - c0 - ncols + sw - 1) / sw, total = ntile * nstep;
  const int ahead = min(nstep, p.stages - 1);  // steps in flight beyond the current one
  // a ring slot's rows: V, then K where the chunk is narrower than DP, then
  // Q and dO when they stream
  const int krow_r = DQ_N, qrow_r = nc > 1 ? 2 * DQ_N : DQ_N;
  const int slot = (qrow_r + (p.res ? 0 : 2 * DQ_Q)) * ldr;  // floats a ring slot
  const size_t rs = static_cast<size_t>(H) * DP;
  const size_t head = static_cast<size_t>(b) * T_ * rs + static_cast<size_t>(h) * DP;
  const size_t rows = static_cast<size_t>(bh) * T_;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qg = warp & 1, role = (warp >> 1) & 1, hf = warp >> 2;
  const int* segb = seg + static_cast<size_t>(b) * T_;
  const int qr = q0 + 16 * qg + g;  // this thread's query rows qr, qr + 8
  const int sq0 = segb[qr], sq1 = segb[qr + 8];
  const float l0 = lse[rows + qr] * LOG2E, l1 = lse[rows + qr + 8] * LOG2E;
  const float d0 = delta[rows + qr], d1 = delta[rows + qr + 8];
  const int quarter = ncols / 4, wc = (2 * role + hf) * quarter;  // this warp's columns: c0 + wc..

  // step r of a key tile: its first column and width; whether it lies in the chunk
  auto step_col = [&](int r) {
    return r < nbef ? r * sw
           : r < nbef + nin ? c0 + (r - nbef) * sw
                            : c0 + ncols + (r - nbef - nin) * sw;
  };
  auto step_width = [&](int r) {
    return min(sw, (r < nbef ? c0 : r < nbef + nin ? c0 + ncols : DP) - step_col(r));
  };
  auto in_chunk = [&](int r) { return r >= nbef && r < nbef + nin; };
  // step i: step r of key tile kt0 + jj into ring slot i % stages (K's
  // chunk columns into K_c of the tile's parity, the segment ids with step 0)
  auto load_step = [&](int i) {
    const int jj = i / nstep, r = i - jj * nstep, j = kt0 + jj;
    const int col = step_col(r), w = step_width(r);
    float* st = ring + (i % p.stages) * slot;
    const size_t krow = head + static_cast<size_t>(j) * DQ_N * rs + col;
    f32_rows_load(st, ldr, v + krow, DQ_N, w, rs);
    if (in_chunk(r))
      f32_rows_load(kc_s + (jj & 1) * DQ_N * ldc + col - c0, ldc, k + krow, DQ_N, w, rs);
    else
      f32_rows_load(st + krow_r * ldr, ldr, k + krow, DQ_N, w, rs);
    if (!p.res) {
      const size_t qrow = head + static_cast<size_t>(q0) * rs + col;
      f32_rows_load(st + qrow_r * ldr, ldr, q + qrow, DQ_Q, w, rs);
      f32_rows_load(st + (qrow_r + DQ_Q) * ldr, ldr, dout + qrow, DQ_Q, w, rs);
    }
    if (r == 0) row_load(segk_s + (jj & 1) * DQ_N, segb + j * DQ_N, DQ_N);
  };
  // one cp.async group a step (the first also Q and dO), so step i is in
  // once all but the `ahead` newest groups are
  if (p.res) {
    float* qd = reinterpret_cast<float*>(wsm);
    const size_t qrow = head + static_cast<size_t>(q0) * rs;
    f32_rows_load(qd, ldq, q + qrow, DQ_Q, DP, rs);
    f32_rows_load(qd + DQ_Q * ldq, ldq, dout + qrow, DQ_Q, DP, rs);
  }
  for (int i = 0; i < ahead; ++i) {
    if (i < total) load_step(i);
    cp_async_commit();
  }

  float acc[WCH / 16][4];
#pragma unroll
  for (int n = 0; n < WCH / 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float s[DQ_NT][4];
  // A's element (g, t) of this warp's 16 queries of Q (role 0) or dO (role 1)
  const int arow = role * DQ_Q + 16 * qg + g;
  const float* ta_res = reinterpret_cast<const float*>(wsm) + arow * ldq + t;

  for (int i = 0, jj = 0, r = 0; i < total; ++i) {
    cp_async_wait_n(ahead - 1);
    __syncthreads();  // step i is in; every warp is done with step i - 1 (and its buffers)
    if (i + ahead < total) load_step(i + ahead);
    cp_async_commit();
    if (r == 0) {
#pragma unroll
      for (int n = 0; n < DQ_NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
    // S = Q K^T (role 0) or dP = dO V^T (role 1) over the step's columns
    const int col = step_col(r);
    const float* st = ring + (i % p.stages) * slot;
    const float* kt = kc_s + (jj & 1) * DQ_N * ldc;  // the tile's K_c
    const float* ta = p.res ? ta_res + col : st + (qrow_r + arow) * ldr + t;
    const bool kc_b = role == 0 && in_chunk(r);
    const float* tb = role == 1 ? st : kc_b ? kt + col - c0 : st + krow_r * ldr;
    f32_step_scores<DQ_NT>(s, ta, p.res ? ldq : ldr, tb, kc_b ? ldc : ldr, hf, step_width(r));

    if (r == nstep - 1) {
      // the query group's four partial sums (its warps meet at named barrier
      // 1 + qg), added in one order by every warp; this thread: queries qr
      // (e < 2) and qr + 8, keys 8 n + 2 t (+ 1 for odd e)
      float* mine = xs + ((qg * 2 + role) * 2 + hf) * DQ_XW + lane;
#pragma unroll
      for (int n = 0; n < DQ_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32] = s[n][e];
      hopper::named_sync(1 + qg, 128);
      const float* xq = xs + qg * 4 * DQ_XW + lane;  // S halves, then dP halves
      const int* segk = segk_s + (jj & 1) * DQ_N;
#pragma unroll
      for (int n = 0; n < DQ_NT; ++n) {
        const int2 sk = *reinterpret_cast<const int2*>(segk + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = (4 * n + e) * 32;
          // P = exp2(s * sm_scale * log2(e) - lse * log2(e)); masked: MASK
          float x = (xq[o] + xq[DQ_XW + o]) * scale_log2;
          if ((e < 2 ? sq0 : sq1) != ((e & 1) ? sk.y : sk.x)) x = MASK;
          const float pr = ex2(x - (e < 2 ? l0 : l1));
          // dS = P (dP - delta) sm_scale
          s[n][e] = pr * ((xq[2 * DQ_XW + o] + xq[3 * DQ_XW + o]) - (e < 2 ? d0 : d1)) * sm_scale;
        }
      }
      // dQ[:, c0 + wc..] += dS K_c[:, wc..] over this warp's quarter of the
      // chunk, the keys of each 8-key step in the order (0, 2, 4, 6, 1, 3, 5,
      // 7) as in accumulate_f32
      uint32_t xh[DQ_NT][4], xl[DQ_NT][4];
#pragma unroll
      for (int ks = 0; ks < DQ_NT; ++ks) {
        split_tf32(s[ks][0], xh[ks][0], xl[ks][0]);
        split_tf32(s[ks][2], xh[ks][1], xl[ks][1]);
        split_tf32(s[ks][1], xh[ks][2], xl[ks][2]);
        split_tf32(s[ks][3], xh[ks][3], xl[ks][3]);
      }
      dq_accumulate(acc, xh, xl, kt + 2 * t * ldc + wc + g, ldc, quarter / 8);
    }
    if (++r == nstep) r = 0, ++jj;
  }
  cp_async_wait<0>();

  w_store<WCH / 16>(dq + split * split_stride + head + c0 + wc, rs, qr, T_, acc, 1.f, 1.f,
                    quarter);
}

// Sum wide_dq_f32's nsplit partial dQ, n floats each ([nsplit][n] at part),
// in split order: 4 floats a thread.
__global__ void __launch_bounds__(256)
wide_dq_f32_merge(const float* __restrict__ part, float* __restrict__ dq, size_t n, int nsplit) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < nsplit; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + s * n + i);
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
  *reinterpret_cast<float4*>(dq + i) = acc;
}

// ===========================================================================
// launches
// ===========================================================================

bool shape_ok(int B, int H, int T, int D) {
  return B > 0 && H > 0 && T > 0 && T % 64 == 0 && D > 0 && D <= MAX_D;
}

// Call f with std::integral_constant<int, D> for a head dim the templates
// are built for; cudaErrorInvalidValue for any other.
template <typename F>
int by_width(int D, F f) {
  switch (D) {
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 224: return f(std::integral_constant<int, 224>());
    case 256: return f(std::integral_constant<int, 256>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
int bf16_map(CUtensorMap* map, const void* ptr, int B, int H, int T, int HD, int box_rows) {
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
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * sizeof(bf16),
                                 static_cast<cuuint64_t>(H) * HD * sizeof(bf16)};
  const cuuint32_t box[3] = {BOX, 1, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERROR + static_cast<int>(r);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool wide_shape_ok(int B, int H, int T, int D) {
  return B > 0 && H > 0 && T > 0 && T % 64 == 0 && D > MAX_D && D % WK == 0 &&
         static_cast<long long>(B) * H <= 65535;
}

// Whether an f32 kernel can split its nkt tiles (keys of the forwards and
// dQ, queries of dK/dV) nsplit ways (every split non-empty, scratch given);
// its tiles a split, or 0.
int split_tiles(int nkt, int nsplit, const void* part) {
  if (nsplit < 1 || nsplit > 32 || nsplit > nkt || (nsplit > 1 && part == nullptr)) return 0;
  const int tps = (nkt + nsplit - 1) / nsplit;
  return (nkt + tps - 1) / tps == nsplit ? tps : 0;
}

}  // namespace

extern "C" {

// All tensors contiguous: q, k, v, out, dout, dq, dk, dv [B, T, H, D] in
// bf16 (is_bf16 = 1) or f32; seg [B, T] int32 (keys and queries attend
// where their ids are equal); lse, delta [B, H, T] f32.  T % 64 == 0; these
// three take D in {64, 128, 224, 256}, the _wide ones below any multiple of
// 64 past 256 (the caller zero-pads other head dims); pointers 16-byte
// aligned.  The f32 forwards split the keys nsplit ways (1 <= nsplit <= 32,
// every split non-empty: 32-key tiles), with nsplit * B * H * T * (D + 2)
// floats of scratch at `part` when nsplit > 1.
// Each returns the first cudaError_t (0 on success), cudaErrorInvalidValue
// for a shape it does not take, or TMAP_ERROR + the CUresult of a failed
// tensor-map encode.

int flash_fwd(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse,
              int B, int H, int T, int D, float sm_scale, int is_bf16, int nsplit, void* part,
              void* stream) {
  if (!shape_ok(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!aligned16(seg)) return static_cast<int>(cudaErrorMisalignedAddress);
    return by_width(D, [&](auto width) {
      constexpr int HD = decltype(width)::value;
      using L = FwdLayout<HD>;
      CUtensorMap mq, mk, mv;
      int e;
      if ((e = bf16_map(&mq, q, B, H, T, HD, L::M)) || (e = bf16_map(&mk, k, B, H, T, HD, L::N)) ||
          (e = bf16_map(&mv, v, B, H, T, HD, L::N)))
        return e;
      return launch(flash_fwd_bf16<HD>, dim3((T + L::M - 1) / L::M, B * H), 3 * WG, L::SMEM, s, mq,
                    mk, mv, seg, out, lse, H, T, sm_scale * LOG2E);
    });
  }
  const int tps = split_tiles(T / XK, nsplit, part);
  if (tps == 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_width(D, [&](auto width) {
    constexpr int HD = decltype(width)::value;
    float* part_o = nsplit > 1 ? static_cast<float*>(part) : nullptr;
    float* part_ml = nsplit > 1 ? part_o + static_cast<size_t>(nsplit) * B * H * T * HD : nullptr;
    const int e = launch(flash_fwd_f32<HD>, dim3((T + XQ - 1) / XQ, B * H, nsplit), XT,
                         x_smem<HD>(), s, q, k, v, seg, out, lse, part_o, part_ml, H, T, tps,
                         sm_scale * LOG2E);
    if (e != 0 || nsplit == 1) return e;
    return launch(flash_fwd_f32_merge, dim3(T / 8, B * H), 256, 0, s, part_o, part_ml, out, lse,
                  H, T, HD, nsplit);
  });
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* seg, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int B, int H, int T,
                  int D, float sm_scale, int is_bf16, void* stream) {
  if (!shape_ok(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!aligned16(seg) || !aligned16(lse) || !aligned16(delta))
      return static_cast<int>(cudaErrorMisalignedAddress);
    return by_width(D, [&](auto width) {
      constexpr int HD = decltype(width)::value;
      using L = DkvLayout<HD>;
      CUtensorMap mq, mk, mv, mdo;
      int e;
      if ((e = bf16_map(&mq, q, B, H, T, HD, L::BQ)) ||
          (e = bf16_map(&mk, k, B, H, T, HD, L::BK)) ||
          (e = bf16_map(&mv, v, B, H, T, HD, L::BK)) ||
          (e = bf16_map(&mdo, dout, B, H, T, HD, L::BQ)))
        return e;
      return launch(flash_bwd_dkv_bf16<HD>, dim3(T / L::BK, B * H), 3 * WG, L::SMEM, s, mq, mk,
                    mv, mdo, seg, lse, delta, dk, dv, H, T, sm_scale * LOG2E, sm_scale);
    });
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(seg) ||
      !aligned16(lse) || !aligned16(delta))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return by_width(D, [&](auto width) {
    constexpr int HD = decltype(width)::value;
    return launch(flash_bwd_dkv_f32<HD>, dim3(T / FB_ROWS, B * H), BT, DkvF32<HD>::SMEM, s, q, k,
                  v, seg, dout, lse, delta, dk, dv, H, T, sm_scale * LOG2E, sm_scale);
  });
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* seg, const void* dout,
                 const void* lse, const void* delta, void* dq, int B, int H, int T, int D,
                 float sm_scale, int is_bf16, void* stream) {
  if (!shape_ok(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!aligned16(seg)) return static_cast<int>(cudaErrorMisalignedAddress);
    return by_width(D, [&](auto width) {
      constexpr int HD = decltype(width)::value;
      using L = DqLayout<HD>;
      CUtensorMap mq, mk, mv, mdo;
      int e;
      if ((e = bf16_map(&mq, q, B, H, T, HD, L::M)) || (e = bf16_map(&mk, k, B, H, T, HD, L::N)) ||
          (e = bf16_map(&mv, v, B, H, T, HD, L::N)) ||
          (e = bf16_map(&mdo, dout, B, H, T, HD, L::M)))
        return e;
      return launch(flash_bwd_dq_bf16<HD>, dim3((T + L::M - 1) / L::M, B * H), 3 * WG, L::SMEM, s,
                    mq, mk, mv, mdo, seg, lse, delta, dq, H, T, sm_scale * LOG2E, sm_scale);
    });
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(seg) ||
      !aligned16(lse) || !aligned16(delta))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return by_width(D, [&](auto width) {
    constexpr int HD = decltype(width)::value;
    return launch(flash_bwd_dq_f32<HD>, dim3(T / FB_ROWS, B * H), BT, DqF32<HD>::SMEM, s, q, k, v,
                  seg, dout, lse, delta, dq, H, T, sm_scale * LOG2E, sm_scale);
  });
}

// The wide kernels: as above, for a head dim D > 256 that is a multiple of
// 64 (the caller zero-pads other head dims).  The forwards and dK/dV take
// blockIdx.z chunks of WCH columns (in f32 times nsplit key or query
// splits), the bf16 dQ pairs of them, the f32 dQ chunks of dq_f32_chunk(D)
// columns times nsplit key splits.  The f32 dK/dV splits the queries nsplit
// ways (1 <= nsplit <= 32, every split non-empty: 16-query tiles), with 2 *
// nsplit * B * H * T * D floats of scratch at `part` when nsplit > 1; the
// f32 dQ the keys (16-key tiles), with nsplit * B * H * T * D floats.  The
// bf16 dK/dV and dQ take nsplit = 1.
int flash_fwd_wide(const void* q, const void* k, const void* v, const void* seg, void* out,
                   void* lse, int B, int H, int T, int D, float sm_scale, int is_bf16, int nsplit,
                   void* part, void* stream) {
  if (!wide_shape_ok(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(seg))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (D + WCH - 1) / WCH;
  if (is_bf16) {
    const WidePlan p = wide_plan(D, WIDE_FWD);
    if (p.stages < 1 || p.smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap mq, mk, mv;
    int e;
    if ((e = bf16_map(&mq, q, B, H, T, D, WQ)) || (e = bf16_map(&mk, k, B, H, T, D, 64)) ||
        (e = bf16_map(&mv, v, B, H, T, D, 64)))
      return e;
    return launch(wide_fwd_bf16, dim3((T + WQ - 1) / WQ, B * H, nc), 3 * WG, p.smem, s, mq, mk, mv,
                  seg, out, lse, H, T, D, p, sm_scale * LOG2E);
  }
  const int tps = split_tiles(T / WN, nsplit, part);
  if (tps == 0 || nc * nsplit > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* part_o = nsplit > 1 ? static_cast<float*>(part) : nullptr;
  float* part_ml = nsplit > 1 ? part_o + static_cast<size_t>(nsplit) * B * H * T * D : nullptr;
  const int e = launch(wide_fwd_f32, dim3((T + WQ - 1) / WQ, B * H, nc * nsplit), WT,
                       WideFwdF32::SMEM, s, q, k, v, seg, out, lse, part_o, part_ml, H, T, D, tps,
                       sm_scale * LOG2E);
  if (e != 0 || nsplit == 1) return e;
  return launch(flash_fwd_f32_merge, dim3(T / 8, B * H), 256, 0, s, part_o, part_ml, out, lse, H,
                T, D, nsplit);
}

int flash_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* seg,
                       const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                       int B, int H, int T, int D, float sm_scale, int is_bf16, int nsplit,
                       void* part, void* stream) {
  if (!wide_shape_ok(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(seg) ||
      !aligned16(lse) || !aligned16(delta))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (D + WCH - 1) / WCH;
  if (is_bf16) {
    const WidePlan p = wide_plan(D, WIDE_DKV);
    if (p.stages < 1 || p.smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap mq, mk, mv, mdo;
    int e;
    if ((e = bf16_map(&mq, q, B, H, T, D, 64)) || (e = bf16_map(&mk, k, B, H, T, D, 64)) ||
        (e = bf16_map(&mv, v, B, H, T, D, 64)) || (e = bf16_map(&mdo, dout, B, H, T, D, 64)))
      return e;
    return launch(wide_dkv_bf16, dim3(T / 64, B * H, nc), 3 * WG, p.smem, s, mq, mk, mv, mdo, seg,
                  lse, delta, dk, dv, H, T, D, p, sm_scale * LOG2E, sm_scale);
  }
  const WidePlan p = wide_dkv_f32_plan(D);
  const int tps = split_tiles(T / FQ, nsplit, part);
  if (p.stages < 2 || tps == 0 || nc * nsplit > 65535 || !aligned16(part))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(B) * T * H * D;
  float* part_k = nsplit > 1 ? static_cast<float*>(part) : static_cast<float*>(dk);
  float* part_v = nsplit > 1 ? part_k + nsplit * n : static_cast<float*>(dv);
  const int e = launch(wide_dkv_f32, dim3(T / FK, B * H, nc * nsplit), WT, p.smem, s, q, k, v, seg,
                       dout, lse, delta, part_k, part_v, nsplit > 1 ? n : 0, H, T, D, p, tps,
                       sm_scale * LOG2E, sm_scale);
  if (e != 0 || nsplit == 1) return e;
  return launch(wide_dkv_f32_merge, dim3(static_cast<unsigned>((n / 4 + 255) / 256), 2), 256, 0, s,
                part_k, dk, dv, n, nsplit);
}

int flash_bwd_dq_wide(const void* q, const void* k, const void* v, const void* seg,
                      const void* dout, const void* lse, const void* delta, void* dq, int B,
                      int H, int T, int D, float sm_scale, int is_bf16, int nsplit, void* part,
                      void* stream) {
  if (!wide_shape_ok(B, H, T, D)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(seg) ||
      !aligned16(lse) || !aligned16(delta))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const WidePlan p = wide_plan(D, WIDE_DQ);
    if (p.stages < 1 || p.smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap mq, mk, mv, mdo;
    int e;
    if ((e = bf16_map(&mq, q, B, H, T, D, 64)) || (e = bf16_map(&mk, k, B, H, T, D, 64)) ||
        (e = bf16_map(&mv, v, B, H, T, D, 64)) || (e = bf16_map(&mdo, dout, B, H, T, D, 64)))
      return e;
    return launch(wide_dq_bf16, dim3(T / 64, B * H, (D + 2 * WCH - 1) / (2 * WCH)), 3 * WG, p.smem,
                  s, mq, mk, mv, mdo, seg, lse, delta, dq, H, T, D, p, sm_scale * LOG2E, sm_scale);
  }
  const WidePlan p = wide_dq_f32_plan(D);
  const int nc = (D + dq_f32_chunk(D) - 1) / dq_f32_chunk(D);
  const int tps = split_tiles(T / DQ_N, nsplit, part);
  if (p.stages < 2 || tps == 0 || nc * nsplit > 65535 || !aligned16(part))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(B) * T * H * D;
  float* out = nsplit > 1 ? static_cast<float*>(part) : static_cast<float*>(dq);
  const int e = launch(wide_dq_f32, dim3(T / DQ_Q, B * H, nc * nsplit), WT, p.smem, s, q, k, v, seg,
                       dout, lse, delta, out, nsplit > 1 ? n : 0, H, T, D, p, tps,
                       sm_scale * LOG2E, sm_scale);
  if (e != 0 || nsplit == 1) return e;
  return launch(wide_dq_f32_merge, dim3(static_cast<unsigned>((n / 4 + 255) / 256)), 256, 0, s,
                part, dq, n, nsplit);
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
