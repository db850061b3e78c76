// Backward recurrence of D stacked GRU directions for Hopper (sm_90a), in
// f32, with torch nn.GRU gates and h0 = 0.  For t = T - 1 down to 0, with
// dh = 0 before the first step:
//
//   r, z, n from gi_t and gh_t = h_{t-1} . w_hh + b_hh, h_n = gh_t's n part
//   g      = dy_t + dh                          (the total gradient on h_t)
//   dn     = (1 - z) * (1 - n * n)
//   dgh_t  = g * [dn h_n r (1 - r), (h_{t-1} - n) z (1 - z), dn r]
//          = [dr_pre, dz_pre, dhn]
//   dgi_t  = [dr_pre, dz_pre, g * dn]
//   dh     = g * z + dgh_t . w_hh^T              (the gradient on h_{t-1})
//
// gh (recomputed for all T by one matmul), dw_hh = sum hprev^T dgh and
// db_hh = sum dgh are large products outside the loop, in ops/gru.py, as the
// JAX package leaves them to XLA outside its scan.  expf and tanhf are the
// accurate ones: the library is built without --use_fast_math.
//
// Replaces: the reverse lax.scan of _gru_stacked_bwd
// (wavthruvec_pytorch_tpu/models/layers.py:795-840, the scan at :829), the
// custom VJP of both the Pallas forward (gru_impl="pallas") and JAX's scan.
// Not a Pallas kernel; on the card it is one.  f32 throughout, as JAX's VJP
// is for both numerics.
//
// What bounds it on an H100: as for the f32 forward (gru_fwd.cu), the
// products of a step, 2*D*B*3H*H = 201 MFLOP at D = 2, B = 16, H = 1024, on
// the CUDA cores (FFMA, 67 TFLOP/s: ~3 us a step), and the serial chain:
// dh_{t-1} needs all 3H columns of dgh_t of its direction, so a step costs
// at least one exchange of dgh_t through L2 and a grid-wide barrier.
//
// Two routes, chosen by shape in ops/gru.py (gru_bwd_plan):
//
//   * persistent: ONE cooperative launch runs all T steps, on the f32
//     forward's grid and per-direction barrier.  Each block owns U hidden
//     units of one direction and keeps their rows w_hh[d, units, :] ([U][3H]
//     f32, 197,120 bytes with padding at U = 16, H = 1024: 128 blocks for the
//     card's 132 SMs) in shared memory for the whole launch.  A step in one
//     block, BT <= 16 batch rows a pass (one pass up to B = 16):
//       1. (t < T - 1) the product dgh_{t+1} . w_hh^T for its units: dgh_{t+1}
//          of the direction is the exchange, written by every block of the
//          direction in the previous step into the output dgh itself (each
//          t has its own slot: no double buffer, no second write).  It
//          streams from L2 through two 16 KB cp.async stages (one lands while
//          the other is multiplied).  Lane (rq, kq) of warp w takes the rows
//          rq, rq + 4, ... (U/4 of them) and 4 of the 256 columns of each
//          slab: U/4 x BT sums from U/4 + BT 16-byte loads of shared memory a
//          slab, FFMA.  The 8 kq lanes' sums are reduce-scattered by
//          shuffles and the 8 warps' added through shared memory (where the
//          stages lie);
//       2. thread (row, unit) of the pass: dh = g_{t+1} z_{t+1} (carried in a
//          register) + that sum; the gates from gi_t, gh_t, h_{t-1} and dy_t
//          (8 floats, loaded into registers while the block waited at the
//          previous barrier); dgh_t and dgi_t written;
//       3. the arrival at the direction's barrier, the next step's 8 floats
//          loaded, the wait.
//     No input and no carry takes shared memory, so its size does not
//     depend on B; a thread holds them for up to B_PASSES passes.
//     cudaLaunchCooperativeKernel guarantees that every block is resident
//     (or refuses the launch, which the caller raises on: nothing falls back).
//   * steps (shapes whose rows do not fit, or more blocks than SMs, or more
//     passes than a thread holds): one launch a time step, the host loop in
//     C; one warp owns hidden unit j of one direction, computes its dot
//     products with dgh_{t+1} from w_hh read through L2, reduces them with
//     shuffles and finishes the unit; g z is carried in a [D, B, H] scratch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_common.cuh"
#include "hopper.cuh"

namespace {

using gru::barrier_arrive;
using gru::barrier_wait;
using gru::halve;
using gru::sigmoidf;
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

// The inputs of one (batch row, unit) at one step, in this order
enum { GI_R, GI_Z, GI_N, GH_R, GH_Z, GH_N, HPREV, DY, N_IN };

// The step of one (batch row b, unit j) from its inputs x and the carried
// gradient dh on h_t: writes dgh_t = [dr_pre, dz_pre, dhn] and dgi_t =
// [dr_pre, dz_pre, dn_pre] at their row (3H columns) and returns g * z, the
// part of dh_{t-1} without the product.  The products' order is
// gru_bwd_loop_plain's (ops/gru.py).
__device__ __forceinline__ float unit_step(const float (&x)[N_IN], float dh, float* dgh_row,
                                           float* dgi_row, int j, int H) {
  const float g = x[DY] + dh;
  const float r = sigmoidf(x[GI_R] + x[GH_R]);
  const float z = sigmoidf(x[GI_Z] + x[GH_Z]);
  const float hn = x[GH_N];
  const float n = tanhf(x[GI_N] + r * hn);
  const float dn = (1.f - z) * (1.f - n * n);
  const float dr = dn * hn * r * (1.f - r) * g;
  const float dz = (x[HPREV] - n) * z * (1.f - z) * g;
  dgh_row[j] = dr;
  dgh_row[H + j] = dz;
  dgh_row[2 * H + j] = dn * r * g;
  dgi_row[j] = dr;
  dgi_row[H + j] = dz;
  dgi_row[2 * H + j] = g * dn;
  return g * z;
}

// ===========================================================================
// persistent route
// ===========================================================================

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLAB = 256;      // columns of a slab: 8 warps x 8 k lanes x 4
constexpr int STAGE = 4096;    // floats of a dgh stage: 16 KB; two of them
constexpr int ROW_PAD = 8;     // floats after each w row: 8 rows of a quarter warp in distinct banks
constexpr int B_PASSES = 4;    // batch-row passes whose inputs and carry a thread holds

// Shared memory of the persistent kernel, in bytes (ops/gru.py
// persistent_bwd_smem computes the same): the w rows [U][3H + 8] f32 and the
// two dgh stages, where the warps' partial sums [WARPS][BT][U] also lie.
__host__ __device__ inline size_t persistent_bwd_smem(int U, int H) {
  return 4 * (static_cast<size_t>(U) * (3 * static_cast<size_t>(H) + ROW_PAD) + 2 * STAGE);
}

// The batch rows of a pass: the smallest power of two that covers min(B, 16),
// at most 8 above U = 16, where a lane's U/4 x BT sums would pass 64
// registers and a pass's BT x U (row, unit) pairs the block's 256 threads
__host__ __device__ inline int bwd_batch_tile(int U, int B) {
  const int cap = U <= 16 ? 16 : 8;
  int bt = 1;
  while (bt < cap && bt < B) bt *= 2;
  return bt;
}

// One block per (direction, U consecutive hidden units); grid D * nbd.  BT
// is the batch rows of a pass.  dy, hprev [D, B, T, H]; gi, gh [D, B, T, 3H];
// w [D, H, 3H] (JAX's w_hh layout); dgi, dgh [D, B, T, 3H], written (dgh is
// also the exchange); counter [D] zeroed.  B <= B_PASSES * BT.
template <int U, int BT>
__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_persistent_kernel(const float* __restrict__ dy, const float* __restrict__ gi,
                          const float* __restrict__ gh, const float* __restrict__ hprev,
                          const float* __restrict__ w, float* __restrict__ dgi,
                          float* __restrict__ dgh, unsigned* __restrict__ counter, int D, int B,
                          int T, int H, int nbd) {
  constexpr int RL = U / 4;                  // rows of a lane: rq, rq + 4, ...
  constexpr int N = RL * BT;                 // a lane's partial sums
  constexpr int G = STAGE / (BT * SLAB);     // slabs a stage holds: [G][BT][256]
  static_assert(BT * U <= THREADS, "a pass's (row, unit) pairs must fit the block");
  extern __shared__ __align__(16) unsigned char smem[];
  const int H3 = 3 * H, wp = H3 + ROW_PAD;
  float* ws = reinterpret_cast<float*>(smem);
  float* stages = ws + U * wp;  // two stages; then, in them, the partial sums [WARPS][BT][U]

  const int d = blockIdx.x / nbd;
  const int j0 = (blockIdx.x % nbd) * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a quarter warp (8 lanes) reads 4 w rows at 2 chunks, 8 distinct bank
  // groups with rows 3H + 8 floats apart (H % 32 == 0), and 2 dgh chunks
  const int rq = lane & 3, kq = lane >> 2;
  const int kl = 32 * warp + 4 * kq;  // the lane's 4 columns of each slab
  const int cpr = H3 / 4;             // 16-byte chunks of an f32 row of w
  const int nstage = ((H3 + SLAB - 1) / SLAB + G - 1) / G;  // stages of a pass
  const size_t bstride = static_cast<size_t>(T) * H3;      // between batch rows of dgh
  unsigned* ctr = counter + d;

  // the block's rows of w, local row u <- row j0 + u of direction d
  for (int i = tid; i < U * cpr; i += THREADS) {
    const int u = i / cpr, c = (i - u * cpr) * 4;
    const bool in = j0 + u < H;
    cp_async16(smem_u32(ws + u * wp + c),
               w + (static_cast<size_t>(d) * H + (in ? j0 + u : 0)) * H3 + c, in ? 16u : 0u);
  }
  cp_async_commit();

  // this thread's (batch row pr of each pass, unit j): its inputs of step t
  // and its carry, of pass p in registers
  const int pr = tid / U, pu = tid - pr * U, j = j0 + pu;
  const bool owner = tid < BT * U && j < H;
  float xin[B_PASSES][N_IN], gz[B_PASSES];
  auto load_inputs = [&](int t) {
#pragma unroll
    for (int p = 0; p < B_PASSES; ++p) {
      const int b = p * BT + pr;
      if (owner && b < B) {
        const size_t row = (static_cast<size_t>(d) * B + b) * T + t;
        const float* gir = gi + row * H3 + j;
        const float* ghr = gh + row * H3 + j;
        xin[p][GI_R] = __ldg(gir);
        xin[p][GI_Z] = __ldg(gir + H);
        xin[p][GI_N] = __ldg(gir + 2 * H);
        xin[p][GH_R] = __ldg(ghr);
        xin[p][GH_Z] = __ldg(ghr + H);
        xin[p][GH_N] = __ldg(ghr + 2 * H);
        xin[p][HPREV] = __ldg(hprev + row * H + j);
        xin[p][DY] = __ldg(dy + row * H + j);
      }
    }
  };
  load_inputs(T - 1);
#pragma unroll
  for (int p = 0; p < B_PASSES; ++p) gz[p] = 0.f;  // dh = 0 before the first step
  float* red = stages;  // the warps' partial sums, once a pass's stages are multiplied
  cp_async_wait<0>();   // w
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int pass = 0, bb0 = 0; bb0 < B; ++pass, bb0 += BT) {
      if (t + 1 < T) {
        // stage q of the pass: dgh_{t+1} of rows bb0 .. bb0 + BT - 1 at slabs
        // q * G ... q * G + G - 1, four 16-byte cp.async a thread (L2 only:
        // other blocks wrote these rows in this launch); zeros past B and 3H
        const float* src = dgh + (static_cast<size_t>(d) * B * T + (t + 1)) * H3;
        auto issue = [&](int q) {
          if (q < nstage) {
#pragma unroll
            for (int i = 0; i < STAGE / 4 / THREADS; ++i) {
              const int idx = tid + i * THREADS;
              const int c = 4 * (idx % (SLAB / 4)), rem = idx / (SLAB / 4);
              const int k = (q * G + rem / BT) * SLAB + c, b = bb0 + rem % BT;
              const bool in = k < H3 && b < B;
              cp_async16(smem_u32(stages + (q & 1) * STAGE + 4 * idx),
                         src + (in ? b * bstride + k : 0), in ? 16u : 0u);
            }
          }
          cp_async_commit();  // an empty group past the last stage keeps the count
        };
        float acc[N];  // acc[jj * BT + bb]: row rq + 4 jj, batch row bb0 + bb
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = 0.f;
        issue(0);
        for (int q = 0; q < nstage; ++q) {
          cp_async_wait<0>();  // stage q has landed ...
          __syncthreads();     // ... for every thread, and q - 1's buffer is free
          issue(q + 1);
          const float* st = stages + (q & 1) * STAGE;
#pragma unroll
          for (int s = 0; s < G; ++s) {
            const int k = (q * G + s) * SLAB + kl;
            if (k < H3) {
              float4 wv[RL];
#pragma unroll
              for (int jj = 0; jj < RL; ++jj)
                wv[jj] = *reinterpret_cast<const float4*>(ws + (rq + 4 * jj) * wp + k);
#pragma unroll
              for (int bb = 0; bb < BT; ++bb) {
                const float4 h = *reinterpret_cast<const float4*>(st + (s * BT + bb) * SLAB + kl);
#pragma unroll
                for (int jj = 0; jj < RL; ++jj) {
                  float a = acc[jj * BT + bb];
                  a = fmaf(h.x, wv[jj].x, a);
                  a = fmaf(h.y, wv[jj].y, a);
                  a = fmaf(h.z, wv[jj].z, a);
                  acc[jj * BT + bb] = fmaf(h.w, wv[jj].w, a);
                }
              }
            }
          }
        }
        __syncthreads();  // every warp is past the stages, where red lies
        // the 8 kq lanes of a row (lane bits 2-4) hold the sums of other k:
        // reduce-scatter them where 8 divides N (each lane ends with N / 8
        // whole sums), else add them all everywhere
        if constexpr (N % 8 == 0) {
          halve<N, 4>(acc, lane);
          halve<N / 2, 8>(acc, lane);
          halve<N / 4, 16>(acc, lane);
          const int base = (kq & 1) * (N / 2) + ((kq >> 1) & 1) * (N / 4) + (kq >> 2) * (N / 8);
#pragma unroll
          for (int i = 0; i < N / 8; ++i) {
            const int o = base + i;
            red[(warp * BT + o % BT) * U + rq + 4 * (o / BT)] = acc[i];
          }
        } else {
#pragma unroll
          for (int o = 0; o < N; ++o) {
            float v = acc[o];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (o % 8 == kq) red[(warp * BT + o % BT) * U + rq + 4 * (o / BT)] = v;
          }
        }
        __syncthreads();
      }

      const int b = bb0 + pr;
      if (owner && b < B) {
        float x[N_IN], dh = 0.f;
#pragma unroll
        for (int p = 0; p < B_PASSES; ++p) {
          if (p == pass) {
#pragma unroll
            for (int i = 0; i < N_IN; ++i) x[i] = xin[p][i];
            dh = gz[p];
          }
        }
        if (t + 1 < T) {
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < WARPS; ++v) s += red[(v * BT + pr) * U + pu];
          dh += s;
        }
        const size_t row = (static_cast<size_t>(d) * B + b) * T + t;
        const float next = unit_step(x, dh, dgh + row * H3, dgi + row * H3, j, H);
#pragma unroll
        for (int p = 0; p < B_PASSES; ++p)
          if (p == pass) gz[p] = next;
      }
      __syncthreads();  // the pass's dgh is written; red is free again
    }
    if (t > 0) {
      barrier_arrive(ctr);
      load_inputs(t - 1);  // while the other blocks arrive
      barrier_wait(ctr, static_cast<unsigned>(T - t) * nbd);
    }
  }
}

template <int U, int BT>
cudaError_t launch_persistent(const float* dy, const float* gi, const float* gh,
                              const float* hprev, const float* w, float* dgi, float* dgh,
                              unsigned* counter, int D, int B, int T, int H, size_t smem,
                              cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(gru_bwd_persistent_kernel<U, BT>);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int nbd = (H + U - 1) / U;
  void* args[] = {&dy, &gi, &gh, &hprev, &w, &dgi, &dgh, &counter, &D, &B, &T, &H, &nbd};
  return cudaLaunchCooperativeKernel(fn, dim3(D * nbd), dim3(THREADS), args, smem, stream);
}

template <int U>
cudaError_t launch_persistent_bt(const float* dy, const float* gi, const float* gh,
                                 const float* hprev, const float* w, float* dgi, float* dgh,
                                 unsigned* counter, int D, int B, int T, int H, size_t smem,
                                 cudaStream_t stream) {
  const int bt = bwd_batch_tile(U, B);
  if (B > B_PASSES * bt) return cudaErrorInvalidValue;
  switch (bt) {
    case 1: return launch_persistent<U, 1>(dy, gi, gh, hprev, w, dgi, dgh, counter, D, B, T, H,
                                           smem, stream);
    case 2: return launch_persistent<U, 2>(dy, gi, gh, hprev, w, dgi, dgh, counter, D, B, T, H,
                                           smem, stream);
    case 4: return launch_persistent<U, 4>(dy, gi, gh, hprev, w, dgi, dgh, counter, D, B, T, H,
                                           smem, stream);
    case 8: return launch_persistent<U, 8>(dy, gi, gh, hprev, w, dgi, dgh, counter, D, B, T, H,
                                           smem, stream);
    default:
      if constexpr (U <= 16)
        return launch_persistent<U, 16>(dy, gi, gh, hprev, w, dgi, dgh, counter, D, B, T, H,
                                        smem, stream);
      return cudaErrorInvalidValue;
  }
}

// ===========================================================================
// steps route: one launch a time step
// ===========================================================================

constexpr int S_WARPS = 8;  // hidden units per block, one warp each
constexpr int S_ROWS = 4;   // batch rows accumulated per pass over the w row

// Step t.  dgh: rows t + 1 .. T - 1 already written; gz [D, B, H]: g z of
// step t + 1 (read unless t = T - 1), replaced by step t's.
__global__ void __launch_bounds__(S_WARPS * 32)
gru_bwd_step_kernel(const float* __restrict__ dy, const float* __restrict__ gi,
                    const float* __restrict__ gh, const float* __restrict__ hprev,
                    const float* __restrict__ w, float* __restrict__ dgi,
                    float* __restrict__ dgh, float* __restrict__ gz, int B, int T, int H, int t) {
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * S_WARPS + threadIdx.x / 32;
  const int d = blockIdx.y;
  if (j >= H) return;
  const int H3 = 3 * H;
  const float* wj = w + (static_cast<size_t>(d) * H + j) * H3;

  for (int b0 = 0; b0 < B; b0 += S_ROWS) {
    float acc[S_ROWS];
#pragma unroll
    for (int bb = 0; bb < S_ROWS; ++bb) acc[bb] = 0.f;
    if (t + 1 < T) {
      for (int c = lane * 4; c < H3; c += 32 * 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wj + c);
#pragma unroll
        for (int bb = 0; bb < S_ROWS; ++bb) {
          const int b = b0 + bb;
          if (b >= B) break;
          const float4 h = *reinterpret_cast<const float4*>(
              dgh + ((static_cast<size_t>(d) * B + b) * T + t + 1) * H3 + c);
          float a = fmaf(h.x, wv.x, acc[bb]);
          a = fmaf(h.y, wv.y, a);
          a = fmaf(h.z, wv.z, a);
          acc[bb] = fmaf(h.w, wv.w, a);
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < S_ROWS; ++bb)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[bb] += __shfl_xor_sync(0xffffffffu, acc[bb], off);

    // lane bb finishes batch row b0 + bb (every lane holds every sum)
    float s = 0.f;
#pragma unroll
    for (int bb = 0; bb < S_ROWS; ++bb)
      if (bb == lane) s = acc[bb];
    const int b = b0 + lane;
    if (lane < S_ROWS && b < B) {
      const size_t row = (static_cast<size_t>(d) * B + b) * T + t;
      const float* gir = gi + row * H3 + j;
      const float* ghr = gh + row * H3 + j;
      const float x[N_IN] = {gir[0], gir[H], gir[2 * H], ghr[0], ghr[H], ghr[2 * H],
                             hprev[row * H + j], dy[row * H + j]};
      float* carry = gz + (static_cast<size_t>(d) * B + b) * H + j;
      const float dh = t + 1 < T ? *carry + s : 0.f;
      *carry = unit_step(x, dh, dgh + row * H3, dgi + row * H3, j, H);
    }
  }
}

}  // namespace

extern "C" {

// Persistent route.  dy, hprev: [D, B, T, H] f32 contiguous; gi, gh:
// [D, B, T, 3H] f32 contiguous; w: [D, H, 3H] f32 contiguous (JAX's w_hh);
// dgi, dgh: [D, B, T, 3H] f32, written; counter: [D] u32, zeroed.  H % 8 == 0;
// U (units a block) one of 8, 16, 24, 32; B at most 4 passes of the kernel's
// batch tile; smem must equal persistent_bwd_smem(U, H) (the planner's
// figure).  One cooperative launch on `stream`; returns its cudaError_t (0
// on success).
int gru_bwd_persistent(const void* dy, const void* gi, const void* gh, const void* hprev,
                       const void* w, void* dgi, void* dgh, void* counter, int D, int B, int T,
                       int H, int U, long long smem, void* stream) {
  if (static_cast<size_t>(smem) != persistent_bwd_smem(U, H) || H % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(dy);
  const float* g = static_cast<const float*>(gi);
  const float* h = static_cast<const float*>(gh);
  const float* p = static_cast<const float*>(hprev);
  const float* wt = static_cast<const float*>(w);
  float* oi = static_cast<float*>(dgi);
  float* oh = static_cast<float*>(dgh);
  unsigned* c = static_cast<unsigned*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  auto launch = [&](auto fn) {
    return static_cast<int>(fn(a, g, h, p, wt, oi, oh, c, D, B, T, H, sm, s));
  };
  switch (U) {
    case 8: return launch(launch_persistent_bt<8>);
    case 16: return launch(launch_persistent_bt<16>);
    case 24: return launch(launch_persistent_bt<24>);
    case 32: return launch(launch_persistent_bt<32>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Steps route: the arguments of gru_bwd_persistent with a scratch gz [D, B,
// H] f32 in place of the counter.  Issues T launches on `stream`; returns
// the first cudaError_t (0 on success).
int gru_bwd_steps(const void* dy, const void* gi, const void* gh, const void* hprev,
                  const void* w, void* dgi, void* dgh, void* gz, int D, int B, int T, int H,
                  void* stream) {
  if (H % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H + S_WARPS - 1) / S_WARPS, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = T - 1; t >= 0; --t) {
    gru_bwd_step_kernel<<<grid, S_WARPS * 32, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(gi),
        static_cast<const float*>(gh), static_cast<const float*>(hprev),
        static_cast<const float*>(w), static_cast<float*>(dgi), static_cast<float*>(dgh),
        static_cast<float*>(gz), B, T, H, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

const char* wtv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
