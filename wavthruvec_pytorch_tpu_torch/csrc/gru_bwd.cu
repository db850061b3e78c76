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
// at least one exchange of dgh_t through L2 and a grid-wide barrier.  Every
// block of a direction reads the same rows of dgh_{t+1} at once, and that
// stream from L2 runs at ~20 GB/s an SM on the card (16-24 KB in flight):
// the part of the exchange a block reads sets its step as much as its FFMA.
//
// Two routes, chosen by shape in ops/gru.py (gru_bwd_plan):
//
//   * persistent: ONE launch runs all T steps, on the f32 forward's grid and
//     per-direction barrier, in clusters of two blocks (pairs).  A pair owns
//     2U consecutive hidden units of one direction (U each, 128 blocks at U =
//     16, H = 1024 for the card's 132 SMs), and block r of the pair keeps the
//     pair's 2U rows of w_hh[d, units, :] over its half of the 3H columns,
//     r * 3H/2 .. (r + 1) * 3H/2 - 1 (U x 3H f32 in all, 196,608 bytes), in
//     shared memory for the whole launch.  So a block streams half of
//     dgh_{t+1} a step, not all of it.  A step in one block, BT <= 16 batch
//     rows a pass (one pass up to B = 16):
//       1. (t < T - 1) its half of the product dgh_{t+1} . w_hh^T for the
//          pair's 2U rows: dgh_{t+1} of the direction is the exchange, written
//          by every block of the direction in the previous step into the
//          output dgh itself (each t has its own slot: no double buffer, no
//          second write).  Its half streams from L2 through two 16 KB
//          cp.async stages (one lands while the other is multiplied).  Lane
//          (kq, rq) of warp w of row group g takes the rows 16 g + rq + 4 jj
//          (jj < 4) and 4 of the columns of each slab (the group's warps
//          split a slab's columns): 4 x BT sums from 4 + BT 16-byte loads of
//          shared memory a slab, FFMA.  A quarter warp reads 8 consecutive
//          chunks of one row: no bank conflict, no row padding.  The 8 kq
//          lanes' sums are reduce-scattered by shuffles and the warps' added
//          through shared memory (where the stages lie);
//       2. the partner's half: each block sends the partner the sums of the
//          partner's units over its columns by st.async into the partner's
//          shared memory (two buffers by pass parity), each store completing
//          its bytes on the partner's mbarrier, which the partner announced
//          with expect_tx; the full sum is (columns 0 .. 3H/2 - 1) + (the
//          rest) in both blocks, in that order;
//       3. thread (row, unit) of the pass: dh = g_{t+1} z_{t+1} (carried in a
//          register) + that sum; the gates from gi_t, gh_t, h_{t-1} and dy_t
//          (8 floats, loaded into registers while the block waited at the
//          previous barrier); dgh_t and dgi_t written;
//       4. the arrival at the direction's barrier, the next step's 8 floats
//          loaded, the wait.
//     No input and no carry takes shared memory, so its size does not
//     depend on B; a thread holds them for up to B_PASSES passes.  The
//     launch carries the cluster dimension and the cooperative attribute,
//     after cudaOccupancyMaxActiveClusters has confirmed that the card holds
//     every pair at once (else it is refused, and the caller raises: nothing
//     falls back).  Tried on the card and dropped (PERF.md §6): TMA
//     multicast of the whole dgh_{t+1} to a cluster (clusters of 4 do not
//     all fit; the multicast stream ran slower than each block's own
//     copies), an mbarrier ring filled by TMA or by a producer warp's
//     cp.async (longer round trips than the block's own cp.async).
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
constexpr int PAIR = 2;        // blocks of a cluster: a pair splits the product's columns
constexpr int STAGE = 4096;    // floats of a dgh stage: 16 KB; two of them
constexpr int B_PASSES = 4;    // batch-row passes whose inputs and carry a thread holds
constexpr int MAX_BT = 16;     // batch rows of a pass, at most

// Shared memory of the persistent kernel, in bytes (ops/gru.py
// persistent_bwd_smem computes the same): the pair's 2U rows of w over the
// block's half of the 3H columns (U x 3H f32 in all), the two dgh stages
// (where the warps' partial sums also lie), the partner's partial sums
// [2][16][U] and two mbarriers for them.
__host__ __device__ inline size_t persistent_bwd_smem(int U, int H) {
  return 4 * (3 * static_cast<size_t>(U) * H + 2 * STAGE + 2 * MAX_BT * U) + 16;
}

// A direction's blocks: ceil(H / U), rounded up to whole pairs
inline int pair_blocks(int U, int H) { return PAIR * ((H + PAIR * U - 1) / (PAIR * U)); }

// The batch rows of a pass: the smallest power of two that covers min(B, 16)
__host__ __device__ inline int bwd_batch_tile(int B) {
  int bt = 1;
  while (bt < MAX_BT && bt < B) bt *= 2;
  return bt;
}

// One block per (direction, U consecutive hidden units); grid D * nbd in
// clusters of PAIR, nbd = pair_blocks(U, H): the pair's blocks own units p0
// .. p0 + U - 1 (rank 0) and p0 + U .. p0 + 2U - 1 (rank 1), units past H
// owning nothing (a direction's blocks are rounded up to whole pairs), and
// block r multiplies dgh_{t+1}'s columns r * 3H / 2 .. (r + 1) * 3H / 2 - 1
// by the rows of w of all 2U units.  BT is the batch rows of a pass.  dy, hprev [D, B, T,
// H]; gi, gh [D, B, T, 3H]; w [D, H, 3H] (JAX's w_hh layout); dgi, dgh [D,
// B, T, 3H], written (dgh is also the exchange); counter [D] zeroed.  B <=
// B_PASSES * BT.
template <int U, int BT>
__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_persistent_kernel(const float* __restrict__ dy, const float* __restrict__ gi,
                          const float* __restrict__ gh, const float* __restrict__ hprev,
                          const float* __restrict__ w, float* __restrict__ dgi,
                          float* __restrict__ dgh, unsigned* __restrict__ counter, int D, int B,
                          int T, int H, int nbd) {
  constexpr int UP = PAIR * U;      // the pair's units: the rows of the product
  constexpr int NG = UP / 16;       // row groups of 16: 4 row lanes x 4 rows
  constexpr int WG = WARPS / NG;    // warps of a group, splitting a slab's columns
  constexpr int SW = 32 * WG;       // columns of a slab: WG warps x 8 k lanes x 4
  constexpr int RL = 4;             // rows of a lane: rq, rq + 4, ... of its group
  constexpr int N = RL * BT;        // a lane's partial sums
  constexpr int SC = STAGE / BT;    // columns of a stage: [BT][SC]
  constexpr int G = SC / SW;        // slabs of a stage
  static_assert(UP % 16 == 0 && WARPS % NG == 0, "row groups of 16 over the 8 warps");
  static_assert(G >= 1 && WG * BT * UP <= 2 * STAGE, "slabs of a stage; the sums in the stages");
  static_assert(BT * U <= THREADS, "a pass's (row, unit) pairs must fit the block");
  extern __shared__ __align__(16) unsigned char smem[];
  const int H3 = 3 * H, KC = H3 / PAIR;          // the block's columns of dgh
  float* ws = reinterpret_cast<float*>(smem);    // [UP][KC]
  float* stages = ws + static_cast<size_t>(UP) * KC;  // two; the partial sums [WG][BT][UP] in them
  float* xred = stages + 2 * STAGE;              // the partner's sums [2][16][U]
  uint64_t* xfull = reinterpret_cast<uint64_t*>(xred + 2 * MAX_BT * U);  // [2]

  const int rank = static_cast<int>(gru::cluster_rank()), other = rank ^ 1;
  const int d = blockIdx.x / nbd;
  const int p0 = (blockIdx.x % nbd - rank) * U;  // the pair's first unit
  const int j0 = p0 + rank * U;                  // this block's units
  const int k0 = rank * KC;                      // this block's columns
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nstage = (KC + SC - 1) / SC;         // stages of a pass
  const size_t bstride = static_cast<size_t>(T) * H3;  // between batch rows of dgh
  unsigned* ctr = counter + d;
  gru::Stamps prof;

  // the pair's rows of w over this block's columns: local row u <- row p0 + u
  const int cpr = KC / 4;  // 16-byte chunks of a local row
  for (int i = tid; i < UP * cpr; i += THREADS) {
    const int u = i / cpr, c = (i - u * cpr) * 4;
    const bool in = p0 + u < H;
    cp_async16(smem_u32(ws + static_cast<size_t>(u) * KC + c),
               w + (static_cast<size_t>(d) * H + (in ? p0 + u : 0)) * H3 + k0 + c, in ? 16u : 0u);
  }
  cp_async_commit();
  if (tid == 0) {  // one arrival (this block's expect_tx) and the partner's bytes a phase
    hopper::mbar_init(smem_u32(xfull), 1);
    hopper::mbar_init(smem_u32(xfull + 1), 1);
    hopper::mbar_init_fence();
  }

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
  cp_async_wait<0>();   // w
  gru::cluster_sync();  // w and the barriers, in both blocks of the pair
  prof.mark(gru::PROF_BARRIER);

  // a quarter warp (8 lanes, one rq) reads 8 consecutive 16-byte chunks of
  // one w row and of one dgh row: every bank once, whatever the row stride
  const int kq = lane & 7, rq = lane >> 3;
  const int grp = warp / WG, wk = warp % WG;
  const int kl = 32 * wk + 4 * kq;     // the lane's 4 columns of each slab
  const int row_base = 16 * grp + rq;  // the lane's rows: row_base + 4 jj
  float* red = stages;
  int np = 0;  // passes run: the partner's sums alternate between two buffers

  for (int t = T - 1; t >= 0; --t) {
    for (int pass = 0, bb0 = 0; bb0 < B; ++pass, bb0 += BT) {
      float sum = 0.f;  // the product's sum for this thread's (row, unit)
      if (t + 1 < T) {
        // stage q of the pass: dgh_{t+1} of rows bb0 .. bb0 + BT - 1 at this
        // block's columns q * SC .. q * SC + SC - 1, four 16-byte cp.async a
        // thread (L2 only: other blocks wrote these rows in this launch);
        // zeros past B and past the block's columns
        const float* src = dgh + (static_cast<size_t>(d) * B * T + (t + 1)) * H3 + k0;
        auto issue = [&](int q) {
          if (q < nstage) {
#pragma unroll
            for (int i = 0; i < STAGE / 4 / THREADS; ++i) {
              const int idx = tid + i * THREADS;
              const int c = 4 * (idx % (SC / 4)), r = idx / (SC / 4);
              const int k = q * SC + c, b = bb0 + r;
              const bool in = k < KC && b < B;
              cp_async16(smem_u32(stages + (q & 1) * STAGE + 4 * idx),
                         src + (in ? b * bstride + k : 0), in ? 16u : 0u);
            }
          }
          cp_async_commit();  // an empty group past the last stage keeps the count
        };
        float acc[N];  // acc[jj * BT + bb]: row row_base + 4 jj, batch row bb0 + bb
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = 0.f;
        issue(0);
        for (int q = 0; q < nstage; ++q) {
          const unsigned long long w0 = prof.start();
          cp_async_wait<0>();  // stage q has landed ...
          __syncthreads();     // ... for every thread, and q - 1's buffer is free
          prof.nested(gru::PROF_WAITS, w0);
          issue(q + 1);
          const float* st = stages + (q & 1) * STAGE;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int k = q * SC + g * SW + kl;
            if (k < KC) {
              float4 wv[RL];
#pragma unroll
              for (int jj = 0; jj < RL; ++jj)
                wv[jj] = *reinterpret_cast<const float4*>(
                    ws + static_cast<size_t>(row_base + 4 * jj) * KC + k);
#pragma unroll
              for (int bb = 0; bb < BT; ++bb) {
                const float4 h = *reinterpret_cast<const float4*>(st + bb * SC + g * SW + kl);
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
        prof.mark(gru::PROF_STAGES);
        __syncthreads();  // every warp is past the stages, where red lies
        // the 8 kq lanes of a row (lane bits 0-2) hold the sums of other
        // columns: reduce-scatter them where 8 divides N (each lane ends
        // with N / 8 whole sums), else add them all everywhere
        if constexpr (N % 8 == 0) {
          halve<N, 1>(acc, lane);
          halve<N / 2, 2>(acc, lane);
          halve<N / 4, 4>(acc, lane);
          const int base = (kq & 1) * (N / 2) + ((kq >> 1) & 1) * (N / 4) + (kq >> 2) * (N / 8);
#pragma unroll
          for (int i = 0; i < N / 8; ++i) {
            const int o = base + i;
            red[(wk * BT + o % BT) * UP + row_base + 4 * (o / BT)] = acc[i];
          }
        } else {
#pragma unroll
          for (int o = 0; o < N; ++o) {
            float v = acc[o];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            if (o % 8 == kq) red[(wk * BT + o % BT) * UP + row_base + 4 * (o / BT)] = v;
          }
        }
        __syncthreads();
        // the partner's units: this block's half of their sums, into the
        // partner's buffer of this pass's parity by st.async, each store
        // completing its 4 bytes on the partner's barrier of that buffer
        const int buf = np & 1, rows = min(BT, B - bb0);
        if (tid == 0)  // this block's own buffer: announce the partner's bytes
          hopper::mbar_expect_tx(smem_u32(xfull + buf), 4u * static_cast<uint32_t>(rows * U));
        for (int i = tid; i < rows * U; i += THREADS) {
          const int bb = i / U, uu = i - bb * U;
          float v = 0.f;
#pragma unroll
          for (int q = 0; q < WG; ++q) v += red[(q * BT + bb) * UP + other * U + uu];
          gru::st_async_remote(smem_u32(xred + (buf * MAX_BT + bb) * U + uu),
                               smem_u32(xfull + buf), other, v);
        }
        if (owner && bb0 + pr < B) {
          float own = 0.f;
#pragma unroll
          for (int q = 0; q < WG; ++q) own += red[(q * BT + pr) * UP + rank * U + pu];
          hopper::mbar_wait(smem_u32(xfull + buf), (np >> 1) & 1);
          const float part = xred[(buf * MAX_BT + pr) * U + pu];
          sum = rank == 0 ? own + part : part + own;  // columns 0 .. 3H/2 - 1 first
        }
        ++np;
        prof.mark(gru::PROF_REDUCE);
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
        dh += sum;
        const size_t row = (static_cast<size_t>(d) * B + b) * T + t;
        const float next = unit_step(x, dh, dgh + row * H3, dgi + row * H3, j, H);
#pragma unroll
        for (int p = 0; p < B_PASSES; ++p)
          if (p == pass) gz[p] = next;
      }
      __syncthreads();  // the pass's dgh is written; red is free again
      prof.mark(gru::PROF_UNIT);
    }
    if (t > 0) {
      barrier_arrive(ctr);
      load_inputs(t - 1);  // while the other blocks arrive
      prof.mark(gru::PROF_ARRIVAL);
      barrier_wait(ctr, static_cast<unsigned>(T - t) * nbd);
      prof.mark(gru::PROF_BARRIER);
    }
  }
  gru::cluster_sync();  // no block leaves while its partner may still write to it
  prof.store();
}

// f(kernel) for the persistent kernel's instance of U units and B's batch tile
template <int U, typename F>
cudaError_t with_kernel_bt(int B, F&& f) {
  const int bt = bwd_batch_tile(B);
  if (B > B_PASSES * bt) return cudaErrorInvalidValue;
  switch (bt) {
    case 1: return f(gru_bwd_persistent_kernel<U, 1>);
    case 2: return f(gru_bwd_persistent_kernel<U, 2>);
    case 4: return f(gru_bwd_persistent_kernel<U, 4>);
    case 8: return f(gru_bwd_persistent_kernel<U, 8>);
    default: return f(gru_bwd_persistent_kernel<U, 16>);
  }
}

template <typename F>
cudaError_t with_kernel(int U, int B, F&& f) {
  switch (U) {
    case 8: return with_kernel_bt<8>(B, f);
    case 16: return with_kernel_bt<16>(B, f);
    default: return cudaErrorInvalidValue;
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
// U (units a block) 8 or 16; C (blocks a cluster) 2; B at most 4 passes of
// the kernel's batch tile; smem must equal persistent_bwd_smem(U, H) (the
// planner's figure).  One launch of D * pair_blocks(U, H) blocks on
// `stream`, in clusters of C with every block resident (refused otherwise);
// returns its cudaError_t (0 on success).
int gru_bwd_persistent(const void* dy, const void* gi, const void* gh, const void* hprev,
                       const void* w, void* dgi, void* dgh, void* counter, int D, int B, int T,
                       int H, int U, int C, long long smem, void* stream) {
  if (U <= 0 || static_cast<size_t>(smem) != persistent_bwd_smem(U, H) || H % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nbd = pair_blocks(U, H);
  if (C != PAIR) return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(dy);
  const float* g = static_cast<const float*>(gi);
  const float* h = static_cast<const float*>(gh);
  const float* p = static_cast<const float*>(hprev);
  const float* wt = static_cast<const float*>(w);
  float* oi = static_cast<float*>(dgi);
  float* oh = static_cast<float*>(dgh);
  unsigned* c = static_cast<unsigned*>(counter);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  return static_cast<int>(with_kernel(U, B, [&](auto kernel) {
    return gru_host::launch_clustered(kernel, D * nbd, THREADS, sm, C, s, a, g, h, p, wt, oi, oh,
                                      c, D, B, T, H, nbd);
  }));
}

// The clusters of C blocks of the persistent route's instance for (U, B)
// that the card can hold at once at `smem` bytes a block
// (cudaOccupancyMaxActiveClusters), into *n; returns a cudaError_t.
int gru_bwd_max_clusters(int D, int B, int H, int U, int C, long long smem, int* n) {
  const int nbd = U > 0 ? pair_blocks(U, H) : 0;
  return static_cast<int>(with_kernel(U, B, [&](auto kernel) {
    return gru_host::max_clusters(kernel, D * nbd, THREADS, static_cast<size_t>(smem), C, n);
  }));
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

GRU_PROF_READER
