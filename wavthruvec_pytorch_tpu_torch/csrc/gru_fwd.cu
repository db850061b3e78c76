// Forward recurrence of D stacked GRU directions for Hopper (sm_90a), with
// torch nn.GRU gates and h0 = 0, in two numerics:
//
//   bf16:  gh = bf16(h) . bf16(w_hh) + b_hh   (bf16 products, f32 accumulation)
//   f32:   gh = h . w_hh + b_hh               (f32 products, f32 sums)
//   r  = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z)
//   n  = tanh(gi_n + r * gh_n),  h = (1 - z) * n + z * h
//
// gi (input projection + b_ih) is computed outside, by one matmul, as the
// JAX package also does (models/layers.py:759).  expf and tanhf are the
// accurate ones: the library is built without --use_fast_math.
//
// Replaces, bf16: wavthruvec_pytorch_tpu/ops/gru_pallas.py, gru_fwd_pallas
// (Pallas kernel _gru_fwd_kernel), which the CBHG BiGRU runs under
// gru_impl="pallas" where JAX's gate gru_pallas_supported holds: the same
// bf16 rounding of h and w_hh and the same f32 carry.  The TPU kernel keeps
// w_hh resident in VMEM for the whole sequence.
// Replaces, f32: the lax.scan of wavthruvec_pytorch_tpu/models/layers.py:776
// (_gru_fwd_core), JAX's default gru_impl="scan", and "pallas" wherever the
// gate refuses a shape.  Not a Pallas kernel; on the card it is one.
//
// What bounds it on an H100: in bf16 the serial chain of T steps, not bytes or
// operations.  Read once, w_hh (D*H*3H bf16 = 12.6 MB at D = 2, H = 1024) and
// the 2*D*B*H*3H operations of a step take microseconds for the whole
// sequence; but step t needs all of h_{t-1}.  So a step costs at least one
// grid-wide exchange of h: its write, a barrier, and its read back from L2.
// In f32 the products run on the CUDA cores (FFMA, 67 TFLOP/s; 3xTF32
// mma.sync on the tensor cores measured no faster here, and slower at B = 1):
// at B = 16 a step's 2*D*B*H*3H = 201 MFLOP take ~3 us, more than the
// exchange, so the f32 kernel is operation-bound at training batches and
// serial-bound at serving ones.
//
// Two routes for each numerics, chosen by shape in ops/gru.py (gru_fwd_plan):
//
//   * persistent (the CBHG's shapes): ONE cooperative launch runs all T
//     steps.  Each block owns U hidden units of one direction and keeps
//     their 3U rows of w_hh^T [D, 3H, H] in shared memory for the whole
//     launch, so w_hh is read from device memory once per call, not once
//     per step.  bf16: 98,304 bytes at U = 16, H = 1024 (64 blocks a
//     direction, 128 for the card's 132 SMs).  A step in one block:
//       1. cp.async (L2 only) bf16(h_{t-1}) of its direction, 16 batch rows
//          at a time, from the exchange buffer hx [2, D, B, H] (double
//          buffered by the parity of t);
//       2. the [16, 3U] gate products on the tensor cores: mma.sync
//          m16n8k16 bf16 with f32 accumulation, the batch as M, the 8 warps
//          splitting K = H and summing their partials through shared memory.
//          B = 1 takes the same path (15 zero rows): a step's products are a
//          few hundred cycles either way, and one code path keeps the
//          arithmetic (exact bf16 products, f32 sums) the same at every B;
//       3. gi (prefetched by cp.async during the previous barrier) and b_hh
//          added, the gates of its U units applied, h carried in f32 in
//          shared memory;
//       4. bf16 h written to hx, then the block's arrival at a
//          per-direction barrier: an arrival counter in global memory
//          (red.release.gpu / ld.acquire.gpu), so the two directions, which
//          share nothing, never wait for each other;
//       5. while the others arrive, the f32 y[d, b, t, units] written and
//          the next step's gi prefetched; then the wait.
//     f32: the same grid, barrier and gi prefetch, with 197,376 bytes of f32
//     w_hh at U = 16, H = 1024, which leaves no room for a whole h tile.  So
//     h_{t-1} streams from L2 (from y itself: h_{t-1} is y[:, :, t-1], no
//     exchange buffer) through two 8 KB stages (cp.async: one lands while the
//     other is multiplied) that lie in the partial sums' buffer, BT <= 16
//     batch rows a pass (one pass up to B = 16).  Lane (rq, kq) of warp w
//     takes 4 of the 128 k of each column slab (the 32 (warp, kq) slots tile
//     it) and the block's rows rq, rq + 8, ... (6 at U = 16), FFMA on the
//     CUDA cores: 6 x BT sums from 6 + BT 16-byte loads of shared memory a
//     slab.  The 4 kq lanes' sums are reduce-scattered by shuffles and the
//     8 warps' added through shared memory, as in bf16.  The f32 h is
//     written to y before the arrival.
//     cudaLaunchCooperativeKernel guarantees that every block is resident
//     (or refuses the launch, which the caller raises on: nothing falls back).
//   * steps (shapes whose w_hh slices do not fit in shared memory on the
//     card's SMs, e.g. H = 2048 at D = 2, or f32 at B > 40 for H = 1024): one
//     launch a time step, the host loop in C; one warp owns hidden unit j of
//     one direction and computes its three gate dot products from w_hh read
//     through L2 (bf16 or f32), reduces them with shuffles and writes
//     h_new[j] itself; h_{t-1} is read from the output's row t-1 (rounded to
//     bf16 for the bf16 numerics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gru_common.cuh"
#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;
using gru::barrier_arrive;
using gru::barrier_wait;
using gru::halve;
using gru::sigmoidf;

// ===========================================================================
// persistent route
// ===========================================================================

constexpr int P_THREADS = 256;
constexpr int P_WARPS = P_THREADS / 32;
constexpr int BM = 16;  // batch rows a tile: the M of m16n8k16

// Shared memory of the persistent kernel, in bytes (ops/gru.py
// persistent_smem computes the same): w slice [3U][H + 8] bf16, h tile
// [BM][H + 8] bf16 (8 columns of zeros pad K to a multiple of 16 and move
// consecutive rows 4 banks apart), the warps' partial sums [WARPS][BM][3U]
// f32, gi of the step [B][3U] f32, the f32 carry [B][U] and b_hh [3U] f32.
__host__ __device__ inline size_t persistent_smem(int U, int B, int H) {
  const size_t hp = static_cast<size_t>(H) + 8, r = 3 * static_cast<size_t>(U);
  return 2 * r * hp + 2 * BM * hp + 4 * P_WARPS * BM * r + 4 * static_cast<size_t>(B) * r +
         4 * static_cast<size_t>(B) * U + 4 * r;
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b, m16n8k16, bf16 in, f32 accumulate.  With g = lane / 4 and
// t = lane % 4: a[0] (row g, k 2t..2t+1), a[1] (g + 8, 2t), a[2] (g, 2t + 8),
// a[3] (g + 8, 2t + 8); b0 (k 2t..2t+1, n = g), b1 (k 2t + 8.., n = g);
// c[0], c[1] (row g, n 2t, 2t + 1), c[2], c[3] (row g + 8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block per (direction, U consecutive hidden units); grid D * nbd.
// gi [D, B, T, 3H] f32; w [D, 3H, H] bf16; bh [D, 3H] f32; y [D, B, T, H]
// f32; hx [2, D, B, H] bf16 scratch; counter [D] zeroed.
template <int U>
__global__ void __launch_bounds__(P_THREADS, 1)
gru_persistent_kernel(const float* __restrict__ gi, const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bh, float* __restrict__ y,
                      __nv_bfloat16* __restrict__ hx, unsigned* __restrict__ counter, int D,
                      int B, int T, int H, int nbd) {
  constexpr int R = 3 * U;   // gate rows of the block
  constexpr int NT = R / 8;  // n-tiles of m16n8k16
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = H + 8;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hs = ws + R * hp;
  float* red = reinterpret_cast<float*>(hs + BM * hp);
  float* gis = red + P_WARPS * BM * R;
  float* h32 = gis + B * R;
  float* bhs = h32 + B * U;

  const int d = blockIdx.x / nbd;
  const int j0 = (blockIdx.x % nbd) * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int cpr = H / 8;  // 16-byte chunks of a bf16 row
  const int ksteps = (H + 15) / 16;
  unsigned* ctr = counter + d;

  // the block's rows of w^T, local row gate * U + u <- row gate * H + j0 + u
  for (int i = tid; i < R * cpr; i += P_THREADS) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    const int gate = r / U, u = r - gate * U;
    const bool in = j0 + u < H;
    const __nv_bfloat16* src =
        w + (static_cast<size_t>(d) * 3 * H + gate * H + (in ? j0 + u : 0)) * H + c;
    cp_async16(smem_u32(ws + r * hp + c), src, in ? 16u : 0u);
  }
  for (int r = tid; r < R; r += P_THREADS)  // the 8 pad columns
    *reinterpret_cast<uint4*>(ws + r * hp + H) = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < BM * hp / 8; i += P_THREADS)  // the h tile, pad columns included
    reinterpret_cast<uint4*>(hs)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < R; i += P_THREADS) {
    const int gate = i / U, u = i - gate * U;
    bhs[i] = j0 + u < H ? bh[static_cast<size_t>(d) * 3 * H + gate * H + j0 + u] : 0.f;
  }

  // gi of step t for every batch row: [B][3U], runs of U floats
  const int cpg = U / 4;
  auto load_gi = [&](int t) {
    for (int i = tid; i < B * 3 * cpg; i += P_THREADS) {
      const int b = i / (3 * cpg), rem = i - b * 3 * cpg;
      const int gate = rem / cpg, c = (rem - gate * cpg) * 4;
      const bool in = j0 + c < H;
      const float* src =
          gi + ((static_cast<size_t>(d) * B + b) * T + t) * 3 * H + gate * H + (in ? j0 + c : 0);
      cp_async16(smem_u32(gis + b * R + gate * U + c), src, in ? 16u : 0u);
    }
  };
  load_gi(0);
  cp_async_commit();

  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* h_in = hx + (static_cast<size_t>((t + 1) & 1) * D + d) * B * H;
    __nv_bfloat16* h_out = hx + (static_cast<size_t>(t & 1) * D + d) * B * H;
    for (int b0 = 0; b0 < B; b0 += BM) {
      if (t > 0) {
        // the tile's real rows; past B, rows another tile of this step
        // wrote are zero-filled (with one tile they stay zero from the start)
        const int rows = B > BM ? BM : B;
        for (int i = tid; i < rows * cpr; i += P_THREADS) {
          const int r = i / cpr, c = (i - r * cpr) * 8;
          const bool in = b0 + r < B;
          cp_async16(smem_u32(hs + r * hp + c), h_in + static_cast<size_t>(in ? b0 + r : 0) * H + c,
                     in ? 16u : 0u);
        }
        cp_async_commit();
      }
      cp_async_wait<0>();  // h tile, and this step's gi (and w at t = 0)
      __syncthreads();

      if (t > 0) {
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        for (int ks = warp; ks < ksteps; ks += P_WARPS) {
          const int k0 = ks * 16 + 2 * tq;
          const uint32_t a[4] = {lds32(hs + g * hp + k0), lds32(hs + (g + 8) * hp + k0),
                                 lds32(hs + g * hp + k0 + 8), lds32(hs + (g + 8) * hp + k0 + 8)};
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const __nv_bfloat16* wr = ws + (n * 8 + g) * hp + k0;
            mma_bf16(acc[n], a, lds32(wr), lds32(wr + 8));
          }
        }
        float* rw = red + warp * BM * R;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n * 8 + 2 * tq;
          *reinterpret_cast<float2*>(rw + g * R + col) = make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(rw + (g + 8) * R + col) = make_float2(acc[n][2], acc[n][3]);
        }
        __syncthreads();
      }

      for (int p = tid; p < BM * U; p += P_THREADS) {
        const int r = p / U, u = p - r * U;
        const int b = b0 + r, j = j0 + u;
        if (b >= B || j >= H) continue;
        float s_r = 0.f, s_z = 0.f, s_n = 0.f;
        if (t > 0) {
#pragma unroll
          for (int v = 0; v < P_WARPS; ++v) {
            const float* rv = red + (v * BM + r) * R;
            s_r += rv[u];
            s_z += rv[U + u];
            s_n += rv[2 * U + u];
          }
        }
        const float* gg = gis + b * R;
        const float rg = sigmoidf(gg[u] + (s_r + bhs[u]));
        const float zg = sigmoidf(gg[U + u] + (s_z + bhs[U + u]));
        const float ng = tanhf(gg[2 * U + u] + rg * (s_n + bhs[2 * U + u]));
        const float h_prev = t > 0 ? h32[b * U + u] : 0.f;
        const float h = (1.f - zg) * ng + zg * h_prev;
        h32[b * U + u] = h;
        h_out[static_cast<size_t>(b) * H + j] = __float2bfloat16(h);
      }
      __syncthreads();  // the tile's h is written; hs and red are free again
    }
    if (t + 1 < T) barrier_arrive(ctr);
    // while the other blocks arrive: the f32 output (no other block reads
    // it) and the next step's gi
    for (int p = tid; p < B * U; p += P_THREADS) {
      const int b = p / U, u = p - b * U;
      if (j0 + u < H) y[((static_cast<size_t>(d) * B + b) * T + t) * H + j0 + u] = h32[p];
    }
    if (t + 1 < T) {
      load_gi(t + 1);
      cp_async_commit();
      barrier_wait(ctr, static_cast<unsigned>(t + 1) * nbd);
    }
  }
}

// The serial floor: the persistent grid with the same shared memory (so one
// block an SM), running T - 1 barriers and nothing else.
__global__ void __launch_bounds__(P_THREADS, 1)
gru_barrier_loop_kernel(unsigned* __restrict__ counter, int T, int nbd) {
  unsigned* ctr = counter + blockIdx.x / nbd;
  for (int t = 0; t + 1 < T; ++t) {
    __syncthreads();
    barrier_arrive(ctr);
    barrier_wait(ctr, static_cast<unsigned>(t + 1) * nbd);
  }
}

template <int U>
cudaError_t launch_persistent(const float* gi, const __nv_bfloat16* w, const float* bh, float* y,
                              __nv_bfloat16* hx, unsigned* counter, int D, int B, int T, int H,
                              size_t smem, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(gru_persistent_kernel<U>);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int nbd = (H + U - 1) / U;
  void* args[] = {&gi, &w, &bh, &y, &hx, &counter, &D, &B, &T, &H, &nbd};
  return cudaLaunchCooperativeKernel(fn, dim3(D * nbd), dim3(P_THREADS), args, smem, stream);
}

// ===========================================================================
// f32 persistent route
// ===========================================================================

constexpr int F_ROWS = 16;     // batch rows of a pass, at most (the partial sums' rows)
constexpr int F_STAGE = 2048;  // floats an h stage: 8 KB; two of them, in the partial sums
constexpr int F_SLAB = 128;    // columns of a slab: 8 warps x 4 k lanes x 4

// Floats of the warps' partial sums [WARPS][16][3U], at least two h
// stages: the stages lie there (the sums are written after a pass's last
// stage is multiplied)
__host__ __device__ inline size_t f32_red_floats(int U) {
  const size_t red = P_WARPS * F_ROWS * 3 * static_cast<size_t>(U);
  return red > 2 * F_STAGE ? red : 2 * F_STAGE;
}

// Shared memory of the f32 persistent kernel, in bytes (ops/gru.py
// persistent_f32_smem computes the same): w slice [3U][H + 4] f32 (4 columns
// of padding put the 8 rows a quarter warp reads in distinct banks), the
// partial sums (and the two h stages), gi of the step [B][3U] f32, the f32
// carry [B][U] and b_hh [3U] f32.
__host__ __device__ inline size_t persistent_f32_smem(int U, int B, int H) {
  const size_t hp = static_cast<size_t>(H) + 4, r = 3 * static_cast<size_t>(U);
  return 4 * (r * hp + f32_red_floats(U) + static_cast<size_t>(B) * r +
              static_cast<size_t>(B) * U + r);
}

// One block per (direction, U consecutive hidden units); grid D * nbd.  BT is
// the batch rows of a pass (1, 2, 4, 8 or 16; a lane's 3U/8 x BT sums stay
// in registers).  gi [D, B, T, 3H] f32; w [D, 3H, H] f32; bh [D, 3H] f32; y
// [D, B, T, H] f32, also the exchange: h_{t-1} is y[:, :, t-1]; counter [D]
// zeroed.
template <int U, int BT>
__global__ void __launch_bounds__(P_THREADS, 1)
gru_persistent_f32_kernel(const float* __restrict__ gi, const float* __restrict__ w,
                          const float* __restrict__ bh, float* __restrict__ y,
                          unsigned* __restrict__ counter, int D, int B, int T, int H, int nbd) {
  constexpr int R = 3 * U;                    // gate rows of the block
  constexpr int RL = R / 8;                   // rows of a lane: rq, rq + 8, ...
  constexpr int N = RL * BT;                  // a lane's partial sums
  constexpr int G = F_STAGE / (BT * F_SLAB);  // slabs a stage holds: [G][BT][128]
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = H + 4;
  float* ws = reinterpret_cast<float*>(smem);
  float* red = ws + R * hp;
  float* gis = red + f32_red_floats(U);
  float* h32 = gis + B * R;
  float* bhs = h32 + B * U;

  const int d = blockIdx.x / nbd;
  const int j0 = (blockIdx.x % nbd) * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a quarter warp (8 lanes, one kq) reads one 16-byte chunk of 8 w rows,
  // one bank group apart, and one chunk of an h row, which it shares
  const int rq = lane & 7, kq = lane >> 3;
  const int cpr = H / 4;                                       // 16-byte chunks of an f32 row
  const int nstage = ((H + F_SLAB - 1) / F_SLAB + G - 1) / G;  // stages of a pass
  const int kl = 16 * warp + 4 * kq;                           // the lane's 4 k of each slab
  const size_t bstride = static_cast<size_t>(T) * H;  // between batch rows of y
  unsigned* ctr = counter + d;
  gru::Stamps prof;

  // the block's rows of w^T, local row gate * U + u <- row gate * H + j0 + u
  for (int i = tid; i < R * cpr; i += P_THREADS) {
    const int r = i / cpr, c = (i - r * cpr) * 4;
    const int gate = r / U, u = r - gate * U;
    const bool in = j0 + u < H;
    const float* src = w + (static_cast<size_t>(d) * 3 * H + gate * H + (in ? j0 + u : 0)) * H + c;
    cp_async16(smem_u32(ws + r * hp + c), src, in ? 16u : 0u);
  }
  for (int i = tid; i < R; i += P_THREADS) {
    const int gate = i / U, u = i - gate * U;
    bhs[i] = j0 + u < H ? bh[static_cast<size_t>(d) * 3 * H + gate * H + j0 + u] : 0.f;
  }

  // gi of step t for every batch row: [B][3U], runs of U floats
  const int cpg = U / 4;
  auto load_gi = [&](int t) {
    for (int i = tid; i < B * 3 * cpg; i += P_THREADS) {
      const int b = i / (3 * cpg), rem = i - b * 3 * cpg;
      const int gate = rem / cpg, c = (rem - gate * cpg) * 4;
      const bool in = j0 + c < H;
      const float* src =
          gi + ((static_cast<size_t>(d) * B + b) * T + t) * 3 * H + gate * H + (in ? j0 + c : 0);
      cp_async16(smem_u32(gis + b * R + gate * U + c), src, in ? 16u : 0u);
    }
  };
  load_gi(0);
  cp_async_commit();

  for (int t = 0; t < T; ++t) {
    cp_async_wait<0>();  // this step's gi (and w at t = 0)
    __syncthreads();
    prof.mark(gru::PROF_BARRIER);
    for (int bb0 = 0; bb0 < B; bb0 += BT) {
      if (t > 0) {
        // stage q of the pass: h_{t-1} of rows bb0 .. bb0 + BT - 1 at slabs
        // q * G ... q * G + G - 1, two 16-byte cp.async a thread (L2 only:
        // other blocks wrote these rows in this launch); zeros past B and H
        const float* h_in = y + (static_cast<size_t>(d) * B * T + (t - 1)) * H;
        auto issue = [&](int q) {
          if (q < nstage) {
#pragma unroll
            for (int i = 0; i < F_STAGE / 4 / P_THREADS; ++i) {
              const int idx = tid + i * P_THREADS;
              const int c = 4 * (idx % (F_SLAB / 4)), rem = idx / (F_SLAB / 4);
              const int k = (q * G + rem / BT) * F_SLAB + c, b = bb0 + rem % BT;
              const bool in = k < H && b < B;
              cp_async16(smem_u32(red + (q & 1) * F_STAGE + 4 * idx),
                         h_in + (in ? b * bstride + k : 0), in ? 16u : 0u);
            }
          }
          cp_async_commit();  // an empty group past the last stage keeps the count
        };
        float acc[N];  // acc[j * BT + bb]: row rq + 8 j, batch row bb0 + bb
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = 0.f;
        issue(0);
        for (int q = 0; q < nstage; ++q) {
          const unsigned long long w0 = prof.start();
          cp_async_wait<0>();  // stage q has landed ...
          __syncthreads();     // ... for every thread, and q - 1's buffer is free
          prof.nested(gru::PROF_WAITS, w0);
          issue(q + 1);
          const float* st = red + (q & 1) * F_STAGE;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int k = (q * G + g) * F_SLAB + kl;
            if (k < H) {
              float4 wv[RL];
#pragma unroll
              for (int j = 0; j < RL; ++j)
                wv[j] = *reinterpret_cast<const float4*>(ws + (rq + 8 * j) * hp + k);
#pragma unroll
              for (int bb = 0; bb < BT; ++bb) {
                const float4 h = *reinterpret_cast<const float4*>(st + (g * BT + bb) * F_SLAB + kl);
#pragma unroll
                for (int j = 0; j < RL; ++j) {
                  float a = acc[j * BT + bb];
                  a = fmaf(h.x, wv[j].x, a);
                  a = fmaf(h.y, wv[j].y, a);
                  a = fmaf(h.z, wv[j].z, a);
                  acc[j * BT + bb] = fmaf(h.w, wv[j].w, a);
                }
              }
            }
          }
        }
        prof.mark(gru::PROF_STAGES);
        __syncthreads();  // every warp is past the stages, which lie in red
        // the 4 kq lanes of a row (lane bits 3 and 4) hold the sums of other
        // k: reduce-scatter them where N divides (each lane ends with N / 4
        // whole sums), else add them all everywhere
        if constexpr (N % 4 == 0) {
          halve<N, 8>(acc, lane);
          halve<N / 2, 16>(acc, lane);
          const int base = (kq & 1) * (N / 2) + (kq >> 1) * (N / 4);
#pragma unroll
          for (int i = 0; i < N / 4; ++i) {
            const int o = base + i;
            red[(warp * F_ROWS + o % BT) * R + rq + 8 * (o / BT)] = acc[i];
          }
        } else {
#pragma unroll
          for (int o = 0; o < N; ++o) {
            float v = acc[o];
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (o % 4 == kq) red[(warp * F_ROWS + o % BT) * R + rq + 8 * (o / BT)] = v;
          }
        }
        __syncthreads();
        prof.mark(gru::PROF_REDUCE);
      }

      for (int p = tid; p < BT * U; p += P_THREADS) {
        const int r = p / U, u = p - r * U;
        const int b = bb0 + r, j = j0 + u;
        if (b >= B || j >= H) continue;
        float s_r = 0.f, s_z = 0.f, s_n = 0.f;
        if (t > 0) {
#pragma unroll
          for (int v = 0; v < P_WARPS; ++v) {
            const float* rv = red + (v * F_ROWS + r) * R;
            s_r += rv[u];
            s_z += rv[U + u];
            s_n += rv[2 * U + u];
          }
        }
        const float* gg = gis + b * R;
        const float rg = sigmoidf(gg[u] + (s_r + bhs[u]));
        const float zg = sigmoidf(gg[U + u] + (s_z + bhs[U + u]));
        const float ng = tanhf(gg[2 * U + u] + rg * (s_n + bhs[2 * U + u]));
        const float h_prev = t > 0 ? h32[b * U + u] : 0.f;
        const float h = (1.f - zg) * ng + zg * h_prev;
        h32[b * U + u] = h;
        y[((static_cast<size_t>(d) * B + b) * T + t) * H + j] = h;
      }
      __syncthreads();  // the pass's h is written; red is free again
      prof.mark(gru::PROF_UNIT);
    }
    if (t + 1 < T) {
      barrier_arrive(ctr);
      load_gi(t + 1);  // while the other blocks arrive
      cp_async_commit();
      prof.mark(gru::PROF_ARRIVAL);
      barrier_wait(ctr, static_cast<unsigned>(t + 1) * nbd);
    }
  }
  prof.store();
}

template <int U, int BT>
cudaError_t launch_persistent_f32(const float* gi, const float* w, const float* bh, float* y,
                                  unsigned* counter, int D, int B, int T, int H, size_t smem,
                                  cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(gru_persistent_f32_kernel<U, BT>);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int nbd = (H + U - 1) / U;
  void* args[] = {&gi, &w, &bh, &y, &counter, &D, &B, &T, &H, &nbd};
  return cudaLaunchCooperativeKernel(fn, dim3(D * nbd), dim3(P_THREADS), args, smem, stream);
}

// BT: the smallest power of two that covers min(B, 16), at most 8 above
// U = 16, where a lane's 3U/8 x BT sums would pass 96 registers
template <int U>
cudaError_t launch_persistent_f32_bt(const float* gi, const float* w, const float* bh, float* y,
                                     unsigned* counter, int D, int B, int T, int H, size_t smem,
                                     cudaStream_t stream) {
  constexpr int cap = U <= 16 ? F_ROWS : 8;
  int bt = 1;
  while (bt < cap && bt < B) bt *= 2;
  switch (bt) {
    case 1: return launch_persistent_f32<U, 1>(gi, w, bh, y, counter, D, B, T, H, smem, stream);
    case 2: return launch_persistent_f32<U, 2>(gi, w, bh, y, counter, D, B, T, H, smem, stream);
    case 4: return launch_persistent_f32<U, 4>(gi, w, bh, y, counter, D, B, T, H, smem, stream);
    case 8: return launch_persistent_f32<U, 8>(gi, w, bh, y, counter, D, B, T, H, smem, stream);
    default:
      if constexpr (cap == 16)
        return launch_persistent_f32<U, 16>(gi, w, bh, y, counter, D, B, T, H, smem, stream);
      return cudaErrorInvalidValue;
  }
}

// ===========================================================================
// steps route: one launch a time step
// ===========================================================================

constexpr int S_WARPS = 8;  // hidden units per block, one warp each
constexpr int S_ROWS = 4;   // batch rows accumulated per pass over w_hh

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(const uint4 u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// the hidden operand of the products: rounded to bf16 with bf16 weights
template <typename W>
__device__ __forceinline__ float h_operand(float v) {
  if constexpr (std::is_same<W, float>::value) return v;
  else return bf16_round(v);
}

// W: __nv_bfloat16 (bf16 numerics) or float (f32).  y: [D, B, T, H] f32,
// rows 0..t-1 already written.  Writes row t.
template <typename W>
__global__ void __launch_bounds__(S_WARPS * 32)
gru_step_kernel(const float* __restrict__ gi, const W* __restrict__ w,
                const float* __restrict__ bh, float* __restrict__ y,
                int B, int T, int H, int t) {
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * S_WARPS + threadIdx.x / 32;
  const int d = blockIdx.y;
  if (j >= H) return;
  const size_t HH = static_cast<size_t>(H) * H;
  const W* w_r = w + (static_cast<size_t>(d) * 3 * H + j) * H;
  const W* w_z = w_r + HH;
  const W* w_n = w_z + HH;
  const float* bhd = bh + static_cast<size_t>(d) * 3 * H;

  for (int b0 = 0; b0 < B; b0 += S_ROWS) {
    float acc[S_ROWS][3];
#pragma unroll
    for (int bb = 0; bb < S_ROWS; ++bb) acc[bb][0] = acc[bb][1] = acc[bb][2] = 0.f;

    if (t > 0) {
      for (int c = lane * 8; c < H; c += 32 * 8) {
        float wr[8], wz[8], wn[8];
        load8(w_r + c, wr);
        load8(w_z + c, wz);
        load8(w_n + c, wn);
#pragma unroll
        for (int bb = 0; bb < S_ROWS; ++bb) {
          const int b = b0 + bb;
          if (b >= B) break;
          const float* hp = y + ((static_cast<size_t>(d) * B + b) * T + (t - 1)) * H + c;
          const float4 h0 = *reinterpret_cast<const float4*>(hp);
          const float4 h1 = *reinterpret_cast<const float4*>(hp + 4);
          const float h[8] = {h_operand<W>(h0.x), h_operand<W>(h0.y), h_operand<W>(h0.z),
                              h_operand<W>(h0.w), h_operand<W>(h1.x), h_operand<W>(h1.y),
                              h_operand<W>(h1.z), h_operand<W>(h1.w)};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[bb][0] = fmaf(h[i], wr[i], acc[bb][0]);
            acc[bb][1] = fmaf(h[i], wz[i], acc[bb][1]);
            acc[bb][2] = fmaf(h[i], wn[i], acc[bb][2]);
          }
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < S_ROWS; ++bb)
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[bb][g] += __shfl_xor_sync(0xffffffffu, acc[bb][g], off);

    // lane bb finishes batch row b0 + bb (every lane holds every sum)
    float s_r = 0.f, s_z = 0.f, s_n = 0.f;
#pragma unroll
    for (int bb = 0; bb < S_ROWS; ++bb)
      if (bb == lane) { s_r = acc[bb][0]; s_z = acc[bb][1]; s_n = acc[bb][2]; }
    const int b = b0 + lane;
    if (lane < S_ROWS && b < B) {
      const size_t row = (static_cast<size_t>(d) * B + b) * T + t;
      const float* g = gi + row * 3 * H;
      const float gh_r = s_r + bhd[j];
      const float gh_z = s_z + bhd[H + j];
      const float gh_n = s_n + bhd[2 * H + j];
      const float r = sigmoidf(g[j] + gh_r);
      const float z = sigmoidf(g[H + j] + gh_z);
      const float n = tanhf(g[2 * H + j] + r * gh_n);
      const float h_prev = t > 0 ? y[(row - 1) * H + j] : 0.f;
      y[row * H + j] = (1.f - z) * n + z * h_prev;
    }
  }
}

template <typename W>
int launch_steps(const void* gi, const void* w, const void* bh, void* y, int D, int B, int T,
                 int H, void* stream) {
  const dim3 grid((H + S_WARPS - 1) / S_WARPS, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    gru_step_kernel<W><<<grid, S_WARPS * 32, 0, s>>>(
        static_cast<const float*>(gi), static_cast<const W*>(w), static_cast<const float*>(bh),
        static_cast<float*>(y), B, T, H, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" {

// The current device's SM count and the shared memory a block may opt into,
// for the route planner.  Returns a cudaError_t (0 on success).
int gru_fwd_device_limits(int* n_sm, int* smem_optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

// Persistent route.  gi: [D, B, T, 3H] f32 contiguous; w: [D, 3H, H] bf16
// contiguous (w_hh transposed); bh: [D, 3H] f32; y: [D, B, T, H] f32,
// written; hx: [2, D, B, H] bf16 scratch; counter: [D] u32, zeroed.
// H % 8 == 0; U (units a block) one of 8, 16, 24, 32; smem must equal
// persistent_smem(U, B, H) (the planner's figure).  One cooperative launch
// on `stream`; returns its cudaError_t (0 on success).
int gru_fwd_persistent(const void* gi, const void* w, const void* bh, void* y, void* hx,
                       void* counter, int D, int B, int T, int H, int U, long long smem,
                       void* stream) {
  if (static_cast<size_t>(smem) != persistent_smem(U, B, H) || H % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gi);
  const __nv_bfloat16* wt = static_cast<const __nv_bfloat16*>(w);
  const float* b = static_cast<const float*>(bh);
  float* out = static_cast<float*>(y);
  __nv_bfloat16* h = static_cast<__nv_bfloat16*>(hx);
  unsigned* c = static_cast<unsigned*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  switch (U) {
    case 8: return static_cast<int>(launch_persistent<8>(g, wt, b, out, h, c, D, B, T, H, sm, s));
    case 16: return static_cast<int>(launch_persistent<16>(g, wt, b, out, h, c, D, B, T, H, sm, s));
    case 24: return static_cast<int>(launch_persistent<24>(g, wt, b, out, h, c, D, B, T, H, sm, s));
    case 32: return static_cast<int>(launch_persistent<32>(g, wt, b, out, h, c, D, B, T, H, sm, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The persistent route's serial floor: the same grid (D * nbd blocks of 256
// threads, `smem` bytes each) running T - 1 per-direction barriers.
// counter: [D] u32, zeroed.
int gru_fwd_barrier_loop(void* counter, int D, int nbd, int T, long long smem, void* stream) {
  const void* fn = reinterpret_cast<const void*>(gru_barrier_loop_kernel);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned* c = static_cast<unsigned*>(counter);
  void* args[] = {&c, &T, &nbd};
  return static_cast<int>(cudaLaunchCooperativeKernel(fn, dim3(D * nbd), dim3(P_THREADS), args,
                                                      static_cast<size_t>(smem),
                                                      static_cast<cudaStream_t>(stream)));
}

// Steps route: the same arguments as gru_fwd_persistent without the scratch.
// Issues T launches on `stream`; returns the first cudaError_t (0 on success).
int gru_fwd_steps(const void* gi, const void* w, const void* bh, void* y,
                  int D, int B, int T, int H, void* stream) {
  return launch_steps<__nv_bfloat16>(gi, w, bh, y, D, B, T, H, stream);
}

// f32 persistent route.  gi: [D, B, T, 3H] f32 contiguous; w: [D, 3H, H] f32
// contiguous (w_hh transposed); bh: [D, 3H] f32; y: [D, B, T, H] f32, written
// (and read back as h_{t-1}); counter: [D] u32, zeroed.  H % 8 == 0; U one of
// 8, 16, 24, 32; smem must equal persistent_f32_smem(U, B, H).  One
// cooperative launch on `stream`; returns its cudaError_t (0 on success).
int gru_fwd_persistent_f32(const void* gi, const void* w, const void* bh, void* y, void* counter,
                           int D, int B, int T, int H, int U, long long smem, void* stream) {
  if (static_cast<size_t>(smem) != persistent_f32_smem(U, B, H) || H % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gi);
  const float* wt = static_cast<const float*>(w);
  const float* b = static_cast<const float*>(bh);
  float* out = static_cast<float*>(y);
  unsigned* c = static_cast<unsigned*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  auto launch = [&](auto fn) { return static_cast<int>(fn(g, wt, b, out, c, D, B, T, H, sm, s)); };
  switch (U) {
    case 8: return launch(launch_persistent_f32_bt<8>);
    case 16: return launch(launch_persistent_f32_bt<16>);
    case 24: return launch(launch_persistent_f32_bt<24>);
    case 32: return launch(launch_persistent_f32_bt<32>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f32 steps route: gru_fwd_steps with w [D, 3H, H] f32.
int gru_fwd_steps_f32(const void* gi, const void* w, const void* bh, void* y,
                      int D, int B, int T, int H, void* stream) {
  return launch_steps<float>(gi, w, bh, y, D, B, T, H, stream);
}

const char* wtv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

GRU_PROF_READER
