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
// What bounds it on an H100: the chain of out_len dependent rows, not bytes
// or flops.  The bytes (the [B, T, N] input read once, the map written once)
// take 0.07 ms at the long bucket (16 x 3072 x 768); cell (i, j) needs only
// (i-1, j-1) and (i-1, j), so a row's critical path is a hand-off from the
// left neighbour, a max and an add.  This design:
//
//   * an item is a thread-block cluster of C <= 8 blocks (mas_plan in
//     ops/mas.py picks C and K by N); block `rank` owns the text columns
//     [rank W, rank W + W), W = 32 K: 96 columns a block, 8 blocks an item,
//     at N = 768, so the long bucket's 16 items run on 128 SMs;
//   * the chain warp (warp 0) holds the block's columns in registers, lane l
//     the K adjacent columns base + K l + k, and runs the rows with no block
//     barrier: a lane's own columns need no hand-off, the one from lane l-1
//     comes by one __shfl_sync a row (on the critical path once every K
//     rows), and the left block's last column by distributed shared memory:
//     the left chain stores log_p[i, its last column] into this block's
//     edge[i] (a remote store a row), edge starts as NaN (log_p never is),
//     and the chain polls 8 rows' words at a time.  A block runs behind its
//     left neighbour by the hand-off's latency, paid once, not every row.
//     A group of 32 rows is unrolled with no branch inside a row (rows past
//     out_len-1 run on -1e30 and nothing reads them);
//   * 11 producer warps load the block's slice of each row into registers
//     two 32-row stages ahead, apply log_cell (logf only in a warp with a
//     positive cell: most of a peaked alignment is exact zeros) and store it
//     into a 4-stage ring in shared memory (mbarriers full / empty), so the
//     chain warp does only shared loads, compares, max and add, and the logf
//     of an item is spread over its C SMs;
//   * the take-left bits stay in shared memory at every shape: a word a
//     column and 32-row group, bit r for row 1 + 32 g + r, T K words a block
//     (36 KB at T = 3072, K = 3);
//   * the backtrack runs a group of 32 rows at a time in one warp (rank 0's
//     chain warp).  Entering a group at column c, the path stays in columns
//     [c-31, c]: lane j holds column c-j's word, loaded (from whichever
//     block owns it) while the group before is walked, so the loads cost
//     out_len / 32 round trips, hidden, not out_len.  The walk goes by rows
//     (32 ballots give each row's window, then a shift, an and and an add a
//     row, two rows a step) and leaves each row's column in shared memory;
//   * the map is zeroed while the walk runs, by every block but the
//     walker's (a flat 1/(C-1) of the item each; zeroing while the chain
//     runs slowed the chain more than it saved), then rank 0 writes the
//     ones and opt[0, 0];
//   * cluster barriers: after the edge words are set (before a neighbour
//     writes one), after the chains (before the walk reads the bits), and
//     after the walk and the zeroing (before the ones; no block exits while
//     the walker may read its shared memory).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::mbar_arrive;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 32;        // rows a stage, an edge window and a backtrack window
constexpr int STAGES = 4;       // stages of the log_a ring
constexpr int PRODUCERS = 11;   // producer warps; warp 0 runs the chain
constexpr int THREADS = 32 * (1 + PRODUCERS);
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int BARRIER_BYTES = 128;  // the mbarriers
static_assert(16 * STAGES <= BARRIER_BYTES, "the mbarriers take 16 bytes a stage");

__device__ __forceinline__ float log_cell(float a) {
  return fmaxf(logf(fmaxf(a, 0.f)), NEG);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; release / acquire at cluster
// scope, so shared and global writes before it are seen after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// the address of this shared-memory address in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// a store into another block's shared memory through its generic address;
// no "memory" clobber: nothing of this block's own reads or writes needs
// ordering against it, and the chain's shared loads may move across it
__device__ __forceinline__ void st_cluster(float* p, float v) {
  asm volatile("st.relaxed.cluster.f32 [%0], %1;" ::"l"(p), "f"(v));
}

__device__ __forceinline__ uint32_t ld_cluster(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.relaxed.cluster.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float ld_volatile(const float* p) {
  return *static_cast<const volatile float*>(p);
}

// Shared memory of a block, in this order: the mbarriers, edge[Tp + 32]
// floats, the take-left bits cbits[Tp / 32][W] (word [g][t]: bit r is row
// 1 + 32 g + r at the block's column t) and ring[STAGES][ROWS][W] floats;
// Tp = T rounded up to a multiple of 32.
__host__ __device__ __forceinline__ size_t rows_padded(int T) {
  return static_cast<size_t>((T + 31) / 32 * 32);
}

__host__ __device__ __forceinline__ size_t shared_bytes(int T, int K) {
  return BARRIER_BYTES + 4 * (rows_padded(T) + 32 + rows_padded(T) * K +
                              static_cast<size_t>(STAGES) * ROWS * 32 * K);
}

// Zero [lo, hi) of o: scalar up to 16-byte alignment, then float4s.
__device__ void zero_range(float* o, size_t lo, size_t hi, int t, int nt) {
  while (lo < hi && (reinterpret_cast<uintptr_t>(o + lo) & 15) != 0) {
    if (t == 0) o[lo] = 0.f;
    ++lo;
  }
  const size_t n4 = (hi - lo) / 4;
  float4* o4 = reinterpret_cast<float4*>(o + lo);
  for (size_t k = t; k < n4; k += nt) o4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t k = lo + 4 * n4 + t; k < hi; k += nt) o[k] = 0.f;
}

// attn: [B, T, N] f32; in_lens, out_lens: [B] int32; opt: [B, T, N] f32.
// Grid B * C blocks in clusters of C, THREADS threads, shared_bytes(T, K)
// or more of dynamic shared memory.
template <int K>
__global__ void __launch_bounds__(THREADS, 1)
mas_cluster_kernel(const float* __restrict__ attn, const int* __restrict__ in_lens,
                   const int* __restrict__ out_lens, float* __restrict__ opt, int T, int N, int C) {
  constexpr int W = 32 * K;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  float* edge = reinterpret_cast<float*>(smem + BARRIER_BYTES);
  uint32_t* cbits = reinterpret_cast<uint32_t*>(edge + rows_padded(T) + 32);
  float* ring = reinterpret_cast<float*>(cbits + rows_padded(T) * K);

  const int rank = static_cast<int>(cluster_rank());
  const int b = blockIdx.x / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int base = rank * W;
  const int in_len = min(max(in_lens[b], 0), N);
  const int out_len = min(max(out_lens[b], 0), T);
  const float* a = attn + static_cast<size_t>(b) * T * N;
  float* o = opt + static_cast<size_t>(b) * T * N;

  // a block runs the chain where it owns a column < in_len and there is a
  // row past 0; its left neighbour then runs too, and it feeds its right
  // neighbour where that one runs
  const bool active = base < in_len && out_len > 1;
  const bool has_left = rank > 0;
  const bool feeds_right = rank + 1 < C && base + W < in_len;
  const int groups = active ? (out_len - 1 + ROWS - 1) / ROWS : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), PRODUCERS);
      mbar_init(smem_u32(&empty[s]), 1);
    }
    hopper::mbar_init_fence();
  }
  // rank 0 has no left block: its edge words hold the backtrack's column of
  // each row instead (-1: no text position)
  int* path = reinterpret_cast<int*>(edge);
  for (size_t k = threadIdx.x; k < rows_padded(T) + 32; k += THREADS)
    edge[k] = __int_as_float(rank == 0 ? -1 : 0x7fffffff);
  cluster_sync();  // every block's edge words are NaN before a neighbour writes one

  if (warp == 0) {
    if (active) {
      // ---- the chain: rows 1 .. out_len-1, one warp; lane l holds the K
      // adjacent columns base + K l + k in registers ----
      float lp[K];
#pragma unroll
      for (int k = 0; k < K; ++k) lp[k] = NEG;
      if (rank == 0 && lane == 0) lp[0] = log_cell(a[0]);  // row 0: column 0 alone
      float* right_edge =
          feeds_right ? cooperative_groups::this_cluster().map_shared_rank(edge, rank + 1) : edge;
      if (feeds_right && lane == 31) st_cluster(right_edge, lp[K - 1]);
      float e = NEG;
      uint32_t valid = FULL;
      for (int g = 0; g < groups; ++g) {
        const int s = g % STAGES;
        mbar_wait(smem_u32(&full[s]), (g / STAGES) & 1);
        const float* la = ring + static_cast<size_t>(s) * ROWS * W + K * lane;
        if (has_left) {
          e = ld_volatile(edge + ROWS * g + lane);
          valid = __ballot_sync(FULL, e == e);
        }
        uint32_t taken[K];  // bit r: take_left at row 1 + 32 g + r
#pragma unroll
        for (int k = 0; k < K; ++k) taken[k] = 0;
        float next[K];  // log_a of the row after this one, loaded a row ahead
#pragma unroll
        for (int k = 0; k < K; ++k) next[k] = la[k];
        // All 32 rows of the group, unrolled, with no branch inside a row:
        // rows past out_len - 1 run on log_a = -1e30 and nothing reads them.
        // The left block's edge words are awaited 8 rows at a time.
#pragma unroll
        for (int r8 = 0; r8 < ROWS; r8 += 8) {
          while (((valid >> r8) & 0xffu) != 0xffu) {
            e = ld_volatile(edge + ROWS * g + lane);
            valid = __ballot_sync(FULL, e == e);
          }
#pragma unroll
          for (int r = r8; r < r8 + 8; ++r) {
            float x[K];
#pragma unroll
            for (int k = 0; k < K; ++k) {
              x[k] = next[k];
              if (r + 1 < ROWS) next[k] = la[(r + 1) * W + k];
            }
            // the left neighbour of column K l: lane l-1's last column, or
            // for lane 0 the left block's (-1e30 at rank 0)
            const float e_r = __shfl_sync(FULL, e, r);
            const float up = __shfl_sync(FULL, lp[K - 1], (lane + 31) & 31);
            const float left = lane == 0 ? e_r : up;
#pragma unroll
            for (int k = K - 1; k >= 0; --k) {  // right to left: lp[k-1] is still row i-1's
              const float l = k == 0 ? left : lp[k - 1];
              taken[k] |= l >= lp[k] ? 1u << r : 0u;
              lp[k] = x[k] + fmaxf(l, lp[k]);
            }
            if (feeds_right && lane == 31) st_cluster(right_edge + 1 + ROWS * g + r, lp[K - 1]);
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) cbits[static_cast<size_t>(g) * W + K * lane + k] = taken[k];
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
      }
    }
  } else {
    // ---- producers: log_a into the ring ----
    const int p = warp - 1;
    // this thread's cells of a stage: rows p + PRODUCERS q, columns 32 k + lane
    constexpr int ROWS_PER = (ROWS + PRODUCERS - 1) / PRODUCERS;
    // log_cell is -1e30 at a <= 0: only a warp with a positive cell runs
    // logf (most of a peaked alignment is exact zeros)
    auto log_a = [&](float x, int j) -> float {
      const bool live = j < in_len && x > 0.f;
      return __any_sync(FULL, live) && j < in_len ? log_cell(x) : NEG;
    };
    // stage g's cells in registers two stages ahead of their logs, then one
    // store each into the slot
    float cur[ROWS_PER][K], nxt[ROWS_PER][K], far[ROWS_PER][K];
    auto load = [&](float (&v)[ROWS_PER][K], int g) {
#pragma unroll
      for (int q = 0; q < ROWS_PER; ++q) {
        const int r = p + q * PRODUCERS, i = 1 + ROWS * g + r;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = base + 32 * k + lane;
          v[q][k] = r < ROWS && g < groups && i < out_len && j < in_len
                        ? a[static_cast<size_t>(i) * N + j] : 0.f;
        }
      }
    };
    load(cur, 0);
    load(nxt, 1);
    for (int g = 0; g < groups; ++g) {
      load(far, g + 2);
      const int s = g % STAGES;
      if (g >= STAGES) mbar_wait(smem_u32(&empty[s]), (g / STAGES - 1) & 1);
      float* slot = ring + static_cast<size_t>(s) * ROWS * W;
#pragma unroll
      for (int q = 0; q < ROWS_PER; ++q) {
        const int r = p + q * PRODUCERS;
        if (r >= ROWS) break;
#pragma unroll
        for (int k = 0; k < K; ++k)
          slot[r * W + 32 * k + lane] = log_a(cur[q][k], base + 32 * k + lane);
      }
      __syncwarp();  // the warp's stores before its one arrival (release)
      if (lane == 0) mbar_arrive(smem_u32(&full[s]));
#pragma unroll
      for (int q = 0; q < ROWS_PER; ++q)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          cur[q][k] = nxt[q][k];
          nxt[q][k] = far[q][k];
        }
    }
  }
  cluster_sync();  // the bits complete in every block

  if (rank == 0 && warp == 0 && out_len > 0) {
    // ---- the backtrack, a group of 32 rows at a time.  Entering group g
    // at row `top` in column c, the path stays in columns [c-31, c]: lane j
    // holds column c-j's word.  The next group's words over [c-63, c] are
    // loaded while this one is walked, from whichever block owns them ----
    const uint32_t cbits_addr = smem_u32(cbits);
    auto word = [&](int grp, int col) -> uint32_t {
      return col < 0 ? 0u
                     : ld_cluster(map_rank(cbits_addr + 4u * (grp * W + col % W), col / W));
    };
    int c = in_len - 1;
    if (out_len > 1 && c >= 0) {
      int g = (out_len - 2) / ROWS, top = out_len - 2 - ROWS * g;
      uint32_t w = word(g, c - lane);
      for (;;) {
        const uint32_t na = g > 0 ? word(g - 1, c - lane) : 0u;
        const uint32_t nb = g > 0 ? word(g - 1, c - 32 - lane) : 0u;
        w &= FULL >> (31 - top);  // no steps above row `top`
        uint32_t q = 0;      // the path's distance left of c
        uint32_t moves = 0;  // bit t: the path steps left below row t
        // row by row, two rows a step: hi and lo are rows r and r-1's
        // windows (bit q: take_left at column c-q); from q at row r the
        // path moves b_r(q) + b_{r-1}(q + b_r(q)) columns left by row
        // r-2, which is bit q of (hi | lo) plus bit q of (hi & lo >> 1)
#pragma unroll
        for (int r = ROWS - 1; r >= 1; r -= 2) {
          const uint32_t hi = __ballot_sync(FULL, w & (1u << r));
          const uint32_t lo = __ballot_sync(FULL, w & (1u << (r - 1)));
          const uint32_t one = hi | lo, two = hi & (lo >> 1);
          const uint32_t step = (hi >> q) & 1u, both = ((one >> q) & 1u) + ((two >> q) & 1u);
          moves |= step << r | (both - step) << (r - 1);
          q += both;
        }
        const int mine = __popc(lane == 31 ? 0u : moves >> (lane + 1));
        if (lane <= top) path[1 + ROWS * g + lane] = c - mine;
        c -= static_cast<int>(q);
        if (--g < 0 || c < 0) break;
        top = ROWS - 1;
        const uint32_t src = q + lane;  // the new c - lane is the old c - src
        const uint32_t from_a = __shfl_sync(FULL, na, src & 31);
        const uint32_t from_b = __shfl_sync(FULL, nb, src & 31);
        w = src < 32 ? from_a : from_b;
      }
    }
    if (lane == 0) path[0] = c;
  } else if (warp > 0) {
    // the other warps zero the item's map while the walk runs: with C > 1 a
    // flat 1/(C-1) of it in every block but the walker's (filling there
    // too slows the walk), with C = 1 all of it
    const size_t TN = static_cast<size_t>(T) * N;
    const int share = C == 1 ? 0 : rank - 1, shares = C == 1 ? 1 : C - 1;
    if (share >= 0)
      zero_range(o, TN * share / shares, TN * (share + 1) / shares, threadIdx.x - 32,
                 THREADS - 32);
  }
  cluster_sync();  // the map zeroed; no block's bits are read past here

  if (rank == 0) {  // the ones, and opt[0, 0]
    for (int i = threadIdx.x; i < out_len; i += THREADS)
      if (path[i] >= 0) o[static_cast<size_t>(i) * N + path[i]] = 1.f;
    if (threadIdx.x == 0 && out_len > 0) o[0] = 1.f;
  }
}

// The chain warp's rows alone: no loads, logs or stores but one at the end.
// One warp, `rows` rows of K columns a lane: each row's shuffle, select,
// compares, max, add and take-left bits.  Its time / rows is one row's
// dependent step, the serial floor of the design's path.
template <int K>
__global__ void mas_row_chain_kernel(float* out, int rows, float la) {
  const int lane = threadIdx.x;
  float lp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lp[k] = lane == 0 && k == 0 ? 0.f : NEG;
  uint32_t taken[K] = {};
  for (int i = 1; i < rows; ++i) {
    const float up = __shfl_sync(FULL, lp[K - 1], (lane + 31) & 31);
    const float left = lane == 0 ? NEG : up;
    const uint32_t bit = 1u << (i & 31);
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const float l = k == 0 ? left : lp[k - 1];
      if (l >= lp[k]) taken[k] |= bit;
      lp[k] = la + fmaxf(l, lp[k]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) s += lp[k] + __uint_as_float(taken[k] & 1u);
  out[lane] = s;
}

template <int K>
cudaError_t launch(const float* attn, const int* in_lens, const int* out_lens, float* opt, int B,
                   int T, int N, int C, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(mas_cluster_kernel<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mas_cluster_kernel<K>, attn, in_lens, out_lens, opt, T, N, C);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block needs for T frames, K columns a lane.
size_t mas_shared_bytes(int T, int K) { return shared_bytes(T, K); }

// attn: [B, T, N] f32 contiguous; in_lens, out_lens: [B] int32; opt: [B, T,
// N] f32, written in full.  Clusters of C blocks, K columns a lane:
// 1 <= C <= 8, 1 <= K <= 4, N <= 32 K C; smem >= mas_shared_bytes(T, K).
// Returns the first cudaError_t (0 on success; cudaErrorInvalidValue for
// arguments outside these limits).
int mas_forward(const void* attn, const void* in_lens, const void* out_lens, void* opt, int B,
                int T, int N, int C, int K, size_t smem, void* stream) {
  if (B < 1 || T < 1 || N < 1 || C < 1 || C > MAX_CLUSTER || K < 1 || K > 4 ||
      N > 32 * K * C || smem < shared_bytes(T, K))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(attn);
  const int* il = static_cast<const int*>(in_lens);
  const int* ol = static_cast<const int*>(out_lens);
  float* y = static_cast<float*>(opt);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return static_cast<int>(launch<1>(x, il, ol, y, B, T, N, C, smem, s));
    case 2: return static_cast<int>(launch<2>(x, il, ol, y, B, T, N, C, smem, s));
    case 3: return static_cast<int>(launch<3>(x, il, ol, y, B, T, N, C, smem, s));
    default: return static_cast<int>(launch<4>(x, il, ol, y, B, T, N, C, smem, s));
  }
}

// One warp runs `rows` rows of the chain at K columns a lane, as the serial
// floor's microbenchmark; out: 32 floats on the card.
int mas_row_chain(void* out, int rows, int K, void* stream) {
  float* y = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: mas_row_chain_kernel<1><<<1, 32, 0, s>>>(y, rows, -0.5f); break;
    case 2: mas_row_chain_kernel<2><<<1, 32, 0, s>>>(y, rows, -0.5f); break;
    case 3: mas_row_chain_kernel<3><<<1, 32, 0, s>>>(y, rows, -0.5f); break;
    default: mas_row_chain_kernel<4><<<1, 32, 0, s>>>(y, rows, -0.5f); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The shared memory a block may opt into on the card, in bytes.
int mas_shared_limit(int device, int* smem) {
  return static_cast<int>(
      cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char* wtv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
