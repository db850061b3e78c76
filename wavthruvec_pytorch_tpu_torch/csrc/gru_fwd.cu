// Forward recurrence of D stacked GRU directions for Hopper (sm_90a), with
// torch nn.GRU gates and h0 = 0:
//
//   gh = bf16(h) . w_hh + b_hh          (bf16 products, f32 accumulation)
//   r  = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z)
//   n  = tanh(gi_n + r * gh_n),  h = (1 - z) * n + z * h
//
// gi (input projection + b_ih) is computed outside, by one matmul, as the
// JAX package also does (models/layers.py:759).
//
// Replaces: wavthruvec_pytorch_tpu/ops/gru_pallas.py, gru_fwd_pallas (Pallas
// kernel _gru_fwd_kernel), which the CBHG BiGRU runs under gru_impl="pallas":
// the same bf16 rounding of h and w_hh and the same f32 carry.
//
// What bounds it on an H100: the serial chain of T steps, not bytes or flops.
// The least work a step needs is reading w_hh (D*H*3H bf16 = 12.6 MB at
// D = 2, H = 1024) and doing 2*D*B*H*3H flops; the whole recurrence's bound
// from bytes read once is microseconds, but each step depends on the last.
// This first design is simple and right:
//   * one launch per time step, both directions in one grid; the host loop
//     that issues the T launches runs in C, so Python pays one call per BiGRU;
//   * one warp owns hidden unit j of one direction and computes its three
//     gate dot products (rows j, H+j, 2H+j of w_hh transposed to [D, 3H, H],
//     so every lane reads 16 contiguous bytes), reduces them with shuffles
//     and writes h_new[j] itself, so a step needs no second pass;
//   * h_{t-1} is read from the output's row t-1 (the output doubles as the
//     carried state, no ping-pong buffers), and w_hh is re-read from L2 each
//     step, where 12.6 MB fits in 50 MB.
// A persistent kernel that keeps w_hh resident in shared memory across the
// 132 SMs (about 95 KB each) with a grid barrier per step is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;   // hidden units per block, one warp each
constexpr int BT = 4;      // batch rows accumulated per pass over w_hh

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

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// gi: [D, B, T, 3H] f32; w: [D, 3H, H] bf16; bh: [D, 3H] f32;
// y: [D, B, T, H] f32, rows 0..t-1 already written.  Writes row t.
__global__ void __launch_bounds__(WARPS * 32)
gru_step_kernel(const float* __restrict__ gi, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bh, float* __restrict__ y,
                int B, int T, int H, int t) {
  const int lane = threadIdx.x % 32;
  const int j = blockIdx.x * WARPS + threadIdx.x / 32;
  const int d = blockIdx.y;
  if (j >= H) return;
  const size_t HH = static_cast<size_t>(H) * H;
  const __nv_bfloat16* w_r = w + (static_cast<size_t>(d) * 3 * H + j) * H;
  const __nv_bfloat16* w_z = w_r + HH;
  const __nv_bfloat16* w_n = w_z + HH;
  const float* bhd = bh + static_cast<size_t>(d) * 3 * H;

  for (int b0 = 0; b0 < B; b0 += BT) {
    float acc[BT][3];
#pragma unroll
    for (int bb = 0; bb < BT; ++bb) acc[bb][0] = acc[bb][1] = acc[bb][2] = 0.f;

    if (t > 0) {
      for (int c = lane * 8; c < H; c += 32 * 8) {
        float wr[8], wz[8], wn[8];
        unpack8(*reinterpret_cast<const uint4*>(w_r + c), wr);
        unpack8(*reinterpret_cast<const uint4*>(w_z + c), wz);
        unpack8(*reinterpret_cast<const uint4*>(w_n + c), wn);
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
          const int b = b0 + bb;
          if (b >= B) break;
          const float* hp = y + ((static_cast<size_t>(d) * B + b) * T + (t - 1)) * H + c;
          const float4 h0 = *reinterpret_cast<const float4*>(hp);
          const float4 h1 = *reinterpret_cast<const float4*>(hp + 4);
          const float h[8] = {bf16_round(h0.x), bf16_round(h0.y), bf16_round(h0.z),
                              bf16_round(h0.w), bf16_round(h1.x), bf16_round(h1.y),
                              bf16_round(h1.z), bf16_round(h1.w)};
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
    for (int bb = 0; bb < BT; ++bb)
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[bb][g] += __shfl_xor_sync(0xffffffffu, acc[bb][g], off);

    // lane bb finishes batch row b0 + bb (every lane holds every sum)
    float s_r = 0.f, s_z = 0.f, s_n = 0.f;
#pragma unroll
    for (int bb = 0; bb < BT; ++bb)
      if (bb == lane) { s_r = acc[bb][0]; s_z = acc[bb][1]; s_n = acc[bb][2]; }
    const int b = b0 + lane;
    if (lane < BT && b < B) {
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

}  // namespace

extern "C" {

// gi: [D, B, T, 3H] f32 contiguous; w: [D, 3H, H] bf16 contiguous (w_hh
// transposed); bh: [D, 3H] f32; y: [D, B, T, H] f32, written.  H % 8 == 0.
// Issues T launches on `stream`; returns the first cudaError_t (0 on success).
int gru_fwd_forward(const void* gi, const void* w, const void* bh, void* y,
                    int D, int B, int T, int H, void* stream) {
  const dim3 grid((H + WARPS - 1) / WARPS, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    gru_step_kernel<<<grid, WARPS * 32, 0, s>>>(
        static_cast<const float*>(gi), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bh), static_cast<float*>(y), B, T, H, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

const char* wtv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
