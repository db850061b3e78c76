// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers, TMA
// loads, named barriers, register reallocation, cp.async, 3xTF32 mma.sync and
// wgmma, as inline PTX.
// Included by the kernels under csrc/; the library hash covers this file.
//
// Shared-memory tiles are bf16 [rows, cols] in boxes of 32 columns (64
// bytes a row), each box stored as TMA writes it with CU_TENSOR_MAP_SWIZZLE_64B:
// row r at byte 64 r of its box, the 16-byte chunk c at chunk c ^ ((r / 2) % 4).
// A box starts at a multiple of 512 bytes, so the swizzle's phase is the
// row's.  wgmma reads such a tile through a matrix descriptor with the
// 64-byte swizzle: K-major (k along the row, as for the A and B of S = Q K^T)
// or N-major (k down the rows, as for V in P V).

#pragma once

#include <cuda.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` (0 for the barrier's first
// completion, 1 for its second, ...) has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA -------------------------------------------------------------------

// One box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first,
// into shared memory at dst; completes `bar`'s transaction count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// --- warpgroups --------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barriers (ids 1..15; 0 is __syncthreads): `threads` counts every
// thread that syncs or arrives.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- cp.async ------------------------------------------------------------------

// 16 bytes global -> shared through L2 only (.cg bypasses L1, so data that
// another SM wrote before a gpu-scope release/acquire is seen); src_bytes 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, for rows that are not 16-byte aligned
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- f32 accuracy on the TF32 tensor cores: 3xTF32 with mma.sync -------------
//
// One TF32 product keeps 10 mantissa bits.  Each operand x is split into
// hi = x with its low 13 mantissa bits cleared (a TF32 value) and lo = x - hi
// (exact in f32; the tensor core reads its top 19 bits), and a product is
// summed as lo_a hi_b + hi_a lo_b + hi_a hi_b in f32 (CUTLASS's
// OpMultiplyAddFastF32 scheme): about 2^-20 of each term, f32 accuracy at
// three times TF32's work.

// hi: x with the low 13 mantissa bits cleared (TF32); lo = x - hi, exact
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// c += a b, m16n8k8, TF32 in, f32 accumulate.  With g = lane / 4 and
// t = lane % 4: A (16 x 8): a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4); B (8 x 8): b0 (k = t, n = g), b1 (k = t + 4, n = g);
// C (16 x 8): c[0], c[1] (g, 2 t and 2 t + 1), c[2], c[3] (g + 8, the same).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at f32 accuracy from split operands, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], uint32_t bhi0, uint32_t bhi1,
                                           uint32_t blo0, uint32_t blo1) {
  mma_tf32(c, alo, bhi0, bhi1);
  mma_tf32(c, ahi, blo0, blo1);
  mma_tf32(c, ahi, bhi0, bhi1);
}

// --- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous product (call after wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Matrix descriptor of a 64-byte-swizzled operand at shared address `addr`:
// `lbo` bytes between 32-column boxes (N-major; unused for K-major) and
// `sbo` bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

// K-major operand: rows r0..r0+63 (A) or r0..r0+N-1 (B) of a tile of `rows`
// rows, columns kk..kk+15.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int r0, int kk) {
  return sw64_desc(tile + (kk / 32) * rows * 64 + r0 * 64 + (kk % 32) * 2, 16, 512);
}

// N-major B operand: tile rows k0..k0+15 as k, all columns as n.
__device__ __forceinline__ uint64_t nmajor_desc(uint32_t tile, int rows, int k0) {
  return sw64_desc(tile + k0 * 64, rows * 64, 512);
}

// d (+)= A B, m64n64k16: A [64, 16] and B [16, 64] K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B, m64nNk16: A [64, 16] bf16 in registers (the m64n8 accumulator
// layout of two adjacent 8-column tiles), B [16, N] N-major in shared memory,
// for the head dims the flash kernels are built for (N = 64, 128, 224, 256).
//
// One PTX string per width: the N / 2 accumulators are operands %0.. in
// order, followed by A's four registers, B's descriptor and the scale-d flag.
// The operand lists are generated: WTV_OPS10(t) is the ten placeholders
// "%t0, ..., %t9, " (t empty for 0-9), WTV_F16(i) the constraints of
// accumulators d[i]..d[i + 15].
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b);

#define WTV_OPS10(t)                                                                            \
  "%" #t "0, %" #t "1, %" #t "2, %" #t "3, %" #t "4, %" #t "5, %" #t "6, %" #t "7, %" #t "8, " \
  "%" #t "9, "
#define WTV_F4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define WTV_F16(i) WTV_F4(i), WTV_F4((i) + 4), WTV_F4((i) + 8), WTV_F4((i) + 12)
#define WTV_F32(i) WTV_F16(i), WTV_F16((i) + 16)
#define WTV_F64(i) WTV_F32(i), WTV_F32((i) + 32)

// N: the width; DLIST: the placeholders %0..%(N/2 - 1); A0..SC: the numbers
// N/2..N/2 + 5 of the operands after them; then the accumulators' constraints.
#define WTV_WGMMA_RS(N, DLIST, A0, A1, A2, A3, DESC, SC, ...)                                    \
  template <>                                                                                   \
  __device__ __forceinline__ void wgmma_rs<N>(float (&d)[N / 2], const uint32_t (&a)[4],       \
                                              uint64_t desc_b) {                                \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #SC ", 0;\n"                              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" DLIST "}, "       \
                 "{%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DESC ", p, 1, 1, 1;\n}\n"       \
                 : __VA_ARGS__                                                                  \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));            \
  }

WTV_WGMMA_RS(64, WTV_OPS10() WTV_OPS10(1) WTV_OPS10(2) "%30, %31",
             32, 33, 34, 35, 36, 37, WTV_F32(0))
WTV_WGMMA_RS(128, WTV_OPS10() WTV_OPS10(1) WTV_OPS10(2) WTV_OPS10(3) WTV_OPS10(4) WTV_OPS10(5)
             "%60, %61, %62, %63",
             64, 65, 66, 67, 68, 69, WTV_F64(0))
WTV_WGMMA_RS(224, WTV_OPS10() WTV_OPS10(1) WTV_OPS10(2) WTV_OPS10(3) WTV_OPS10(4) WTV_OPS10(5)
             WTV_OPS10(6) WTV_OPS10(7) WTV_OPS10(8) WTV_OPS10(9) WTV_OPS10(10) "%110, %111",
             112, 113, 114, 115, 116, 117, WTV_F64(0), WTV_F32(64), WTV_F16(96))
WTV_WGMMA_RS(256, WTV_OPS10() WTV_OPS10(1) WTV_OPS10(2) WTV_OPS10(3) WTV_OPS10(4) WTV_OPS10(5)
             WTV_OPS10(6) WTV_OPS10(7) WTV_OPS10(8) WTV_OPS10(9) WTV_OPS10(10) WTV_OPS10(11)
             "%120, %121, %122, %123, %124, %125, %126, %127",
             128, 129, 130, 131, 132, 133, WTV_F64(0), WTV_F64(64))

#undef WTV_WGMMA_RS
#undef WTV_F64
#undef WTV_F32
#undef WTV_F16
#undef WTV_F4
#undef WTV_OPS10


}  // namespace hopper
