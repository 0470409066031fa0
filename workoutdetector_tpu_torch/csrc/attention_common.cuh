// Shared pieces of the attention kernels (attention.cu, attention_fwd.cu,
// attention_bwd.cu, attention_bwd_short.cu; fused_block.cu takes its
// cp.async and bf16 packing helpers):
// cp.async staging of 64-row tiles of one (sample, head) slice, ldmatrix
// fragment loads and the m16n8k16 bf16 tensor-core product with an fp32
// accumulator (mma.sync).
//
// Fragment layout of m16n8k16 (PTX ISA): with g = lane / 4 and t4 = lane % 4,
// an accumulator c[0..3] holds rows g (c = 0, 1) and g + 8 (c = 2, 3), columns
// 2 t4 + (c & 1) of its 16 x 8 tile. Two neighbouring n-tiles of an
// accumulator, packed to bf16 pairs, are exactly the A fragment of a 16-deep
// k-step, so a product's result feeds the next product without shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wdattn {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;  // rows of a block's own tile (16 per warp)
constexpr int BN = 64;  // rows of a streamed tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
constexpr float LN2 = 0.6931471805599453f;

// a row pitch of DH + 8 elements puts the 8 rows of an ldmatrix phase on 8
// different 16-byte bank groups
template <int DH>
__host__ __device__ constexpr int pitch() { return DH + 8; }
template <int DH>
__host__ __device__ constexpr int tile_elems() { return 64 * pitch<DH>(); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16-deep k-step from two neighbouring accumulator
// n-tiles (columns 16 kk .. 16 kk + 15 of the accumulator's row block).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ldmatrix addresses (lane supplies row lr of 8x8 matrix lm):
// A fragment of rows [r0, r0 + 16) x k [k0, k0 + 16) of a row-major tile:
// matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) in the order a0 a1 a2 a3.
template <int LD>
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int r0, int k0,
                                              int lane) {
  const int lm = lane >> 3, lr = lane & 7;
  return tile + (r0 + (lm & 1) * 8 + lr) * LD + k0 + (lm >> 1) * 8;
}
// B fragments of two n-tiles whose columns are tile rows [n0, n0 + 16), k
// along the row [k0, k0 + 16) (B = tileᵀ): b0 b1 of n-tile 0, b0 b1 of 1.
template <int LD>
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int n0, int k0,
                                               int lane) {
  const int lm = lane >> 3, lr = lane & 7;
  return tile + (n0 + (lm >> 1) * 8 + lr) * LD + k0 + (lm & 1) * 8;
}
// B fragments (ldmatrix .trans) of two n-tiles whose k runs down tile rows
// [k0, k0 + 16) and whose columns are tile columns [n0, n0 + 16) (B = tile).
template <int LD>
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int k0, int n0,
                                              int lane) {
  const int lm = lane >> 3, lr = lane & 7;
  return tile + (k0 + (lm & 1) * 8 + lr) * LD + n0 + (lm >> 1) * 8;
}

// Stage rows [r0, r0 + 64) of one (n, h) slice, row stride sl elements,
// into a 64 x LD tile; rows >= l are zero.
template <int DH>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base,
                                           int64_t sl, int r0, int l) {
  constexpr int LD = pitch<DH>();
  constexpr int VPR = DH / 8;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < 64 * VPR; v += NTHREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    const bool ok = r0 + r < l;
    cp_async16(dst + r * LD + c, ok ? base + (int64_t)(r0 + r) * sl + c : base,
               ok);
  }
}

}  // namespace wdattn
