// The WMMA pieces of csrc/fused_block_wmma.cu (the fused bottleneck's route
// for the widths the wgmma kernel of fused_block.cu leaves out; the other
// kernels are built on wd_wgmma.cuh): cp.async staging, a block-level bf16
// GEMM on WMMA tensor-core fragments with an fp32 accumulator, and the
// epilogue that hands each thread eight output columns of one row.
//
// Tiling. A block of 8 warps computes an (MT*16) x NC tile of C = A @ B
// for NC = 128 output columns. K is streamed in chunks of KC = 32 through a
// STAGES-deep cp.async ring: B (a row-major K x N weight in device
// memory, read through L2) is always staged; A is either staged from device
// memory through a row-source functor (which may gather, shift or zero a
// row) or read in place from shared memory. The 8 warps form a WM x WN grid
// (2 x 4 when the pass has >= 4 column tiles) over the MT x ntv grid of
// 16x16 output tiles: warp (wm, wn) owns rows wm, wm+WM, ... and columns
// wn, wn+WN, ..., so per k-step it loads each of its A and B fragments once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace wd {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int STAGES = 3;  // K chunks in flight: hides L2/HBM latency
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KC = 32;        // K depth of one staged chunk
constexpr int NC = 128;       // output columns of one pass
// staged pitches: 80 and 272 bytes put the 8 rows of an ldmatrix phase on
// 8 different 16-byte bank groups, and keep every 16-row tile 32-byte aligned
constexpr int LDA = KC + 8;
constexpr int LDB = NC + 8;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// bytes of the B ring and of an A ring for MT row tiles
constexpr int B_STAGE_BYTES = STAGES * KC * LDB * 2;
__host__ __device__ constexpr int a_stage_bytes(int mt) { return STAGES * mt * 16 * LDA * 2; }
// the epilogue's per-warp 16x16 fp32 tile (two with a second accumulator);
// it lives in the B ring, which is idle between block_gemm calls
constexpr int SCRATCH_BYTES = NWARPS * 256 * 4;
static_assert(2 * SCRATCH_BYTES <= B_STAGE_BYTES, "scratch must fit in the B ring");

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

__device__ __forceinline__ void load8(const bf16* src, float* v) {
  uint4 u = *reinterpret_cast<const uint4*>(src);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16(v[j]);  // round to nearest even
  *reinterpret_cast<uint4*>(dst) = u;
}

// Stage rows [k0, k0+KC) x cols [n0, n0+NC) of a row-major K x N matrix;
// out-of-range vectors are zero. N % 8 == 0.
__device__ __forceinline__ void stage_b(bf16* sB, const bf16* W, int K, int N,
                                        int k0, int n0) {
  for (int v = threadIdx.x; v < KC * NC / 8; v += NTHREADS) {
    const int r = v / (NC / 8), c = (v % (NC / 8)) * 8;
    const int k = k0 + r, n = n0 + c;
    const bool ok = k < K && n < N;
    cp_async16(sB + r * LDB + c, ok ? W + (int64_t)k * N + n : W, ok);
  }
}

// A staged from device memory: rows(r, k) returns the address of the eight
// channels [k, k+8) of block row r, or nullptr for a zero row segment.
template <int MT, class Rows>
struct StagedA {
  Rows rows;
  const bf16* any;  // a valid address for the zero-filled copies
  bf16* sA;         // a_stage_bytes(MT) of shared memory
  __device__ __forceinline__ void stage(int buf, int K, int k0) const {
    bf16* dst = sA + buf * MT * 16 * LDA;
    for (int v = threadIdx.x; v < MT * 16 * (KC / 8); v += NTHREADS) {
      const int r = v / (KC / 8), c = (v % (KC / 8)) * 8;
      const int k = k0 + c;
      const bf16* p = k < K ? rows(r, k) : nullptr;
      cp_async16(dst + r * LDA + c, p ? p : any, p != nullptr);
    }
  }
  __device__ __forceinline__ const bf16* frag(int buf, int mt, int k0,
                                              int ks, int* ld) const {
    *ld = LDA;
    return sA + buf * MT * 16 * LDA + mt * 16 * LDA + ks;
  }
};

// A already in shared memory: at(mt, k) is the address of element (mt*16, k)
// of a 16-row tile whose rows are lda apart (32-byte aligned).
template <class At>
struct SmemA {
  At at;
  int lda;
  __device__ __forceinline__ void stage(int, int, int) const {}
  __device__ __forceinline__ const bf16* frag(int, int mt, int k0, int ks,
                                              int* ld) const {
    *ld = lda;
    return at(mt, k0 + ks);
  }
};

// The warp grid for a pass with ntv column tiles, and this warp's place in it.
struct WarpTiles {
  int WM, WN, wm, wn;
  __device__ __forceinline__ explicit WarpTiles(int ntv) {
    WN = ntv >= 4 ? 4 : ntv >= 2 ? 2 : 1;  // divides 8; 2 * WN >= ntv
    WM = NWARPS / WN;
    const int warp = threadIdx.x / 32;
    wm = warp / WN;
    wn = warp % WN;
  }
};

// Accumulators of one warp: [m][n] for output tiles (wm + m*WM, wn + n*WN).
// MTW = (MT + 1) / 2 covers the 2 x 4 grid; narrower grids use fewer.
template <int MT>
using Acc = FragC[(MT + 1) / 2][2];

// acc = A[:, :K] @ B[:K, n0:n0+16*ntv] for the warp's tiles. Starts and
// ends with a barrier, so the rings (and the epilogue scratch in the B
// ring) are free for the caller before and after.
template <int MT, int MTW, class ASrc>
__device__ __forceinline__ void block_gemm(FragC (&acc)[MTW][2], const ASrc& a,
                                           int K, const bf16* W, int N, int n0,
                                           int ntv, bf16* sB) {
  const WarpTiles wt(ntv);
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const int nk = (K + KC - 1) / KC;
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {  // prologue: chunks 0..STAGES-2
    if (s < nk) {
      a.stage(s, K, s * KC);
      stage_b(sB + s * KC * LDB, W, K, N, s * KC, n0);
    }
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc % STAGES;
    cp_async_wait<STAGES - 2>();  // chunk kc has landed
    __syncthreads();              // ... for every thread; chunk kc-1 is consumed
    const int next = kc + STAGES - 1;
    if (next < nk) {
      a.stage(next % STAGES, K, next * KC);
      stage_b(sB + (next % STAGES) * KC * LDB, W, K, N, next * KC, n0);
    }
    cp_async_commit();
    const bf16* b = sB + cur * KC * LDB;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      if (kc * KC + ks >= K) break;  // the rest of the chunk is zero fill
      FragA fa[MTW];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        const int mt = wt.wm + i * wt.WM;
        if (mt < MT) {
          int ld;
          const bf16* ap = a.frag(cur, mt, kc * KC, ks, &ld);
          wmma::load_matrix_sync(fa[i], ap, ld);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = wt.wn + j * wt.WN;
        if (nt < ntv) wmma::load_matrix_sync(fb[j], b + ks * LDB + nt * 16, LDB);
      }
#pragma unroll
      for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (wt.wm + i * wt.WM < MT && wt.wn + j * wt.WN < ntv)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// For each tile the warp owns: fn(row, col, v[8], v2[8]) with row in
// [0, MT*16), col in [0, 16*ntv) relative to the pass, v the eight fp32
// sums [col, col+8) of that row and v2 the same from acc2 (when given).
template <int MT, int MTW, class Fn>
__device__ __forceinline__ void block_epilogue(FragC (&acc)[MTW][2],
                                               FragC (*acc2)[MTW][2], int ntv,
                                               float* scratch, Fn fn) {
  const WarpTiles wt(ntv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s = scratch + warp * 256;
  float* s2 = scratch + (NWARPS + warp) * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int mt = wt.wm + i * wt.WM, nt = wt.wn + j * wt.WN;
      if (mt < MT && nt < ntv) {
        wmma::store_matrix_sync(s, acc[i][j], 16, wmma::mem_row_major);
        if (acc2) wmma::store_matrix_sync(s2, (*acc2)[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        float v[8], v2[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          v[k] = s[r * 16 + c + k];
          v2[k] = acc2 ? s2[r * 16 + c + k] : 0.0f;
        }
        fn(mt * 16 + r, nt * 16 + c, v, v2);
        __syncwarp();
      }
    }
  }
}

}  // namespace wd
