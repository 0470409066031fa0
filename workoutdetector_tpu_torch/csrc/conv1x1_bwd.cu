// Backward of a stride-1 1x1 conv (a matmul over rows r = (b*T + t)*HW + p):
//
//   dx = g @ W^T          (M, O) @ (O, C) -> (M, C), g's dtype (bf16)
//   dW = A^T @ g          (M, C)^T @ (M, O) -> (C, O), fp32
//
// optionally for the TSM-shifted conv1, y = shift(x) @ W, where A = shift(x)
// and dx = S^T (g @ W^T), S being the fold shift.
//
// Replaces workoutdetector_tpu/ops/pallas/conv1x1.py: _dx_pallas (_dx_kernel)
// and _dw_pallas (_dw_kernel), as make_conv1x1 and make_shift_conv1x1 use
// them (the JAX package applies S^T and shift(x) outside the kernels).
//
// Bound on the H100: bytes at most sites. At the TSM-R50 224² sites the
// arithmetic intensity runs from 32 FLOP/byte (layer1, 64 x 64) to ~400
// (layer4, 2048 x 512): under the card's ~295 FLOP/byte bf16 ridge except
// at the six layer4 sites, where the tensor cores bind. Bytes count g, x
// (or W) read once and dx (or dW) written once.
//
// dx design: the shift_matmul GEMM (wd_tile.cuh: 128 x 128 tiles, 8 warps,
// WMMA bf16 with an fp32 accumulator, K streamed through a 3-deep cp.async
// ring) over plain rows of g. S^T is the epilogue: it is a permutation of
// rows within each clip for the two fold column ranges, so each 8-column
// segment of dsh row j is stored to the row S^T sends it to -- j + HW for
// the first fold, j - HW for the second -- and the row S^T leaves empty
// (t = 0 for the first fold, t = T-1 for the second) is written with zeros
// by the writer at the clip's other end. Every dx element has exactly one
// writer, so no extra pass over dx and no shifted copy is made.
//
// dW design: the TPU kernel carried one fp32 (C, O) sum across a sequential
// grid over rows. Blocks on this card run in parallel, and at layer1
// ((C, O) = (64, 256), 802,816 rows) one block per output tile would leave
// 130 of 132 SMs idle. So the rows are split into S contiguous chunks; a
// block computes one 128 x 128 (C, O) tile over one chunk and writes its
// fp32 partial to a workspace (S, C, O); a second kernel sums the S partials
// in split order. No atomics: the result is the same on every run. The A
// loader of the shifted variant reads the fold columns from rows r +- HW and
// zero-fills them at the clip's ends, as shift_matmul's does, so no shifted
// copy of x is written.
#include "wd_tile.cuh"

namespace {

using namespace wd;

// ---------------------------------------------------------------- dx

constexpr int DX_MT = 8;  // 128 rows per block
constexpr int DX_SMEM = a_stage_bytes(DX_MT) + B_STAGE_BYTES;

struct PlainRows {
  const bf16* g;
  int64_t M, m0;
  int K;
  __device__ __forceinline__ const bf16* operator()(int r, int k) const {
    const int64_t row = m0 + r;
    return row < M ? g + row * K + k : nullptr;
  }
};

__global__ void __launch_bounds__(NTHREADS, 2)
conv1x1_dx_kernel(const bf16* __restrict__ g, const bf16* __restrict__ wt,
                  bf16* __restrict__ dx, int64_t M, int O, int C, int64_t HW,
                  int T, int fold) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + a_stage_bytes(DX_MT));
  float* scratch = reinterpret_cast<float*>(sB);
  const int64_t m0 = (int64_t)blockIdx.x * DX_MT * 16;
  const int n0 = blockIdx.y * NC;
  const int ntv = min(NC, C - n0) / 16;
  StagedA<DX_MT, PlainRows> a{PlainRows{g, M, m0, O}, g, sA};
  Acc<DX_MT> acc;
  block_gemm<DX_MT>(acc, a, O, wt, C, n0, ntv, sB);
  block_epilogue<DX_MT>(
      acc, (Acc<DX_MT>*)nullptr, ntv, scratch,
      [&](int r, int c, const float* v, const float*) {
        const int64_t j = m0 + r;
        if (j >= M) return;
        const int col = n0 + c;
        int64_t dst = j;
        bool zero = false;
        if (col < 2 * fold) {
          const int t = (int)((j / HW) % T);
          if (col < fold) {  // S: row i reads i + HW; S^T: j goes to j + HW
            if (t == T - 1) {
              dst = j - (int64_t)(T - 1) * HW;  // the clip's t = 0 row: zero
              zero = true;
            } else {
              dst = j + HW;
            }
          } else {  // S: row i reads i - HW; S^T: j goes to j - HW
            if (t == 0) {
              dst = j + (int64_t)(T - 1) * HW;  // the clip's t = T-1 row: zero
              zero = true;
            } else {
              dst = j - HW;
            }
          }
        }
        if (zero) {
          *reinterpret_cast<uint4*>(dx + dst * C + col) = make_uint4(0, 0, 0, 0);
        } else {
          store8(dx + dst * C + col, v);
        }
      });
}

// ---------------------------------------------------------------- dW

constexpr int DW_T = 128;        // (C, O) tile edge
constexpr int DW_LD = DW_T + 8;  // staged pitch, 272 bytes (as LDB)
constexpr int DW_STAGE = KC * DW_LD;  // elements of one staged chunk
constexpr int DW_SMEM = 2 * STAGES * DW_STAGE * 2;  // x and g rings, bytes
constexpr int DW_MF = 4;  // per warp: 4 C fragments x 2 O fragments
constexpr int DW_NF = 2;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;

struct DwArgs {
  const bf16* x;
  const bf16* g;
  float* out;  // (S, C, O) fp32 partials, or (C, O) when S == 1
  int64_t M, HW, chunk;
  int C, O, T, fold;
};

// Stage rows [k0, k0 + KC) of this block's chunk: x columns [c0, c0 + 128)
// (the fold columns from the neighbouring frames) and g columns [o0, o0 + 128).
__device__ __forceinline__ void dw_stage(const DwArgs& p, bf16* sx, bf16* sg,
                                         int64_t k0, int64_t kend, int c0,
                                         int o0) {
  for (int v = threadIdx.x; v < KC * DW_T / 8; v += NTHREADS) {
    const int rr = v / (DW_T / 8), cc = (v % (DW_T / 8)) * 8;
    const int64_t row = k0 + rr;
    const bool in_rows = row < kend;
    // x
    const int col = c0 + cc;
    int64_t src = row;
    bool ok = in_rows && col < p.C;
    if (ok && col < 2 * p.fold) {
      const int t = (int)((row / p.HW) % p.T);
      if (col < p.fold) {
        ok = t != p.T - 1;
        src = row + p.HW;
      } else {
        ok = t != 0;
        src = row - p.HW;
      }
    }
    cp_async16(sx + rr * DW_LD + cc, ok ? p.x + src * p.C + col : p.x, ok);
    // g
    const int oc = o0 + cc;
    const bool okg = in_rows && oc < p.O;
    cp_async16(sg + rr * DW_LD + cc, okg ? p.g + row * p.O + oc : p.g, okg);
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
conv1x1_dw_kernel(DwArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sx = reinterpret_cast<bf16*>(smem);
  bf16* sg = sx + STAGES * DW_STAGE;
  const int c0 = blockIdx.x * DW_T, o0 = blockIdx.y * DW_T;
  const int mtv = min(DW_T, p.C - c0) / 16, ntv = min(DW_T, p.O - o0) / 16;
  const int64_t kbeg = (int64_t)blockIdx.z * p.chunk;
  const int64_t kend = min(kbeg + p.chunk, p.M);
  const int nk = (int)((kend - kbeg + KC - 1) / KC);
  // warps 2 x 4 over the tile's 8 x 8 fragments, interleaved so a narrow
  // tile (C or O = 64) still spreads over every warp
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
  FragC acc[DW_MF][DW_NF];
#pragma unroll
  for (int i = 0; i < DW_MF; ++i)
#pragma unroll
    for (int j = 0; j < DW_NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      dw_stage(p, sx + s * DW_STAGE, sg + s * DW_STAGE, kbeg + s * KC, kend,
               c0, o0);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kc + STAGES - 1;
    if (next < nk)
      dw_stage(p, sx + (next % STAGES) * DW_STAGE, sg + (next % STAGES) * DW_STAGE,
               kbeg + (int64_t)next * KC, kend, c0, o0);
    cp_async_commit();
    const bf16* bx = sx + cur * DW_STAGE;
    const bf16* bg = sg + cur * DW_STAGE;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      FragAT fa[DW_MF];
      FragB fb[DW_NF];
#pragma unroll
      for (int i = 0; i < DW_MF; ++i) {
        const int mt = wm + 2 * i;
        // A^T tile (c, r) sits column-major in the staged (r, c) chunk
        if (mt < mtv) wmma::load_matrix_sync(fa[i], bx + ks * DW_LD + mt * 16, DW_LD);
      }
#pragma unroll
      for (int j = 0; j < DW_NF; ++j) {
        const int nt = wn + 4 * j;
        if (nt < ntv) wmma::load_matrix_sync(fb[j], bg + ks * DW_LD + nt * 16, DW_LD);
      }
#pragma unroll
      for (int i = 0; i < DW_MF; ++i)
#pragma unroll
        for (int j = 0; j < DW_NF; ++j)
          if (wm + 2 * i < mtv && wn + 4 * j < ntv)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  float* out = p.out + (int64_t)blockIdx.z * p.C * p.O;
#pragma unroll
  for (int i = 0; i < DW_MF; ++i)
#pragma unroll
    for (int j = 0; j < DW_NF; ++j) {
      const int mt = wm + 2 * i, nt = wn + 4 * j;
      if (mt < mtv && nt < ntv)
        wmma::store_matrix_sync(out + (int64_t)(c0 + mt * 16) * p.O + o0 + nt * 16,
                                acc[i][j], p.O, wmma::mem_row_major);
    }
}

// out[i] = sum over s = 0..S-1 of part[s][i], in that order
__global__ void dw_reduce_kernel(const float4* __restrict__ part,
                                 float4* __restrict__ out, int64_t n4, int S) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int k = 1; k < S; ++k) {
      const float4 v = part[(int64_t)k * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

}  // namespace

// g (M, O), wt (O, C), dx (M, C): contiguous bf16, 16-byte aligned;
// O % 8 == 0, C % 16 == 0, fold % 8 == 0. fold == 0: dx = g @ wt; else
// dx = S^T (g @ wt) over clips of T frames of HW rows.
extern "C" int wd_conv1x1_dx_bf16(const void* g, const void* wt, void* dx,
                                  int64_t M, int O, int C, int64_t HW, int T,
                                  int fold, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  err = cudaFuncSetAttribute(conv1x1_dx_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DX_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((M + DX_MT * 16 - 1) / (DX_MT * 16)),
            (unsigned)((C + NC - 1) / NC));
  conv1x1_dx_kernel<<<grid, NTHREADS, DX_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)wt, (bf16*)dx, M, O, C, HW, T, fold);
  return (int)cudaGetLastError();
}

// x (M, C), g (M, O): contiguous bf16, 16-byte aligned; C % 16 == 0,
// O % 16 == 0, fold % 8 == 0. dw (C, O) fp32. The rows are split into
// ceil(M / chunk) chunks of `chunk` rows (a multiple of 32); with more than
// one, work holds that many (C, O) fp32 partials. fold > 0 shifts x's fold
// columns as S does.
extern "C" int wd_conv1x1_dw_bf16(const void* x, const void* g, void* dw,
                                  void* work, int64_t M, int C, int O,
                                  int64_t HW, int T, int fold, int64_t chunk,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = (int64_t)C * O;
  if (M == 0) return (int)cudaMemsetAsync(dw, 0, n * sizeof(float), s);
  if (chunk < KC || chunk % KC) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(conv1x1_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int64_t splits = (M + chunk - 1) / chunk;
  DwArgs p{(const bf16*)x, (const bf16*)g, splits == 1 ? (float*)dw : (float*)work,
           M, HW, chunk, C, O, T, fold};
  dim3 grid((unsigned)((C + DW_T - 1) / DW_T), (unsigned)((O + DW_T - 1) / DW_T),
            (unsigned)splits);
  conv1x1_dw_kernel<<<grid, NTHREADS, DW_SMEM, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t n4 = n / 4;
  const int64_t want = (n4 + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  dw_reduce_kernel<<<blocks, 256, 0, s>>>((const float4*)work, (float4*)dw, n4,
                                         (int)splits);
  return (int)cudaGetLastError();
}
