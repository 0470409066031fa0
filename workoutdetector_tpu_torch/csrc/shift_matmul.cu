// y = shift(x) @ W: the TSM temporal shift fused into a stride-1 1x1 conv.
//
// Replaces workoutdetector_tpu/ops/pallas/shift_matmul.py:
// _shift_matmul_fwd_impl (_kernel), forward only. x is (M = B*T*HW, C) bf16
// rows r = (b*T + t)*HW + p, W is (C, N) bf16, y is (M, N) bf16 with an fp32
// accumulator, rounded once on store.
//
// Bound on the H100: at the R50 sites (K = C = 256..2048, N = 128..512) the
// arithmetic intensity is 2*M*K*N / (2*(M*K + K*N + M*N)) ~ 85..390
// FLOP/byte; under the card's ~295 FLOP/byte bf16 ridge bytes bind (x read
// once, W once, y written once), at the three layer4 sites (N = 512) the
// tensor cores do. Design: a plain GEMM over the rows; the shift lives in the
// A-tile loader, which takes the first fold channels of row r from row
// r + HW and the next fold from row r - HW, and zero-fills them at
// t = T-1 / t = 0 of the same clip (the flat roll would otherwise wrap into
// the neighbouring clip). No shifted tensor is written. The TPU kernel's
// all-T slab (so x is read once per tile) is unnecessary here: the
// neighbouring frames' rows are read from L2 by the tiles that own them.
// Tiles: 128 rows x 128 columns per block of 8 warps (2 x 4, each 64 x 32)
// on WMMA bf16 fragments,
// K streamed 32 deep through a 3-deep cp.async ring; 2 blocks per SM.
#include "wd_tile.cuh"

namespace {

using namespace wd;

constexpr int MT = 8;  // 128 rows per block
constexpr int SMEM = a_stage_bytes(MT) + B_STAGE_BYTES;

struct ShiftRows {
  const bf16* x;
  int64_t M, HW, m0;
  int T, C, fold;
  __device__ __forceinline__ const bf16* operator()(int r, int k) const {
    const int64_t row = m0 + r;
    if (row >= M) return nullptr;
    int64_t src = row;
    if (k < fold) {
      if ((row / HW) % T == T - 1) return nullptr;
      src = row + HW;
    } else if (k < 2 * fold) {
      if ((row / HW) % T == 0) return nullptr;
      src = row - HW;
    }
    return x + src * C + k;
  }
};

__global__ void __launch_bounds__(NTHREADS, 2)
shift_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ y, int64_t M, int64_t HW, int T, int C,
                    int N, int fold) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + a_stage_bytes(MT));
  float* scratch = reinterpret_cast<float*>(sB);
  const int64_t m0 = (int64_t)blockIdx.x * MT * 16;
  const int n0 = blockIdx.y * NC;
  const int ntv = min(NC, N - n0) / 16;
  StagedA<MT, ShiftRows> a{ShiftRows{x, M, HW, m0, T, C, fold}, x, sA};
  Acc<MT> acc;
  block_gemm<MT>(acc, a, C, w, N, n0, ntv, sB);
  block_epilogue<MT>(acc, (Acc<MT>*)nullptr, ntv, scratch,
                 [&](int r, int c, const float* v, const float*) {
                   const int64_t row = m0 + r;
                   if (row < M) store8(y + row * N + n0 + c, v);
                 });
}

}  // namespace

// x (M, C), w (C, N), y (M, N): contiguous bf16; C % 8 == 0, N % 16 == 0,
// fold % 8 == 0, 16-byte aligned.
extern "C" int wd_shift_matmul_bf16(const void* x, const void* w, void* y,
                                    int64_t M, int64_t HW, int T, int C, int N,
                                    int fold, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  err = cudaFuncSetAttribute(shift_matmul_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((M + MT * 16 - 1) / (MT * 16)), (unsigned)((N + NC - 1) / NC));
  shift_matmul_kernel<<<grid, NTHREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)y, M, HW, T, C, N, fold);
  return (int)cudaGetLastError();
}
