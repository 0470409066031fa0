// One whole stride-1 inference ResNet bottleneck in one kernel, on WMMA: the
// route of fused_bottleneck for the widths the wgmma kernel of
// fused_block.cu leaves out (F other than 64 and 128, a downsample over more
// than 256 channels). It computes
//
//   y1  = relu(s1 * (shift(x) @ W1) + b1)          1x1, BN folded, -> bf16
//   y2  = relu(s2 * conv3x3_same(y1) + b2)          -> bf16
//   y3  = s3 * (y2 @ W3) + b3                       fp32
//   out = relu(y3 + res), res = x or sd * (x @ Wd) + bd   (fp32) -> bf16
//
// Replaces workoutdetector_tpu/ops/pallas/fused_block.py: fused_bottleneck
// (_kernel), with the same rounding points (y1 and y2 in bf16; the
// residual, its downsample and the sum in fp32).
//
// Bound on the H100: at layer1/layer2 (C = 256/512, F = 64/128) the block
// does ~140 FLOP per byte of x + out, under the ~295 FLOP/byte bf16 ridge,
// so bytes bind: x read once and out written once. Design: the TPU kernel
// kept an all-T x row-tile x W x C slab in VMEM; at layer1 that is
// megabytes, and a Hopper block has 227 KB of shared memory. Here a block
// owns one frame's TH x TW = 4 x 16 output tile. Because the shift only
// reads frames t+-1 at the same pixel, conv1 runs over the tile plus a 1-px
// halo (6 x 18 pixels) with its A loader taking the two fold slices from
// the neighbouring frames of the same clip; y1 and y2 never leave shared
// memory. The weights are not held resident (layer2's W2 alone is 295 KB):
// every GEMM streams its weight in 32-deep K chunks from L2, which all
// blocks share, through a 3-deep cp.async ring; two blocks per SM (<= 128
// registers) keep the other's chunks in flight across barriers. Conv1 output at halo pixels outside the frame is zeroed
// AFTER the ReLU: it stands in for conv2's zero padding. conv2 reads y1 in
// place: with TW = 16 every 16-row fragment of an output row is 16
// consecutive halo pixels, so each of the 9 taps is a plain row offset.
#include "wd_tile.cuh"

namespace {

using namespace wd;

constexpr int TH = 4, TW = 16;       // output tile
constexpr int HH = TH + 2, HWD = TW + 2;  // halo tile
constexpr int M1 = HH * HWD;         // 108 halo pixels
constexpr int MT1 = (M1 + 15) / 16;  // 7 row tiles for conv1
constexpr int MT2 = TH * TW / 16;    // 4 row tiles (one per output row)

__host__ __device__ constexpr int ldf(int F) { return F + 16; }
__host__ __device__ constexpr int y1_bytes(int F) { return MT1 * 16 * ldf(F) * 2; }
__host__ __device__ constexpr int y2_bytes(int F) { return MT2 * 16 * ldf(F) * 2; }
__host__ __device__ constexpr int smem_bytes(int F) {
  return a_stage_bytes(MT1) + B_STAGE_BYTES + y1_bytes(F) + y2_bytes(F);
}

struct Geometry {
  int H, W, C, T, fold;
  int n, ty0, tx0;  // frame, tile origin
  __device__ __forceinline__ bool inside(int gy, int gx) const {
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
};

// conv1 rows: the halo pixels, with the fold channels from frames n+-1
struct HaloRows {
  const bf16* x;
  Geometry g;
  __device__ __forceinline__ const bf16* operator()(int r, int k) const {
    if (r >= M1) return nullptr;
    const int gy = g.ty0 - 1 + r / HWD, gx = g.tx0 - 1 + r % HWD;
    if (!g.inside(gy, gx)) return nullptr;
    int src = g.n;
    if (k < g.fold) {
      if (g.n % g.T == g.T - 1) return nullptr;
      src = g.n + 1;
    } else if (k < 2 * g.fold) {
      if (g.n % g.T == 0) return nullptr;
      src = g.n - 1;
    }
    return x + (((int64_t)src * g.H + gy) * g.W + gx) * g.C + k;
  }
};

// downsample rows: the unshifted output-tile pixels
struct CenterRows {
  const bf16* x;
  Geometry g;
  __device__ __forceinline__ const bf16* operator()(int r, int k) const {
    const int gy = g.ty0 + r / TW, gx = g.tx0 + r % TW;
    if (!g.inside(gy, gx)) return nullptr;
    return x + (((int64_t)g.n * g.H + gy) * g.W + gx) * g.C + k;
  }
};

struct Conv2Taps {  // im2col view of y1: k = (dy*3 + dx)*F + ci
  const bf16* y1;
  int F;
  __device__ __forceinline__ const bf16* operator()(int mt, int k) const {
    const int tap = k / F, ci = k % F;
    return y1 + ((mt + tap / 3) * HWD + tap % 3) * ldf(F) + ci;
  }
};

struct Rows16 {  // plain row-major tile with pitch ld
  const bf16* base;
  int ld;
  __device__ __forceinline__ const bf16* operator()(int mt, int k) const {
    return base + mt * 16 * ld + k;
  }
};

__global__ void __launch_bounds__(NTHREADS, 2)
fused_bottleneck_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                        const float* __restrict__ sb1, const bf16* __restrict__ w2,
                        const float* __restrict__ sb2, const bf16* __restrict__ w3,
                        const float* __restrict__ sb3, const bf16* __restrict__ wd,
                        const float* __restrict__ sbd, bf16* __restrict__ out,
                        int H, int W, int C, int F, int O, int T, int fold,
                        int tiles_x, int tiles_per_frame) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + a_stage_bytes(MT1));
  bf16* y1 = reinterpret_cast<bf16*>(smem + a_stage_bytes(MT1) + B_STAGE_BYTES);
  bf16* y2 = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(y1) + y1_bytes(F));
  float* scratch = reinterpret_cast<float*>(sB);  // idle between GEMMs

  const int n = blockIdx.x / tiles_per_frame;
  const int tile = blockIdx.x % tiles_per_frame;
  const Geometry g{H, W, C, T, fold, n, (tile / tiles_x) * TH, (tile % tiles_x) * TW};
  const int LDF = ldf(F);

  // conv1 over tile + halo: shift -> 1x1 -> BN -> ReLU, zero outside the frame
  {
    StagedA<MT1, HaloRows> a{HaloRows{x, g}, x, sA};
    for (int n0 = 0; n0 < F; n0 += NC) {
      const int ntv = min(NC, F - n0) / 16;
      Acc<MT1> acc;
      block_gemm<MT1>(acc, a, C, w1, F, n0, ntv, sB);
      block_epilogue<MT1>(acc, (Acc<MT1>*)nullptr, ntv, scratch,
                     [&](int r, int c, const float* v, const float*) {
                       if (r >= M1) return;
                       const int gy = g.ty0 - 1 + r / HWD, gx = g.tx0 - 1 + r % HWD;
                       const bool in = g.inside(gy, gx);
                       float o[8];
#pragma unroll
                       for (int j = 0; j < 8; ++j) {
                         const int ch = n0 + c + j;
                         o[j] = in ? fmaxf(v[j] * sb1[ch] + sb1[F + ch], 0.0f) : 0.0f;
                       }
                       store8(y1 + r * LDF + n0 + c, o);
                     });
    }
  }
  __syncthreads();

  // conv2: 3x3 SAME over y1 in shared memory -> BN -> ReLU
  {
    SmemA<Conv2Taps> a{Conv2Taps{y1, F}, LDF};
    for (int n0 = 0; n0 < F; n0 += NC) {
      const int ntv = min(NC, F - n0) / 16;
      Acc<MT2> acc;
      block_gemm<MT2>(acc, a, 9 * F, w2, F, n0, ntv, sB);
      block_epilogue<MT2>(acc, (Acc<MT2>*)nullptr, ntv, scratch,
                     [&](int r, int c, const float* v, const float*) {
                       float o[8];
#pragma unroll
                       for (int j = 0; j < 8; ++j) {
                         const int ch = n0 + c + j;
                         o[j] = fmaxf(v[j] * sb2[ch] + sb2[F + ch], 0.0f);
                       }
                       store8(y2 + r * LDF + n0 + c, o);
                     });
    }
  }
  __syncthreads();

  // conv3 + residual (+ downsample) + ReLU, written straight to out
  {
    SmemA<Rows16> a3{Rows16{y2, LDF}, LDF};
    StagedA<MT2, CenterRows> ad{CenterRows{x, g}, x, sA};
    for (int n0 = 0; n0 < O; n0 += NC) {
      const int ntv = min(NC, O - n0) / 16;
      Acc<MT2> acc, accd;
      block_gemm<MT2>(acc, a3, F, w3, O, n0, ntv, sB);
      if (wd != nullptr) block_gemm<MT2>(accd, ad, C, wd, O, n0, ntv, sB);
      block_epilogue<MT2>(acc, wd != nullptr ? &accd : nullptr, ntv, scratch,
                     [&](int r, int c, const float* v, const float* vd) {
                       const int gy = g.ty0 + r / TW, gx = g.tx0 + r % TW;
                       if (!g.inside(gy, gx)) return;
                       const int64_t pix = ((int64_t)g.n * H + gy) * W + gx;
                       float res[8];
                       if (wd != nullptr) {
#pragma unroll
                         for (int j = 0; j < 8; ++j) {
                           const int ch = n0 + c + j;
                           res[j] = vd[j] * sbd[ch] + sbd[O + ch];
                         }
                       } else {
                         load8(x + pix * C + n0 + c, res);
                       }
                       float o[8];
#pragma unroll
                       for (int j = 0; j < 8; ++j) {
                         const int ch = n0 + c + j;
                         o[j] = fmaxf(v[j] * sb3[ch] + sb3[O + ch] + res[j], 0.0f);
                       }
                       store8(out + pix * O + n0 + c, o);
                     });
    }
  }
}

}  // namespace

// x (NF, H, W, C) bf16; w1 (C, F), w2 (9F, F) = HWIO (3,3,F,F) flattened,
// w3 (F, O), wd (C, O) or null (then C == O): bf16. sb*: (2, ch) fp32
// [scale; bias]. out (NF, H, W, O) bf16. T = frames per clip (1 when
// fold == 0). C % 8 == 0, F % 32 == 0, O % 16 == 0, fold % 8 == 0.
extern "C" int wd_fused_bottleneck_wmma_bf16(
    const void* x, const void* w1, const void* sb1, const void* w2,
    const void* sb2, const void* w3, const void* sb3, const void* wd,
    const void* sbd, void* out, int NF, int H, int W, int C, int F, int O,
    int T, int fold, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (NF == 0) return 0;
  const int smem = smem_bytes(F);
  err = cudaFuncSetAttribute(fused_bottleneck_wmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_per_frame = tiles_x * ((H + TH - 1) / TH);
  const int64_t blocks = (int64_t)NF * tiles_per_frame;
  fused_bottleneck_wmma_kernel<<<(unsigned)blocks, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)sb1, (const bf16*)w2,
      (const float*)sb2, (const bf16*)w3, (const float*)sb3, (const bf16*)wd,
      (const float*)sbd, (bf16*)out, H, W, C, F, O, T, fold, tiles_x,
      tiles_per_frame);
  return (int)cudaGetLastError();
}
