// o = softmax(q k^T * scale) v over one (sample, head) per block row:
// attention without the (l, l) score matrix in device memory, K and V
// streamed in 64-row tiles. The forward's tiled route: attention_fwd.cu
// (every key of a slice in shared memory, one block per slice) takes head
// width 64 and l <= 256; this kernel takes longer sequences (TimeSformer's
// 288² step: l = 325) and the other head widths (attention.py: fwd_route).
//
// Replaces the library Pallas TPU flash attention that
// workoutdetector_tpu/models/timesformer.py: _flash_mha calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py: flash_attention ->
// _flash_attention_impl), the forward; its backward (dK/dV and dQ) is in
// attention_bwd.cu and reads the log-sum-exp this kernel writes under
// autograd. The TPU kernel pads l to a multiple
// of 128 and masks the pad keys with segment ids; here no padding exists in
// memory: key columns >= l are set to -inf before the softmax, and rows past
// l are zero-filled in shared memory and never stored.
//
// q, k, v are (n, h, l, dh) bf16 views with a contiguous last dim and any
// other strides (TimeSformer passes thirds of its packed qkv projection, no
// copy); o is written to a contiguous (n, l, h, dh) buffer, so the head merge
// after the kernel is a free view.
//
// Bound on the H100: bytes at the 288² step's shape (n = 128 frames, h =
// 12, l = 325, dh = 64): q, k, v read once and o written once are 255.6 MB
// (76.3 us at 3.35 TB/s) against 4.15e10 FLOP (42.0 us at 989 TFLOP/s).
// Design (FlashAttention-2's, on mma.sync): one
// block of 4 warps per (n, h, 64-row query tile); each warp owns 16 query
// rows and keeps them in registers as mma A fragments. K and V stream through
// shared memory in 64-row tiles, double-buffered with cp.async. S = Q K^T and
// O += P V run on m16n8k16 bf16 tensor-core products with fp32 accumulators;
// the softmax is online in fp32 (running max and sum per row, in exp2), the
// accumulator layout of S is reused as the A operand of P V, so P never
// leaves registers. O is divided by the row sum once and rounded to bf16
// once. All 4 query tiles of a head re-read its K and V, from L2.
#include "attention_common.cuh"

namespace {

using namespace wdattn;

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H,
                 int l, int64_t qsn, int64_t qsh, int64_t qsl, int64_t ksn,
                 int64_t ksh, int64_t ksl, int64_t vsn, int64_t vsh,
                 int64_t vsl, float scale_log2) {
  // a row pitch of DH + 8 elements puts the 8 rows of an ldmatrix phase on
  // 8 different 16-byte bank groups
  constexpr int LD = DH + 8;
  constexpr int TILE = 64 * LD;
  constexpr int KD = DH / 16;  // k-steps of Q K^T
  constexpr int ND = DH / 8;   // n-tiles of O
  constexpr int NS = BN / 8;   // n-tiles of S
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TILE;          // 2 buffers
  bf16* sV = sK + 2 * TILE;      // 2 buffers

  const int q0 = blockIdx.x * BM;
  const int hh = blockIdx.y, nn = blockIdx.z;
  const bf16* qb = q + nn * qsn + hh * qsh;
  const bf16* kb = k + nn * ksn + hh * ksh;
  const bf16* vb = v + nn * vsn + hh * vsh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, column pair
  const int nt = (l + BN - 1) / BN;

  stage_rows<DH>(sQ, qb, qsl, q0, l);
  stage_rows<DH>(sK, kb, ksl, 0, l);
  stage_rows<DH>(sV, vb, vsl, 0, l);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float mrow[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float lrow[2] = {0.0f, 0.0f};  // this thread's share of the running sums

  // ldmatrix addresses: lane supplies row (lane & 7) of 8x8 matrix lane >> 3
  const int lm = lane >> 3, lr = lane & 7;

  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) {
      const int b = (j + 1) & 1;
      stage_rows<DH>(sK + b * TILE, kb, ksl, (j + 1) * BN, l);
      stage_rows<DH>(sV + b * TILE, vb, vsl, (j + 1) * BN, l);
      cp_async_commit();
      cp_async_wait<1>();  // tile j (and Q) landed; tile j + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      // A fragments of this warp's 16 query rows: matrices (rows 0-7 | 8-15)
      // x (cols 0-7 | 8-15) in the order a0 a1 a2 a3
      const bf16* qw = sQ + (warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], qw + kk * 16);
    }
    const bf16* tK = sK + (j & 1) * TILE;
    const bf16* tV = sV + (j & 1) * TILE;

    // S = Q K^T for 64 keys: s[n] covers keys 8n .. 8n + 7
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        // K rows are B's columns: matrices (keys 0-7: d 0-7, 8-15),
        // (keys 8-15: d 0-7, 8-15) = b0 b1 of n-tile 2np, b0 b1 of 2np + 1
        uint32_t b[4];
        ldmatrix_x4(b, tK + (np * 16 + (lm >> 1) * 8 + lr) * LD + kk * 16 +
                           (lm & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // online softmax in base 2; this thread holds rows g (c = 0, 1) and
    // g + 8 (c = 2, 3), keys 8n + 2 t4 + (c & 1)
    const int kv0 = j * BN;
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kv0 + i * 8 + 2 * t4 + (c & 1);
        const float x = key < l ? s[i][c] * scale_log2 : -INFINITY;
        s[i][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a row group share its rows
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 lies in tile 0, so mx is finite from the first tile on
      corr[r] = exp2f(mrow[r] - mx[r]);  // exp2(-inf) = 0 on the first tile
      mrow[r] = mx[r];
      lrow[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[i][c] - mrow[c >> 1]);  // masked keys: 0
        s[i][c] = p;
        lrow[c >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V: P's accumulator layout is the A layout of a 16-key step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        // V rows are B's rows (k = key): transposed matrices (keys 0-7 |
        // 8-15) x (d 0-7 | 8-15) = b0 b1 of d-tile 2dp, b0 b1 of 2dp + 1
        uint32_t b[4];
        ldmatrix_x4_trans(b, tV + (kk * 16 + (lm & 1) * 8 + lr) * LD +
                                 dp * 16 + (lm >> 1) * 8);
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // buffer j & 1 is free for tile j + 2
  }

  // full row sums, then one division and one rounding per output; under
  // autograd the row's log-sum-exp in natural log for the backward,
  // ln sum exp(s scale) = ln 2 (max + log2 sum), max and sum in base 2
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = lrow[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = 1.0f / sum;
    const int row = q0 + warp * 16 + g + 8 * r;
    if (lse != nullptr && t4 == 0 && row < l)
      lse[((int64_t)nn * H + hh) * l + row] = (mrow[r] + log2f(sum)) * LN2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= l) continue;
    bf16* orow = o + (((int64_t)nn * l + row) * H + hh) * DH + 2 * t4;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const uint32_t w = pack_bf16(acc[i][2 * r] * inv[r],
                                   acc[i][2 * r + 1] * inv[r]);
      *reinterpret_cast<uint32_t*>(orow + i * 8) = w;
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int N, int H, int l, const int64_t* st,
                   float scale, cudaStream_t stream) {
  constexpr int SMEM = 5 * 64 * (DH + 8) * 2;  // Q + 2 K + 2 V tiles
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((l + BM - 1) / BM), (unsigned)H, (unsigned)N);
  attention_kernel<DH><<<grid, NTHREADS, SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, H, l,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (N, H, l, dh) bf16 with unit last stride; strides = the (n, h, l)
// element strides of q, then k, then v (multiples of 8, 16-byte aligned
// bases). o: contiguous (N, l, H, dh) bf16. lse: null, or a contiguous
// (N, H, l) fp32 buffer for the rows' log-sum-exp (natural log) that the
// backward kernels read. dh in {16, 32, ..., 128}.
extern "C" int wd_attention_bf16(const void* q, const void* k, const void* v,
                                 void* o, float* lse, const int64_t* strides,
                                 int N, int H, int l, int dh, float scale,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || H == 0 || l == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 16: return (int)launch<16>(q, k, v, o, lse, N, H, l, strides, scale, s);
    case 32: return (int)launch<32>(q, k, v, o, lse, N, H, l, strides, scale, s);
    case 48: return (int)launch<48>(q, k, v, o, lse, N, H, l, strides, scale, s);
    case 64: return (int)launch<64>(q, k, v, o, lse, N, H, l, strides, scale, s);
    case 80: return (int)launch<80>(q, k, v, o, lse, N, H, l, strides, scale, s);
    case 96: return (int)launch<96>(q, k, v, o, lse, N, H, l, strides, scale, s);
    case 112: return (int)launch<112>(q, k, v, o, lse, N, H, l, strides, scale, s);
    case 128: return (int)launch<128>(q, k, v, o, lse, N, H, l, strides, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
