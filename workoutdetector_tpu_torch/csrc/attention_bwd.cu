// Backward of o = softmax(q k^T * scale) v over one (sample, head) per block
// row, from the forward's residuals: with P = exp(q k^T scale - lse) (the
// forward kernel's log-sum-exp per query row), D = rowsum(dO o O) and
// dS = P o (dO v^T - D), the gradient of the scaled scores,
//   dV = P^T dO,   dK = scale dS^T q,   dQ = scale dS k.
//
// attention_bwd's route for the sequences whose (sample, head) slice does not
// fit the one-launch kernel of attention_bwd_short.cu (l > 224 at dh = 64)
// and for head widths other than 64.
//
// Replaces the backward of the library Pallas TPU flash attention that
// workoutdetector_tpu/models/timesformer.py: _flash_mha calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq). As there, two
// kernels and no atomics, so repeated steps are bit-identical; D is a torch
// op outside both, as it is a jnp op outside both pallas_calls there. No
// padding: rows past l are zero-filled in shared memory, P is set to 0
// outside the l x l square (a zero query row would otherwise give
// exp(0 - lse), which is not 0), and rows past l are never stored.
//
// q, k, v, dO and the outputs are (n, h, l, dh) bf16 views with a unit last
// stride and any other strides: TimeSformer passes thirds of its packed qkv
// projection and writes dq, dk and dv into the thirds of one packed gradient,
// which the qkv projection's backward reads as it is.
//
// Bound on the H100 at TimeSformer-B/16's spatial attention (n = 128 frames,
// h = 12, l = 197, dh = 64): bytes. dK/dV reads q, k, v, dO, lse and D and
// writes dk and dv once, 234.8 MB (70.1 us at 3.35 TB/s), against 3.05e10
// FLOP of four products (30.9 us at 989 TFLOP/s); dQ moves 196.1 MB (58.5 us)
// for 2.29e10 FLOP (three products, 23.1 us).
//
// Design (FlashAttention-2's backward, on mma.sync m16n8k16 with fp32
// accumulators). dK/dV: one block of 4 warps per (n, h, 64-key tile); each
// warp owns 16 keys and keeps their dK and dV rows in fp32 registers while
// the query tiles (q, dO, and the tile's lse and D) stream through shared
// memory, double-buffered with cp.async. Each warp computes S^T = K Q^T and
// dP^T = V dO^T directly transposed (keys as rows), so P^T and dS^T come out
// of the accumulators already in the A-operand layout of P^T dO and dS^T Q:
// no transpose through shared memory. dQ: one block per (n, h, 64-query
// tile); each warp keeps its 16 rows of q and dO as A fragments and dQ in
// fp32, while the key tiles (k, v) stream through shared memory. Scores are
// taken 32 columns at a time to bound the registers. P and dS are rounded to
// bf16 once, as the A operand of the next product; dK and dQ are scaled once
// in fp32 and every output is rounded to bf16 once.
#include "attention_common.cuh"

namespace {

using namespace wdattn;

constexpr int QH = 32;  // score columns per inner step (half a 64-row tile)

enum { SQ = 0, SK, SV, SDO, SDQ, SDK, SDV };  // rows of BwdArgs::st

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (N, H, l): log-sum-exp of each query row, natural log
  const float* delta;  // (N, H, l): D = rowsum(dO o O)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int64_t st[7][3];  // (n, h, l) element strides of q, k, v, dO, dq, dk, dv
  int H, l;
  float scale, scale_log2;
};

__device__ __forceinline__ const bf16* slice(const bf16* p,
                                             const int64_t (&s)[3], int nn,
                                             int hh) {
  return p + nn * s[0] + hh * s[1];
}

// rows [r0, r0 + 16) of a (16, DH) fp32 accumulator, times mul, rounded once
// to bf16 into rows r < l of a strided (n, h) slice
template <int DH>
__device__ __forceinline__ void store_rows(bf16* base, int64_t sl,
                                           const float (&acc)[DH / 8][4],
                                           int r0, int l, float mul) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= l) continue;
    bf16* out = base + row * sl + 2 * t4;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + i * 8) =
          pack_bf16(acc[i][2 * r] * mul, acc[i][2 * r + 1] * mul);
  }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
attention_dkv_kernel(const BwdArgs a) {
  constexpr int LD = pitch<DH>();
  constexpr int TILE = tile_elems<DH>();
  constexpr int KD = DH / 16;  // k-steps over the head width
  constexpr int ND = DH / 8;   // n-tiles of a (16, DH) accumulator
  constexpr int NQ = QH / 8;   // n-tiles of a (16, QH) score block
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;      // 2 buffers
  bf16* sO = sQ + 2 * TILE;  // dO, 2 buffers
  float* sL = reinterpret_cast<float*>(sO + 2 * TILE);  // 2 x 64: lse log2 e
  float* sD = sL + 2 * BN;                               // 2 x 64: D

  const int k0 = blockIdx.x * BM;
  const int hh = blockIdx.y, nn = blockIdx.z;
  const int l = a.l;
  const bf16* qb = slice(a.q, a.st[SQ], nn, hh);
  const bf16* kb = slice(a.k, a.st[SK], nn, hh);
  const bf16* vb = slice(a.v, a.st[SV], nn, hh);
  const bf16* ob = slice(a.dout, a.st[SDO], nn, hh);
  const float* lb = a.lse + ((int64_t)nn * a.H + hh) * l;
  const float* db = a.delta + ((int64_t)nn * a.H + hh) * l;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's key rows: +0, +8
  const int nq = (l + BN - 1) / BN;

  // query tile j into buffer b: q and dO rows (cp.async), lse and D (plain
  // loads; the __syncthreads after the cp.async wait publishes them)
  auto stage_queries = [&](int b, int j) {
    stage_rows<DH>(sQ + b * TILE, qb, a.st[SQ][2], j * BN, l);
    stage_rows<DH>(sO + b * TILE, ob, a.st[SDO][2], j * BN, l);
    for (int i = threadIdx.x; i < BN; i += NTHREADS) {
      const int r = j * BN + i;
      sL[b * BN + i] = r < l ? lb[r] * LOG2E : 0.0f;
      sD[b * BN + i] = r < l ? db[r] : 0.0f;
    }
  };
  stage_rows<DH>(sK, kb, a.st[SK][2], k0, l);
  stage_rows<DH>(sV, vb, a.st[SV][2], k0, l);
  stage_queries(0, 0);
  cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[i][c] = dv[i][c] = 0.0f;

  for (int j = 0; j < nq; ++j) {
    if (j + 1 < nq) {
      stage_queries((j + 1) & 1, j + 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile j (and K, V) landed; tile j + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tQ = sQ + (j & 1) * TILE;
    const bf16* tO = sO + (j & 1) * TILE;
    const float* tL = sL + (j & 1) * BN;
    const float* tD = sD + (j & 1) * BN;
#pragma unroll
    for (int h2 = 0; h2 < BN / QH; ++h2) {
      const int c0 = h2 * QH;  // first query of this step within the tile
      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x QH queries
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, a_addr<LD>(sK, warp * 16, kk * 16, lane));
        ldmatrix_x4(va, a_addr<LD>(sV, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, bt_addr<LD>(tQ, c0 + np * 16, kk * 16, lane));
          mma_bf16(s[2 * np], ka, b[0], b[1]);
          mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
          ldmatrix_x4(b, bt_addr<LD>(tO, c0 + np * 16, kk * 16, lane));
          mma_bf16(dp[2 * np], va, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
      // P^T and dS^T = P^T (dP^T - D), zero outside the l x l square
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + i * 8 + 2 * t4 + (c & 1);
          const bool ok = j * BN + col < l && key0 + 8 * (c >> 1) < l;
          const float p = ok ? exp2f(s[i][c] * a.scale_log2 - tL[col]) : 0.0f;
          s[i][c] = p;
          dp[i][c] = p * (dp[i][c] - tD[col]);
        }
      // dV += P^T dO and dK += dS^T Q over these QH queries
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DH / 16; ++dn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, b_addr<LD>(tO, c0 + kk * 16, dn * 16, lane));
          mma_bf16(dv[2 * dn], pa, b[0], b[1]);
          mma_bf16(dv[2 * dn + 1], pa, b[2], b[3]);
          ldmatrix_x4_trans(b, b_addr<LD>(tQ, c0 + kk * 16, dn * 16, lane));
          mma_bf16(dk[2 * dn], da, b[0], b[1]);
          mma_bf16(dk[2 * dn + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // buffer j & 1 is free for tile j + 2
  }

  store_rows<DH>(a.dk + nn * a.st[SDK][0] + hh * a.st[SDK][1], a.st[SDK][2],
                 dk, k0 + warp * 16, l, a.scale);
  store_rows<DH>(a.dv + nn * a.st[SDV][0] + hh * a.st[SDV][1], a.st[SDV][2],
                 dv, k0 + warp * 16, l, 1.0f);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
attention_dq_kernel(const BwdArgs a) {
  constexpr int LD = pitch<DH>();
  constexpr int TILE = tile_elems<DH>();
  constexpr int KD = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int NK = QH / 8;  // n-tiles of a (16, QH) score block
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + TILE;      // dO
  bf16* sK = sO + TILE;      // 2 buffers
  bf16* sV = sK + 2 * TILE;  // 2 buffers

  const int q0 = blockIdx.x * BM;
  const int hh = blockIdx.y, nn = blockIdx.z;
  const int l = a.l;
  const bf16* qb = slice(a.q, a.st[SQ], nn, hh);
  const bf16* kb = slice(a.k, a.st[SK], nn, hh);
  const bf16* vb = slice(a.v, a.st[SV], nn, hh);
  const bf16* ob = slice(a.dout, a.st[SDO], nn, hh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int nt = (l + BN - 1) / BN;

  stage_rows<DH>(sQ, qb, a.st[SQ][2], q0, l);
  stage_rows<DH>(sO, ob, a.st[SDO][2], q0, l);
  stage_rows<DH>(sK, kb, a.st[SK][2], 0, l);
  stage_rows<DH>(sV, vb, a.st[SV][2], 0, l);
  cp_async_commit();

  // this thread's query rows (g and g + 8 of the warp's 16): lse log2 e, D
  int row[2];
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + warp * 16 + g + 8 * r;
    const int64_t at = ((int64_t)nn * a.H + hh) * l + row[r];
    lrow[r] = row[r] < l ? a.lse[at] * LOG2E : 0.0f;
    drow[r] = row[r] < l ? a.delta[at] : 0.0f;
  }

  uint32_t qf[KD][4], of[KD][4];
  float dq[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[i][c] = 0.0f;

  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) {
      const int b = (j + 1) & 1;
      stage_rows<DH>(sK + b * TILE, kb, a.st[SK][2], (j + 1) * BN, l);
      stage_rows<DH>(sV + b * TILE, vb, a.st[SV][2], (j + 1) * BN, l);
      cp_async_commit();
      cp_async_wait<1>();  // tile j (and Q, dO) landed; tile j + 1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_x4(qf[kk], a_addr<LD>(sQ, warp * 16, kk * 16, lane));
        ldmatrix_x4(of[kk], a_addr<LD>(sO, warp * 16, kk * 16, lane));
      }
    }
    const bf16* tK = sK + (j & 1) * TILE;
    const bf16* tV = sV + (j & 1) * TILE;
#pragma unroll
    for (int h2 = 0; h2 < BN / QH; ++h2) {
      const int c0 = h2 * QH;  // first key of this step within the tile
      // S = Q K^T and dP = dO V^T for the warp's 16 rows x QH keys
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, bt_addr<LD>(tK, c0 + np * 16, kk * 16, lane));
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
          ldmatrix_x4(b, bt_addr<LD>(tV, c0 + np * 16, kk * 16, lane));
          mma_bf16(dp[2 * np], of[kk], b[0], b[1]);
          mma_bf16(dp[2 * np + 1], of[kk], b[2], b[3]);
        }
      // dS = P (dP - D), zero outside the l x l square
#pragma unroll
      for (int i = 0; i < NK; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1;
          const bool ok = j * BN + c0 + i * 8 + 2 * t4 + (c & 1) < l &&
                          row[r] < l;
          const float p = ok ? exp2f(s[i][c] * a.scale_log2 - lrow[r]) : 0.0f;
          s[i][c] = p * (dp[i][c] - drow[r]);
        }
      // dQ += dS K over these QH keys
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk) {
        uint32_t da[4];
        acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DH / 16; ++dn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, b_addr<LD>(tK, c0 + kk * 16, dn * 16, lane));
          mma_bf16(dq[2 * dn], da, b[0], b[1]);
          mma_bf16(dq[2 * dn + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // buffer j & 1 is free for tile j + 2
  }

  store_rows<DH>(a.dq + nn * a.st[SDQ][0] + hh * a.st[SDQ][1], a.st[SDQ][2],
                 dq, q0 + warp * 16, l, a.scale);
}

template <int DH, bool DKV>
cudaError_t launch(const BwdArgs& a, int N, cudaStream_t stream) {
  // six 64-row tiles; dK/dV adds the double-buffered lse and D of a tile
  constexpr int SMEM = 6 * tile_elems<DH>() * 2 + (DKV ? 4 * BN * 4 : 0);
  void (*kernel)(const BwdArgs);
  if constexpr (DKV) {
    kernel = attention_dkv_kernel<DH>;
  } else {
    kernel = attention_dq_kernel<DH>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((a.l + BM - 1) / BM), (unsigned)a.H, (unsigned)N);
  kernel<<<grid, NTHREADS, SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <bool DKV>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, void* dk, void* dv,
        const int64_t* strides, int N, int H, int l, int dh, float scale,
        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || H == 0 || l == 0) return 0;
  BwdArgs a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.dout = (const bf16*)dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.H = H;
  a.l = l;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 16: return (int)launch<16, DKV>(a, N, s);
    case 32: return (int)launch<32, DKV>(a, N, s);
    case 48: return (int)launch<48, DKV>(a, N, s);
    case 64: return (int)launch<64, DKV>(a, N, s);
    case 80: return (int)launch<80, DKV>(a, N, s);
    case 96: return (int)launch<96, DKV>(a, N, s);
    case 112: return (int)launch<112, DKV>(a, N, s);
    case 128: return (int)launch<128, DKV>(a, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout: (N, H, l, dh) bf16 with unit last stride; lse, delta:
// contiguous (N, H, l) fp32; strides: the (n, h, l) element strides of q, k,
// v, dout, dq, dk, dv in that order (multiples of 8, 16-byte aligned bases).
// The dK/dV entry writes dk and dv (dq unused), the dQ entry writes dq (dk,
// dv unused). dh in {16, 32, ..., 128}.
extern "C" int wd_attention_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, void* dk, void* dv,
                                     const int64_t* strides, int N, int H,
                                     int l, int dh, float scale, int device,
                                     void* stream) {
  return run<true>(q, k, v, dout, lse, delta, dq, dk, dv, strides, N, H, l,
                   dh, scale, device, stream);
}

extern "C" int wd_attention_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dq, void* dk, void* dv,
                                    const int64_t* strides, int N, int H,
                                    int l, int dh, float scale, int device,
                                    void* stream) {
  return run<false>(q, k, v, dout, lse, delta, dq, dk, dv, strides, N, H, l,
                    dh, scale, device, stream);
}
