// Backward of o = softmax(q k^T * scale) v in one kernel: one block per
// (sample, head) slice holds that slice's q, k, v, dO and o in shared memory
// and computes D = rowsum(dO o O), dQ, dK and dV in one pass. With
// P = exp(q k^T scale - lse) (the forward kernel's log-sum-exp per query row)
// and dS = P o (dO v^T - D), the gradient of the scaled scores,
//   dV = P^T dO,   dK = scale dS^T q,   dQ = scale dS k.
//
// Replaces the backward of the library Pallas TPU flash attention that
// workoutdetector_tpu/models/timesformer.py: _flash_mha calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv :941 and _flash_attention_bwd_dq :1287), and the
// jnp op that forms D outside them, for every sequence short enough that one
// slice fits a block's shared memory (below). Longer ones go to the tiled
// dK/dV and dQ kernels of attention_bwd.cu, with D formed beside them.
//
// Bound on the H100 at TimeSformer-B/16's spatial attention (n = 128 frames,
// h = 12, l = 197, dh = 64): bytes. q, k, v, dO and o read once, dq, dk and dv
// written once (8 x 38.73 MB) and lse read once (1.21 MB): 311.1 MB, 92.9 us
// at 3.35 TB/s. Five products of 2 l^2 dh (S, dP, dV, dK, dQ): 3.82e10 FLOP,
// 38.6 us at 989 TFLOP/s.
//
// Shared memory, and the route's limit (dh = 64, 128-byte rows). q, k, v and
// dO take R = l rounded up to 16 rows each; dS^T in bf16 one R-row tile per
// 64 queries, over o's rows (o is read for D before dS is written); lse log2
// e and D 8 R bytes. Plus 1024 bytes to align the tiles and two mbarriers.
// At l = 197 (R = 208): 4 x 26,624 (q, k, v, dO) + 4 x 26,624 (dS^T) + 1,664
// + 1,040 = 215,696 bytes. A block may use 232,448, so l <= 224 (and a TMA
// box of at most 224 rows, within its 256). short_smem() below and
// attention.py:short_smem() compute the same sum: the wrapper sends a shape
// here where it fits and routes longer sequences to the tiled kernels.
//
// Design. One block of two warpgroups per (n, h): 1536 blocks at the shape
// above, one block per SM (11.6 waves).
// Loads: thread 0 issues one TMA copy per tensor from 4-D tensor maps over
// the strided (n, h, l, dh) views, dims (dh, h, l, n): l is the map's own
// extent, so TMA's out-of-bounds fill zeroes the rows past l and no row is
// read twice. q, k and v are thirds of the packed qkv projection (row stride
// 3 h dh). The tiles land 128-byte swizzled (16-byte chunk j of row r at
// j ^ (r % 8)): wgmma's canonical layout, and free of bank conflicts for
// the 16-byte reads that form D. dO and o arrive on one mbarrier, q, k and v on another: D =
// rowsum(dO o O) is formed in fp32 from the two tiles while q, k and v are in
// flight. No fp32 copy of anything goes to device memory.
// Phase 1, keys as rows, on wgmma: each warpgroup owns 64-key M tiles (l =
// 197 takes 4, padding the keys to 256: a warp whose 16 keys all lie past l
// skips the element-wise work, and the rows past R that its tile reads, the
// next tile's, are never used) and sweeps the queries 32 at a time (a last
// step of 16). S^T = K Q^T and dP^T = V dO^T read K, V, Q and dO from shared
// memory (K-major); P^T and dS^T = P^T (dP^T - D) are formed in the
// accumulators (columns past l masked by lse = +inf) and packed to bf16 as
// register A operands of dV += P^T dO and dK += dS^T Q (B N-major), which run
// while the next step's S^T and dP^T are issued. dK and dV stay in fp32
// registers through the sweep. Each step also writes dS^T (the bf16 value dK
// used) to shared memory by stmatrix, two 16 x 16 tiles a step, swizzled as a
// wgmma operand. Phase 2, queries as rows, on wgmma: dQ = scale dS K (A = dS
// from the dS^T tiles, M-major; B = K, N-major), five products in all.
// Keeping dS rather than recomputing S and dP for dQ (seven products, o's
// tile only): at l = 197 the recomputing variant still ran one block per SM
// and took 0.30 against 0.24 ms a launch on the H100. wgmma rather than
// mma.sync for phase 1, though its 64-row tiles pad l = 197 to 256 (1.30x)
// where mma.sync's 16-row tiles pad it to 208: a first version with phase 1
// on mma.sync ran 0.44 ms a launch at l = 197 on the H100, this one 0.24.
// Numerics as attention_bwd.cu's: P = exp2(s scale log2 e - lse log2 e), set
// to 0 outside the l x l square; P and dS rounded to bf16 once, as A operands;
// scale applied once in fp32; each output rounded to bf16 once. No atomics:
// every output element has one writer, so two runs are bit-identical.
#include "attention_common.cuh"
#include "wd_wgmma.cuh"

namespace {

using namespace wdattn;

constexpr int DH = 64;            // head width: one 128-byte row
constexpr int NW = 8;             // warps: two warpgroups
constexpr int NT = NW * 32;
constexpr int STEP = 32;          // queries a phase-1 step (R % 32 is 0 or 16)
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

enum { SDQ = 0, SDK, SDV };  // rows of ShortArgs::st

struct ShortArgs {
  const float* lse;  // (N, H, l): log-sum-exp of each query row, natural log
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int64_t st[3][3];  // (n, h, l) element strides of dq, dk, dv
  int H, l;
  int R;   // l rounded up to 16: the rows of every tile
  int RK;  // l rounded up to 64: the keys phase 1 sweeps in 64-row tiles
  float scale, scale_log2;
};

// Bytes of the region that holds o's R rows, then dS^T: one R-row tile of
// 128-byte rows per 64 queries.
__host__ __device__ inline int64_t ds_region(int64_t R) {
  return (R + 63) / 64 * R * 128;
}

// Shared memory: k, v, q, dO (R rows each), the o / dS^T region, lse log2 e
// and D (R floats), two mbarriers; 1024 bytes of slack to align the tiles.
__host__ __device__ inline int64_t short_smem(int l) {
  const int64_t R = (l + 15) / 16 * 16;
  return 1024 + 4 * R * 128 + ds_region(R) + 2 * R * 4 + 16;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t off = wd::smem_u32(p) & 1023u;
  return off ? p + (1024 - off) : p;
}

// Element (r, c) of a swizzled tile of 128-byte rows (c a multiple of 8):
// 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ const bf16* sw(const unsigned char* tile, int r, int c) {
  return reinterpret_cast<const bf16*>(tile + r * 128 + (((c >> 3) ^ (r & 7)) << 4));
}

// four 8 x 8 bf16 matrices from mma fragments (r[i]: matrix i) to shared
// memory, lane L giving the address of row L % 8 of matrix L / 8
__device__ __forceinline__ void stmatrix_x4(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(wd::smem_u32(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// 2^x, flushing denormals (x = -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

struct Tiles {
  const unsigned char *q, *k, *v, *dout;
  const float *L, *D;  // per query row: lse log2 e (+inf past l) and D
  unsigned char* ds;   // dS^T: per 64 queries an R-row tile
};

// One step of a warpgroup's phase-1 sweep: queries [c0, c0 + N) against its
// keys [k0, k0 + 64). t: the thread's index in its warpgroup; live: its
// warp's 16 keys reach below l; kin: its two key rows (g, g + 8) are < l.
template <int N>
__device__ __forceinline__ void sweep_step(const Tiles& s, const ShortArgs& a,
                                           int k0, int c0, int t, bool live,
                                           const bool (&kin)[2],
                                           float (&dk)[32], float (&dv)[32]) {
  float sc[N / 2], dp[N / 2];
  const uint64_t ka = wd::sw128_desc(s.k + k0 * 128, 16, 1024);
  const uint64_t va = wd::sw128_desc(s.v + k0 * 128, 16, 1024);
  const uint64_t qb = wd::sw128_desc(s.q + c0 * 128, 16, 1024);
  const uint64_t ob = wd::sw128_desc(s.dout + c0 * 128, 16, 1024);
  wd::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wd::wgmma<N, 0, 0>(sc, wd::desc_add(ka, 32 * kk), wd::desc_add(qb, 32 * kk), kk);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wd::wgmma<N, 0, 0>(dp, wd::desc_add(va, 32 * kk), wd::desc_add(ob, 32 * kk), kk);
  wd::wgmma_commit();
  wd::wgmma_wait<0>();  // these, and the previous step's dV and dK
  wd::acc_fence(sc);
  wd::acc_fence(dp);

  // P^T and dS^T = P^T (dP^T - D), zero outside the l x l square (columns
  // past l through lse = +inf, keys past l through kin). Registers 4 j + 2 h
  // and + 1 hold key row g + 8 h, queries c0 + 8 j + 2 (t % 4) and + 1.
  if (live) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = c0 + 8 * j + 2 * (t & 3);
      const float2 L = *reinterpret_cast<const float2*>(s.L + col);
      const float2 D = *reinterpret_cast<const float2*>(s.D + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        const float p0 = kin[h] ? ex2(fmaf(sc[i], a.scale_log2, -L.x)) : 0.0f;
        const float p1 = kin[h] ? ex2(fmaf(sc[i + 1], a.scale_log2, -L.y)) : 0.0f;
        sc[i] = p0;
        sc[i + 1] = p1;
        dp[i] = p0 * (dp[i] - D.x);
        dp[i + 1] = p1 * (dp[i + 1] - D.y);
      }
    }
  } else {  // every key of this warp is past l
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sc[i] = dp[i] = 0.0f;
  }
  // the A operands of dV += P^T dO and dK += dS^T Q: 16 queries a k-step
  uint32_t pa[N / 16][4], da[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      da[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
    }
  if (live) {
    // dS^T (the bf16 dK uses) into the tile of the 64 queries that hold c0,
    // rows = keys, swizzled (query chunk j of key row r at chunk j ^ (r %
    // 8)): each 16 x 16 A fragment by one stmatrix, lane L giving the
    // address of row L % 8 of 8 x 8 matrix L / 8 (rows + 8 (m % 2),
    // queries + 8 (m / 2))
    const int lane = t & 31, m = lane >> 3, row = k0 + 16 * (t >> 5) + (m & 1) * 8 + (lane & 7);
    unsigned char* tile = s.ds + (c0 / 64) * a.R * 128 + row * 128;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      stmatrix_x4(tile + ((((c0 % 64) / 8 + 2 * kk + (m >> 1)) ^ (lane & 7)) << 4), da[kk]);
  }
  // B (dO, Q) N-major: 16 rows (2048 bytes) a k-step
  const uint64_t ot = wd::sw128_desc(s.dout + c0 * 128, 8192, 1024);
  const uint64_t qt = wd::sw128_desc(s.q + c0 * 128, 8192, 1024);
  wd::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    wd::wgmma_ra_n64<1>(dv, pa[kk], wd::desc_add(ot, 2048 * kk), 1);
    wd::wgmma_ra_n64<1>(dk, da[kk], wd::desc_add(qt, 2048 * kk), 1);
  }
  wd::wgmma_commit();
}

// rows [k0, k0 + 64) of a warpgroup's m64n64 accumulator, times mul, rounded
// once to bf16 into rows r < l of a strided (n, h) slice
__device__ __forceinline__ void store_tile(bf16* base, int64_t sl,
                                           const float (&acc)[32], int k0, int t,
                                           int l, float mul) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = k0 + wd::frag_row(t, i);
    if (row < l)
      *reinterpret_cast<uint32_t*>(base + row * sl + wd::frag_col(t, i)) =
          pack_bf16(acc[i] * mul, acc[i + 1] * mul);
  }
}

__global__ void __launch_bounds__(NT, 1)
attention_bwd_short_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap o_map,
                           const ShortArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int R = a.R, l = a.l;
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + R * 128;
  unsigned char* sQ = sV + R * 128;
  unsigned char* sO = sQ + R * 128;                    // dO
  unsigned char* sX = sO + R * 128;                    // o, then dS^T
  float* sL = reinterpret_cast<float*>(sX + ds_region(R));
  float* sD = sL + R;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sD + R);  // [0]: dO, o; [1]: q, k, v

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nn = blockIdx.x / a.H, hh = blockIdx.x % a.H;
  if (tid == 0) {
    wd::mbar_init(&bar[0], 1);
    wd::mbar_init(&bar[1], 1);
    wd::mbar_fence_init();
    wd::mbar_expect_tx(&bar[0], 2 * R * 128);
    wd::tma_load_4d(sO, &do_map, &bar[0], 0, hh, 0, nn);
    wd::tma_load_4d(sX, &o_map, &bar[0], 0, hh, 0, nn);
    wd::mbar_expect_tx(&bar[1], 3 * R * 128);
    wd::tma_load_4d(sK, &k_map, &bar[1], 0, hh, 0, nn);
    wd::tma_load_4d(sQ, &q_map, &bar[1], 0, hh, 0, nn);
    wd::tma_load_4d(sV, &v_map, &bar[1], 0, hh, 0, nn);
  }
  const float* lb = a.lse + ((int64_t)nn * a.H + hh) * l;
  for (int i = tid; i < R; i += NT) sL[i] = i < l ? lb[i] * LOG2E : INFINITY;
  __syncthreads();  // the barriers are initialised

  // D = rowsum(dO o O) from the two tiles (zero past l); 8 neighbouring
  // lanes share a row
  wd::mbar_wait(&bar[0], 0);
  for (int v0 = warp * 32; v0 < R * 8; v0 += NT) {
    const int v = v0 + lane, r = v / 8, c = (v % 8) * 8;
    float d = dot8(*reinterpret_cast<const uint4*>(sw(sX, r, c)),
                   *reinterpret_cast<const uint4*>(sw(sO, r, c)));
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (v % 8 == 0) sD[r] = d;
  }
  __syncthreads();  // D is in shared memory, o's tile is free for dS^T
  wd::mbar_wait(&bar[1], 0);

  const Tiles s{sQ, sK, sV, sO, sL, sD, sX};
  const int wg = warp / 4, t = tid % 128;
  // phase 1, keys as rows: dK and dV (and dS^T), 64 keys a warpgroup tile.
  // A tile past R reads the next tile's rows as keys: those warps are not
  // live, so their P and dS are 0 and nothing of theirs is stored.
  for (int k0 = wg * 64; k0 < a.RK; k0 += 128) {
    const int key0 = k0 + 16 * (warp % 4) + lane / 4;
    const bool live = k0 + 16 * (warp % 4) < l;
    const bool kin[2] = {key0 < l, key0 + 8 < l};
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
    int c0 = 0;
    for (; c0 + STEP <= R; c0 += STEP)
      sweep_step<STEP>(s, a, k0, c0, t, live, kin, dk, dv);
    if (c0 < R) sweep_step<16>(s, a, k0, c0, t, live, kin, dk, dv);
    wd::wgmma_wait<0>();
    wd::acc_fence(dk);
    wd::acc_fence(dv);
    store_tile(a.dk + nn * a.st[SDK][0] + hh * a.st[SDK][1], a.st[SDK][2], dk,
               k0, t, l, a.scale);
    store_tile(a.dv + nn * a.st[SDV][0] + hh * a.st[SDV][1], a.st[SDV][2], dv,
               k0, t, l, 1.0f);
  }

  // phase 2 on wgmma, 64 queries a warpgroup tile: dQ = scale dS K, A = dS
  // from the dS^T tiles (M-major), B = K (N-major), 16 keys a k-step. Rows
  // past R of the last tile hold no dS; their dQ rows are not stored.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // every dS^T row is written and visible to wgmma
  for (int q0 = wg * 64; q0 < R; q0 += 128) {
    float dq[32];
    const uint64_t da = wd::sw128_desc(sX + (q0 / 64) * R * 128, 8192, 1024);
    const uint64_t db = wd::sw128_desc(sK, 8192, 1024);
    wd::wgmma_fence();
    for (int j = 0; j < R / 16; ++j)
      wd::wgmma<64, 1, 1>(dq, wd::desc_add(da, 2048 * j), wd::desc_add(db, 2048 * j), j);
    wd::wgmma_commit();
    wd::wgmma_wait<0>();
    wd::acc_fence(dq);
    store_tile(a.dq + nn * a.st[SDQ][0] + hh * a.st[SDQ][1], a.st[SDQ][2], dq,
               q0, t, l, a.scale);
  }
}

// a 4-D map (dh, h, l, n) of a strided (n, h, l, dh) bf16 view: one box of
// `rows` rows of one (n, h) slice
bool slice_map(CUtensorMap* map, const void* base, const int64_t* st, int N,
               int H, int l, int rows) {
  const uint64_t dims[4] = {(uint64_t)DH, (uint64_t)H, (uint64_t)l, (uint64_t)N};
  const uint64_t strides[3] = {(uint64_t)st[1] * 2, (uint64_t)st[2] * 2,
                               (uint64_t)st[0] * 2};
  const uint32_t box[4] = {DH, 1, (uint32_t)rows, 1};
  return wd::make_map(map, base, 4, dims, strides, box);
}

int launch(const void* const (&in)[5], const int64_t* strides, const ShortArgs& a,
           int N, cudaStream_t stream) {
  const int64_t smem = short_smem(a.l);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5];  // q, k, v, dO, o
  for (int t = 0; t < 5; ++t)
    if (!slice_map(&maps[t], in[t], strides + 3 * t, N, a.H, a.l, a.R))
      return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_short_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_short_kernel<<<(unsigned)(N * a.H), NT, (size_t)smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory the kernel takes for (l, dh = 64), the
// route's rule: the wrapper sends a shape here only where this is <= 232,448.
extern "C" int wd_attention_bwd_smem(int l) {
  const int64_t smem = short_smem(l);
  return smem > INT32_MAX ? INT32_MAX : (int)smem;
}

// q, k, v, dout, o: (N, H, l, 64) bf16 views with unit last stride; lse:
// contiguous (N, H, l) fp32; dq, dk, dv: outputs of the same shape; strides:
// the (n, h, l) element strides of q, k, v, dout, o, dq, dk, dv in that order
// (multiples of 8, 16-byte aligned bases). l with short_smem(l) <= 232,448
// (else cudaErrorInvalidValue).
extern "C" int wd_attention_bwd_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* o, const float* lse,
                                     void* dq, void* dk, void* dv,
                                     const int64_t* strides, int N, int H,
                                     int l, int dh, float scale, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || H == 0 || l == 0) return 0;
  if (dh != DH || (int64_t)N * H > INT32_MAX) return (int)cudaErrorInvalidValue;
  ShortArgs a;
  a.lse = lse;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * (5 + i) + j];
  a.H = H;
  a.l = l;
  a.R = (l + 15) / 16 * 16;
  a.RK = (l + 63) / 64 * 64;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  const void* const in[5] = {q, k, v, dout, o};
  return launch(in, strides, a, N, (cudaStream_t)stream);
}
