// o = softmax(q k^T * scale) v with every key of a (sample, head) slice in
// shared memory: one block per slice, the exact softmax in one pass.
//
// Replaces the library Pallas TPU flash attention that
// workoutdetector_tpu/models/timesformer.py: _flash_mha calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py: flash_attention ->
// _flash_attention_impl), the forward, for head width 64 and l <= 256 (one
// TMA box of at most 256 rows per tensor; TimeSformer-B/16 at 224² has
// l = 197). Longer sequences and other head widths take attention.cu, which
// streams K and V through 64-row tiles with an online softmax. Under
// autograd both write each query row's log-sum-exp, which the backward
// (attention_bwd_short.cu, attention_bwd.cu) reads.
//
// Bound on the H100 at (n, h, l, dh) = (128, 12, 197, 64): bytes. q, k, v
// read once and o written once, 154.9 MB (46.2 us at 3.35 TB/s), lse 1.2 MB;
// two products of 2 l^2 dh, 1.53e10 FLOP (15.4 us at 989 TFLOP/s).
//
// Design. One block of one warpgroup per (n, h) slice: 1536 blocks at the
// shape above. Thread 0 loads the slice's q, k and v by TMA from 4-D tensor
// maps over the strided (n, h, l, dh) views, dims (dh, h, l, n), as the
// backward does: q, k and v are thirds of the packed qkv projection, l is
// the map's extent, so the rows past l come zero-filled and no row is read
// twice. Each tensor takes R rows of 128 bytes, 128-byte swizzled, R the
// first of 64, 128, 208, 256 that holds l (a compile-time instantiation: S's
// registers are indexed at compile time). At l = 197, 3 x 26,624 bytes +
// 1,040, so two blocks share an SM and one block's loads run under the
// other's products. q and k arrive on one mbarrier, v on another, so S
// starts before v has landed.
// The warpgroup walks its slice's queries in 64-row tiles (l = 197: four,
// the last holding 5 real rows; a warp whose 16 rows all lie past l skips
// its loads and element-wise work). Per tile:
//   S = Q K^T on wgmma m64n16k16, A = the tile's Q rows in registers (one
//     ldmatrix per 16-deep step from the swizzled tile, once per tile), B =
//     K (K-major) 16 keys per product, R / 16 products: S (64 x R, fp32)
//     stays in registers, 104 a thread at R = 208;
//   every key is resident, so the softmax is exact in one pass: the row max
//     of the raw scores over all keys (columns past l set to -inf; scale > 0
//     keeps it the max of the scaled ones), p = 2^(s scale log2 e - max
//     scale log2 e) by one FMA and ex2.approx, the row sum in fp32 of the
//     unrounded p; no rescaling of O;
//   O += P V on wgmma m64n64k16: P, packed to bf16, is the register A
//     operand (the accumulator layout of a 16-key chunk is an A fragment), B
//     = V (N-major), 16 keys a product;
//   O divided by the row sum once and rounded to bf16 once, staged in the
//     warp's own Q rows and stored as 16-byte pieces into a contiguous (n,
//     l, h, dh) buffer (the head merge after the kernel is a free view); the
//     row's log-sum-exp in natural log where asked.
// Numerics as attention.cu's: unnormalised probabilities rounded to bf16 as
// A operands, fp32 sums, one division and one rounding per output; no
// atomics, every output has one writer: two runs give the same bits.
#include "attention_common.cuh"
#include "wd_wgmma.cuh"

namespace {

using namespace wdattn;

constexpr int DH = 64;        // head width: one 128-byte row
constexpr int NT = 128;       // one warpgroup

struct FwdArgs {
  bf16* o;     // (N, l, H, 64)
  float* lse;  // (N, H, l) or null
  int H, l;
  float scale_log2;
};

// The rows R of each tile, a compile-time instantiation: l rounded up to
// 64, 128, 208 or 256 (one TMA box has at most 256 rows); 0 beyond.
// R is also the number of key columns of S, 16 per register chunk.
inline int fwd_rows(int l) {
  return l < 1 ? 0 : l <= 64 ? 64 : l <= 128 ? 128 : l <= 208 ? 208 : l <= 256 ? 256 : 0;
}

// Shared memory: q, k, v (R rows of 128 bytes each), two mbarriers; 1024
// bytes of slack to align the tiles.
constexpr int fwd_smem_rows(int R) { return 1024 + 3 * R * 128 + 16; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t off = wd::smem_u32(p) & 1023u;
  return off ? p + (1024 - off) : p;
}

// 2^x, flushing denormals (x = -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__global__ void __launch_bounds__(NT, 2)
attention_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const FwdArgs a) {
  constexpr int NCH = R / 16;  // 16-key chunks of S
  extern __shared__ unsigned char smem_raw[];
  const int l = a.l;
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sK = sQ + R * 128;
  unsigned char* sV = sK + R * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + R * 128);  // [0]: q, k; [1]: v

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nn = blockIdx.x / a.H, hh = blockIdx.x % a.H;
  if (tid == 0) {
    wd::mbar_init(&bar[0], 1);
    wd::mbar_init(&bar[1], 1);
    wd::mbar_fence_init();
    wd::mbar_expect_tx(&bar[0], 2 * R * 128);
    wd::tma_load_4d(sQ, &q_map, &bar[0], 0, hh, 0, nn);
    wd::tma_load_4d(sK, &k_map, &bar[0], 0, hh, 0, nn);
    wd::mbar_expect_tx(&bar[1], R * 128);
    wd::tma_load_4d(sV, &v_map, &bar[1], 0, hh, 0, nn);
  }
  __syncthreads();  // the barriers are initialised
  wd::mbar_wait(&bar[0], 0);

  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row
  const uint64_t vd = wd::sw128_desc(sV, 8192, 1024);
  bool v_ready = false;
#pragma unroll 1
  for (int m0 = 0; m0 < R; m0 += 64) {
    // this warp's 16 query rows (a warp past l reads none)
    const bool live = m0 + 16 * warp < l;
    uint32_t qf[DH / 16][4];
    if (live) {
      const int row = m0 + 16 * warp + (lm & 1) * 8 + lr;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], reinterpret_cast<const bf16*>(
                                sQ + row * 128 + (((2 * kk + (lm >> 1)) ^ (row & 7)) << 4)));
    } else {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        qf[kk][0] = qf[kk][1] = qf[kk][2] = qf[kk][3] = 0u;
    }

    // S = Q K^T, 16 keys a chunk: chunk c holds keys 16 c + 8 (i / 4) +
    // 2 t4 + (i % 2) of rows g (i % 4 < 2) and g + 8
    float s[NCH][8];
    wd::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const uint64_t kd = wd::sw128_desc(sK + c * 2048, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wd::wgmma_ra_n16<0>(s[c], qf[kk], wd::desc_add(kd, 32 * kk), kk);
    }
    wd::wgmma_commit();
    wd::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCH; ++c) wd::acc_fence(s[c]);

    // exact softmax over all keys, base 2; P packed to bf16 A fragments
    uint32_t pa[NCH][4];
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
    if (live) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int key = 16 * c + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (key >= l) s[c][i] = -INFINITY;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[c][i]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the 4 threads of a row group share its rows
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        mx[h] *= a.scale_log2;  // the row max of s scale log2 e (scale > 0)
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          p[i] = ex2(fmaf(s[c][i], a.scale_log2, -mx[(i >> 1) & 1]));  // masked: 0
          sum[(i >> 1) & 1] += p[i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[c][j] = pack_bf16(p[2 * j], p[2 * j + 1]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NCH; ++c) pa[c][0] = pa[c][1] = pa[c][2] = pa[c][3] = 0u;
    }

    // O = P V, 16 keys a product
    if (!v_ready) {
      wd::mbar_wait(&bar[1], 0);
      v_ready = true;
    }
    float o[32];
    wd::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      wd::wgmma_ra_n64<1>(o, pa[c], wd::desc_add(vd, 2048 * c), c);
    wd::wgmma_commit();
    wd::wgmma_wait<0>();
    wd::acc_fence(o);

    if (!live) continue;
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      inv[h] = 1.0f / sum[h];
      const int row = m0 + 16 * warp + g + 8 * h;
      // ln sum exp(s scale) = ln 2 (max + log2 sum), max and sum in base 2
      if (a.lse != nullptr && t4 == 0 && row < l)
        a.lse[((int64_t)nn * a.H + hh) * l + row] = (mx[h] + log2f(sum[h])) * LN2;
    }
    // O in bf16 through the warp's own 16 query rows of sQ (in registers
    // since S; a live warp's rows lie below l <= R), swizzled, then out as
    // 16-byte pieces: a row's 64 values are one 128-byte line of the (n, l,
    // h, dh) buffer
    unsigned char* stage = sQ + (m0 + 16 * warp) * 128;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = g + 8 * ((i >> 1) & 1), c = wd::frag_col(tid, i);
      *reinterpret_cast<uint32_t*>(stage + r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
                                   (c & 7) * 2) =
          pack_bf16(o[i] * inv[(i >> 1) & 1], o[i + 1] * inv[(i >> 1) & 1]);
    }
    __syncwarp();
#pragma unroll
    for (int v = lane; v < 16 * 8; v += 32) {
      const int r = v >> 3, j = v & 7, row = m0 + 16 * warp + r;
      if (row < l)
        *reinterpret_cast<uint4*>(a.o + (((int64_t)nn * l + row) * a.H + hh) * DH + 8 * j) =
            *reinterpret_cast<const uint4*>(stage + r * 128 + ((j ^ (r & 7)) << 4));
    }
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

template <int R>
int launch(const void* const (&in)[3], const int64_t* strides, const FwdArgs& a,
           int N, cudaStream_t stream) {
  CUtensorMap maps[3];
  for (int t = 0; t < 3; ++t)
    if (!slice_map(&maps[t], in[t], strides + 3 * t, N, a.H, a.l, R))
      return (int)cudaErrorInvalidValue;
  constexpr int smem = fwd_smem_rows(R);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<R><<<(unsigned)(N * a.H), NT, smem, stream>>>(
      maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory the kernel takes for (l, dh = 64), or 0
// where it does not take l (l < 1 or l > 256): the route's rule, which the
// wrapper (attention.py: fwd_route, fwd_smem) follows.
extern "C" int wd_attention_fwd_smem(int l) {
  const int R = fwd_rows(l);
  return R ? fwd_smem_rows(R) : 0;
}

// q, k, v: (N, H, l, 64) bf16 views with unit last stride; strides = the
// (n, h, l) element strides of q, then k, then v (multiples of 8, 16-byte
// aligned bases). o: contiguous (N, l, H, 64) bf16. lse: null, or a
// contiguous (N, H, l) fp32 buffer for the rows' log-sum-exp (natural log).
// dh = 64, 1 <= l <= 256 and scale > 0 (else cudaErrorInvalidValue).
extern "C" int wd_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                     void* o, float* lse, const int64_t* strides,
                                     int N, int H, int l, int dh, float scale,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || H == 0) return 0;
  const int R = fwd_rows(l);
  if (dh != DH || R == 0 || !(scale > 0.0f) || (int64_t)N * H > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{(bf16*)o, lse, H, l, scale * LOG2E};
  const void* const in[3] = {q, k, v};
  cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
    case 64: return launch<64>(in, strides, a, N, s);
    case 128: return launch<128>(in, strides, a, N, s);
    case 208: return launch<208>(in, strides, a, N, s);
    default: return launch<256>(in, strides, a, N, s);
  }
}
