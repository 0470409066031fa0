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
// Bound on the H100. Bytes count g, x (or W) read once and dx (or dW)
// written once. At the TSM-R50 224² sites of a batch-32 train step the
// arithmetic intensity runs from 32 FLOP/byte (layer1, C = O = 64) to ~400
// (layer4, 2048 x 512). Layers 1-2 (C·O < 131072) sit far under the card's
// ~295 FLOP/byte bf16 ridge: bytes bind, and at K = 64 a tile has one K
// step, so only other tiles' loads can hide a tile's latency. Layers 3-4
// sit near or past the ridge: the tensor cores must be fed.
//
// Both kernels are built from wd_wgmma.cuh: a persistent grid of one block
// per SM; one producer thread issuing TMA tile loads (128-byte swizzled,
// zero fill out of bounds) into a ring of stages guarded by full/empty
// mbarrier pairs; consumer warpgroups issuing wgmma (M = 64 per warpgroup,
// N up to 256) with K steps of 64 per stage. The producer runs up to a
// ring ahead, into the next tiles, while the consumers store this one.
//
// The shift rides on the loads in both kernels. Its zeros are where a
// shifted row leaves its clip; the stores stay contiguous. (Applying S^T
// to dx's stores instead, each fold segment sent to row j +- HW, ran
// markedly slower than the unshifted product at the C = 256 sites on the
// H100, and the cost followed the scattered rows, not the arithmetic.)
//
// dx: A = g (rows x O) and B = W (C x O) are both K-major as they lie (no
// W^T copy). Each warpgroup owns whole 64 x BN tiles and the two take turns
// (ping-pong: one's epilogue overlaps the other's K loop; an mbarrier pair
// orders their turns so a warpgroup that skips the other's stages never
// waits on a stage barrier two phases ahead). S^T takes dsh row j - HW for
// the first fold's columns and row j + HW for the second's, so a tile
// loads g at rows m0 - HW, m0 + HW and m0 for its column regions and runs
// one wgmma per region into that region's accumulator columns. Columns are
// compile-time in registers, so a tile may hold several regions only as
// the first tile with fold = F, 2 F <= BN (F a template argument: folds of
// 8 and 16 at C = 64, 16-64 at BN = 128, 32-64 at BN = 256); every other
// tile is one region. Rows S^T leaves empty (t = 0 in the first fold,
// t = T-1 in the second) are zeroed as the accumulators are rounded to
// bf16 once into a padded shared tile, which leaves as 16-byte row segments.
// BN = 256 (whole rows at C = 256) only where a tile is one K step.
//
// dW: the output tile is C (M side, 64 per consumer warpgroup) by O (N
// side); K is the rows. x and g tiles are row-major (rows x 64 channels),
// so A and B are M- and N-major, read by wgmma's transpose bits: no
// transposed copy. x and g are seen as 3-D (channels, T*HW, clips) maps and
// K is cut into 64-row chunks inside a clip. shift(x)'s first fold reads x
// at row + HW, so dW's first-fold rows are sum_r x[r] g[r - HW]; the second
// fold's sum x[r] g[r + HW]. So x's boxes load unshifted, whole 128-byte
// rows, and g loads once per region a C tile meets, at row p - HW, p + HW
// or p: TMA's zero fill past the clip's ends is exactly where S puts zeros.
// A warpgroup whose 64 C rows meet several regions (folds of 8 and 32 at
// C = 64 and 256) keeps an accumulator per region and takes each row's sum
// from its region's. (Shifting x instead, through a map per fold region
// with boxes zero-filled outside it, ran slower at C = 64 and 256, where
// boxes straddle the fold boundaries.)
// K is dealt round-robin in 64-row chunks to S splits so that tiles x S
// fill the SMs (layer1 has a single 64 x 64 tile over 802,816 rows) and all
// splits sweep the rows together, which keeps g's shifted rows in L2; each
// (tile, split) writes its fp32 partial to a workspace (S, C, O) and
// dw_reduce_kernel sums the S partials in split order. No atomics: the
// same bits on every run.
#include "wd_wgmma.cuh"

namespace {

using namespace wd;
using bf16 = __nv_bfloat16;

constexpr int WG = 128;           // threads of a warpgroup
constexpr int PRODUCER = 32;      // one warp; its first thread issues loads
constexpr int SMEM_MAX = 227 * 1024;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t off = smem_u32(p) & 1023u;
  return off ? p + (1024 - off) : p;
}

// ---------------------------------------------------------------- dx

// BN output columns per tile. F = 0: every tile lies in one channel region
// (no shift, or folds that are whole tiles). F > 0: fold = F with 2 F <= BN,
// so the first tile holds [0, F), [F, 2 F) and [2 F, BN) and the others lie
// in the last region.
template <int BN, int F>
struct DxCfg {
  static_assert(F % 8 == 0 && 2 * F <= BN, "dx tile layout");
  static constexpr int BM = 64;                  // rows of one warpgroup's tile
  static constexpr int A_BYTES = BM * ROW_BYTES;  // g box (64 x 64)
  static constexpr int NA = F ? (2 * F < BN ? 3 : 2) : 1;  // g boxes per stage
  static constexpr int B_BYTES = BN * ROW_BYTES;  // W box (64 x BN)
  static constexpr int STAGE = NA * A_BYTES + B_BYTES;
  static constexpr int PITCH = BN * 2 + 16;       // staged output row, bytes
  static constexpr int OUT_BYTES = BM * PITCH;    // per warpgroup
  static constexpr int FREE = SMEM_MAX - 1024 - 2 * OUT_BYTES - 256;
  static constexpr int STAGES = FREE / STAGE > 8 ? 8 : FREE / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * OUT_BYTES + (2 * STAGES + 2) * 8;
  static_assert(STAGES >= 2 && SMEM <= SMEM_MAX, "dx shared memory");
};

struct DxArgs {
  bf16* dx;
  int64_t M;
  int O, HW, T;
  Regions reg;
  int n_tiles, tiles;
};

// S^T's rows: dx row j takes dsh row j - HW in the first fold (zero at the
// clip's t = 0) and row j + HW in the second (zero at t = T-1)
__device__ __forceinline__ int dx_shift(const DxArgs& p, int r) {
  return r == 0 ? -p.HW : r == 1 ? p.HW : 0;
}

// First column of a tile. A block's tiles are gridDim apart, so with the
// SM count a multiple of the column tiles a plain order would give some
// blocks only first-column tiles, whose fold loads and MMAs would then set
// the kernel's time. The column tiles of each row block are rotated by a
// step that turns once per gridDim tiles, so a block's tiles cycle through
// the columns while each row block still covers every column once.
template <int BN>
__device__ __forceinline__ int dx_col0(const DxArgs& p, int tile) {
  const int turn = (tile / p.n_tiles) / max(1, (int)gridDim.x / p.n_tiles);
  return (tile + turn) % p.n_tiles * BN;
}

template <int BN, int F>
__global__ void __launch_bounds__(2 * WG + PRODUCER, 1)
conv1x1_dx_kernel(const __grid_constant__ CUtensorMap g_map,
                  const __grid_constant__ CUtensorMap w_map, const DxArgs p) {
  using Cfg = DxCfg<BN, F>;
  constexpr int TAIL = BN - 2 * F;  // columns of the last region in tile 0
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* out = ring + Cfg::STAGES * Cfg::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 2 * Cfg::OUT_BYTES);
  uint64_t* empty = full + Cfg::STAGES;
  uint64_t* order = empty + Cfg::STAGES;  // order[w]: warpgroup w's turn
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < Cfg::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init(&order[0], 1);
    mbar_init(&order[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int k_steps = (p.O + TILE_K - 1) / TILE_K;

  if (tid >= 2 * WG) {  // producer: every tile of this block, in order
    if (tid == 2 * WG) {
      tma_prefetch_map(&g_map);
      tma_prefetch_map(&w_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.n_tiles) * Cfg::BM, n0 = dx_col0<BN>(p, tile);
        const bool mixed = F && n0 == 0;
        const int n_a = mixed ? (TAIL ? 3 : 2) : 1;
        for (int kb = 0; kb < k_steps; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * Cfg::STAGE;
          mbar_expect_tx(&full[stage], n_a * Cfg::A_BYTES + Cfg::B_BYTES);
          if (mixed) {  // g rows for each region of the tile
            for (int r = 0; r < n_a; ++r)
              tma_load_2d(st + r * Cfg::A_BYTES, &g_map, &full[stage], kb * TILE_K,
                          m0 + dx_shift(p, r));
          } else {
            tma_load_2d(st, &g_map, &full[stage], kb * TILE_K,
                        m0 + dx_shift(p, p.reg.of(n0)));
          }
          tma_load_2d(st + Cfg::NA * Cfg::A_BYTES, &w_map, &full[stage],
                      kb * TILE_K, n0);
          if (++stage == Cfg::STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers: the two warpgroups take turns, tile by tile, so one's
  // epilogue overlaps the other's MMA; each skips the other's stages. The
  // turns are ordered (warpgroup 1's j-th K loop after warpgroup 0's j-th,
  // warpgroup 0's after warpgroup 1's (j-1)-th): a warpgroup never waits on
  // a stage the other has not yet passed, so a stage's barrier is never
  // more than one phase behind its waiter.
  const int wg = tid / WG, t = tid % WG;
  unsigned char* mine = out + wg * Cfg::OUT_BYTES;
  float acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  int turn = 0, own = 0;  // own: this warpgroup's tiles so far
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, turn ^= 1) {
    if (turn != wg) {
      for (int kb = 0; kb < k_steps; ++kb)
        if (++stage == Cfg::STAGES) { stage = 0; phase ^= 1; }
      continue;
    }
    if (wg == 1)
      mbar_wait(&order[1], own & 1);
    else if (own > 0)
      mbar_wait(&order[0], (own - 1) & 1);
    ++own;
    const int64_t m0 = (int64_t)(tile / p.n_tiles) * Cfg::BM;
    const int n0 = dx_col0<BN>(p, tile);
    const bool mixed = F && n0 == 0;
    int held = -1;  // the stage the MMA in flight still reads
    for (int kb = 0; kb < k_steps; ++kb) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = ring + stage * Cfg::STAGE;
      const uint64_t da = sw128_desc(st, 16, 1024);
      const uint64_t db = sw128_desc(st + Cfg::NA * Cfg::A_BYTES, 16, 1024);
      wgmma_fence();
      if constexpr (F > 0) {
        if (mixed) {  // each region's columns from its own g rows
          const uint64_t da1 = desc_add(da, Cfg::A_BYTES);
          const uint64_t da2 = desc_add(da, 2 * Cfg::A_BYTES);
          const uint64_t db1 = desc_add(db, F * ROW_BYTES);
          const uint64_t db2 = desc_add(db, 2 * F * ROW_BYTES);
#pragma unroll
          for (int k = 0; k < TILE_K / 16; ++k) {
            const int sc = kb > 0 || k > 0;
            wgmma<F, 0, 0>(acc_cols<0, F>(acc), desc_add(da, 32 * k),
                           desc_add(db, 32 * k), sc);
            wgmma<F, 0, 0>(acc_cols<F, F>(acc), desc_add(da1, 32 * k),
                           desc_add(db1, 32 * k), sc);
            if constexpr (TAIL > 0)
              wgmma<TAIL, 0, 0>(acc_cols<2 * F, TAIL>(acc), desc_add(da2, 32 * k),
                                desc_add(db2, 32 * k), sc);
          }
        }
      }
      if (!mixed) {
#pragma unroll
        for (int k = 0; k < TILE_K / 16; ++k)
          wgmma<BN, 0, 0>(acc, desc_add(da, 32 * k), desc_add(db, 32 * k),
                          kb > 0 || k > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one has been read
      if (held >= 0 && t == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == Cfg::STAGES) { stage = 0; phase ^= 1; }
    }
    if (t == 0) mbar_arrive(&order[wg ^ 1]);  // the other's turn
    wgmma_wait<0>();
    acc_fence(acc);
    if (held >= 0 && t == 0) mbar_arrive(&empty[held]);

    // S^T's zeros: the first fold's columns of a clip's t = 0 rows and the
    // second fold's of its t = T-1 rows, which no dsh row reaches. Only a
    // tile with fold columns needs the frame times of this thread's two
    // fragment rows (32-bit: the host refuses M >= 2^31).
    const int tile_region = p.reg.of(n0);
    bool z0[2] = {false, false}, z1[2] = {false, false};  // [lo, hi row]
    if (mixed || tile_region < 2) {
      const uint32_t j = (uint32_t)m0 + frag_row(t, 0);
      const int t_lo = (int)((j / (uint32_t)p.HW) % (uint32_t)p.T);
      const int t_hi = (int)(((j + 8) / (uint32_t)p.HW) % (uint32_t)p.T);
      z0[0] = t_lo == 0;
      z0[1] = t_hi == 0;
      z1[0] = t_lo == p.T - 1;
      z1[1] = t_hi == p.T - 1;
    }
    // the 64 x BN tile, rounded to bf16 once, into shared memory
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      // a column's region: fixed per 8-column group in the first tile
      const int group = (i / 4) * 8;
      const int rc = mixed ? (group < F ? 0 : group < 2 * F ? 1 : 2) : tile_region;
      const int h = (i >> 1) & 1;
      const bool zero = !k_steps || (rc == 0 && z0[h]) || (rc == 1 && z1[h]);
      *reinterpret_cast<__nv_bfloat162*>(mine + frag_row(t, i) * Cfg::PITCH +
                                         frag_col(t, i) * 2) =
          zero ? __floats2bfloat162_rn(0.0f, 0.0f)
               : __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
    named_barrier(1 + wg, WG);
    // 16-byte row segments out: a thread keeps one column segment
    constexpr int SEGS = BN / 8, PASS = WG / SEGS;
    const int cc = (t % SEGS) * 8, col = n0 + cc;
    if (col < p.reg.C) {
      for (int r = t / SEGS; r < Cfg::BM; r += PASS) {
        const int64_t j = m0 + r;
        if (j >= p.M) break;
        *reinterpret_cast<uint4*>(p.dx + j * p.reg.C + col) =
            *reinterpret_cast<const uint4*>(mine + r * Cfg::PITCH + cc * 2);
      }
    }
    named_barrier(1 + wg, WG);  // the staged tile is free again
  }
}

// ---------------------------------------------------------------- dW

struct DwArgs {
  float* out;  // (S, C, O) fp32 partials, or (C, O) when S == 1
  Regions reg;
  int O, hw;  // hw: the row shift of the fold regions (0 unshifted)
  int chunks_per_clip, total_chunks;
  int o_tiles, splits, units;
  int stages, stage_bytes;  // a stage: NWG x boxes, then the g tiles
};

// Row shift of the g rows that pair with x's region r: shift(x) reads the
// first fold at row + HW, so dW's first-fold rows sum x[r] g[r - HW], and
// the second fold's x[r] g[r + HW].
__device__ __forceinline__ int dw_shift(const DwArgs& p, int r) {
  return r == 0 ? -p.hw : r == 1 ? p.hw : 0;
}

// index of region r among the regions that [c0, c0 + width) meets
__device__ __forceinline__ int region_slot(const Regions& reg, int r, int c0,
                                           int width) {
  return (int)(r > 0 && reg.meets(0, c0, width)) +
         (int)(r > 1 && reg.meets(1, c0, width));
}

template <int NWG, int BN, int NACC>
__global__ void __launch_bounds__(NWG * WG + PRODUCER, 1)
conv1x1_dw_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap g_map, const DwArgs p) {
  constexpr int BM = 64 * NWG;
  constexpr int G_BYTES = (BN / 64) * ATOM_BYTES;  // one g tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * p.stage_bytes);
  uint64_t* empty = full + p.stages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NWG * WG) {  // producer
    if (tid == NWG * WG) {
      tma_prefetch_map(&x_map);
      tma_prefetch_map(&g_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int tile = u / p.splits, split = u % p.splits;
        const int c0 = (tile / p.o_tiles) * BM, o0 = (tile % p.o_tiles) * BN;
        const int boxes = min(NWG, (p.reg.C - c0 + 63) / 64);
        const int n_g = p.reg.count(c0, BM);
        for (int q = split; q < p.total_chunks; q += p.splits) {
          const int clip = q / p.chunks_per_clip;
          const int row = (q % p.chunks_per_clip) * TILE_K;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * p.stage_bytes;
          mbar_expect_tx(&full[stage], boxes * ATOM_BYTES + n_g * G_BYTES);
          for (int b = 0; b < boxes; ++b)
            tma_load_3d(st + b * ATOM_BYTES, &x_map, &full[stage], c0 + 64 * b,
                        row, clip);
          unsigned char* gt = st + NWG * ATOM_BYTES;
          for (int r = 0; r < 3; ++r) {
            if (!p.reg.meets(r, c0, BM)) continue;
            for (int j = 0; j < BN / 64; ++j)
              tma_load_3d(gt + j * ATOM_BYTES, &g_map, &full[stage], o0 + 64 * j,
                          row + dw_shift(p, r), clip);
            gt += G_BYTES;
          }
          if (++stage == p.stages) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns the C rows [c0 + 64 wg, + 64) of the tile
  // and one accumulator per region its box meets
  const int wg = tid / WG, t = tid % WG;
  float acc[NACC][BN / 2];
  int stage = 0, held = -1;  // held: the stage the MMA in flight still reads
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int tile = u / p.splits, split = u % p.splits;
    const int c0 = (tile / p.o_tiles) * BM, o0 = (tile % p.o_tiles) * BN;
    const int cb = c0 + 64 * wg;
    int g_slot[NACC];  // the g tile each accumulator reads
    int n_acc = 0;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const bool m = cb < p.reg.C && p.reg.meets(r, cb, 64) && n_acc < NACC;
#pragma unroll
      for (int s = 0; s < NACC; ++s)
        if (m && n_acc == s) g_slot[s] = region_slot(p.reg, r, c0, BM);
      n_acc += m;
    }
#pragma unroll
    for (int s = 0; s < NACC; ++s)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0.0f;
    for (int q = split; q < p.total_chunks; q += p.splits) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = ring + stage * p.stage_bytes;
      // A: x's box, M-major (one 64-row atom); B: g, N-major (64-column
      // atoms 8 KB apart)
      const uint64_t da = sw128_desc(st + wg * ATOM_BYTES, ATOM_BYTES, 1024);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < NACC; ++s) {
        if (s >= n_acc) break;
        const uint64_t db = sw128_desc(st + NWG * ATOM_BYTES + g_slot[s] * G_BYTES,
                                       ATOM_BYTES, 1024);
#pragma unroll
        for (int k = 0; k < TILE_K / 16; ++k)
          wgmma<BN, 1, 1>(acc[s], desc_add(da, 2048 * k), desc_add(db, 2048 * k), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one has been read
      if (held >= 0 && t == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == p.stages) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < NACC; ++s) acc_fence(acc[s]);
    if (held >= 0 && t == 0) mbar_arrive(&empty[held]);
    held = -1;
    float* out = p.out + (int64_t)split * p.reg.C * p.O;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int c = cb + frag_row(t, i), o = o0 + frag_col(t, i);
      if (c >= p.reg.C || o >= p.O) continue;
      // each C row from the accumulator of its region
      const int slot = region_slot(p.reg, p.reg.of(c), cb, 64);
      float a = acc[0][i], b = acc[0][i + 1];
#pragma unroll
      for (int s = 1; s < NACC; ++s)
        if (slot == s) a = acc[s][i], b = acc[s][i + 1];
      *reinterpret_cast<float2*>(out + (int64_t)c * p.O + o) = make_float2(a, b);
    }
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

int sm_count(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

template <int BN, int F>
int launch_dx(const void* g, const void* w, DxArgs p, int device, cudaStream_t s) {
  using Cfg = DxCfg<BN, F>;
  CUtensorMap gm, wm;
  const uint64_t gdims[2] = {(uint64_t)p.O, (uint64_t)p.M};
  const uint64_t wdims[2] = {(uint64_t)p.O, (uint64_t)p.reg.C};
  const uint64_t strides[1] = {(uint64_t)p.O * 2};
  const uint32_t gbox[2] = {TILE_K, Cfg::BM}, wbox[2] = {TILE_K, BN};
  if (!make_map(&gm, g, 2, gdims, strides, gbox) ||
      !make_map(&wm, w, 2, wdims, strides, wbox))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv1x1_dx_kernel<BN, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int64_t m_tiles = (p.M + Cfg::BM - 1) / Cfg::BM;
  p.n_tiles = (p.reg.C + BN - 1) / BN;
  if (m_tiles * p.n_tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  p.tiles = (int)(m_tiles * p.n_tiles);
  const int grid = std::min(p.tiles, sm_count(device));
  conv1x1_dx_kernel<BN, F><<<grid, 2 * WG + PRODUCER, Cfg::SMEM, s>>>(gm, wm, p);
  return (int)cudaGetLastError();
}

// dx's tiles: BN columns; a fold that is not whole tiles must sit in the
// first tile (2 fold <= BN) at one of the widths Fs built for BN
template <int BN, int... Fs>
int dispatch_dx(const void* g, const void* w, const DxArgs& p, int device,
                cudaStream_t s) {
  const int fold = p.reg.fold;
  if (fold % BN == 0) return launch_dx<BN, 0>(g, w, p, device, s);
  int err = (int)cudaErrorInvalidValue;
  ((fold == Fs ? (err = launch_dx<BN, Fs>(g, w, p, device, s), 0) : 0), ...);
  return err;
}

template <int NWG, int BN, int NACC>
int launch_dw(const CUtensorMap& xm, const CUtensorMap& gm, DwArgs p,
              int device, cudaStream_t s) {
  constexpr int BM = 64 * NWG;
  p.o_tiles = (p.O + BN - 1) / BN;
  p.units = (p.reg.C + BM - 1) / BM * p.o_tiles * p.splits;
  // a stage: NWG x boxes and a g tile per region a C tile meets
  p.stage_bytes = (NWG + p.reg.most(BM) * BN / 64) * ATOM_BYTES;
  p.stages = std::min(6, (SMEM_MAX - 2048) / (p.stage_bytes + 16));
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + p.stages * (p.stage_bytes + 16);
  cudaError_t err = cudaFuncSetAttribute(conv1x1_dw_kernel<NWG, BN, NACC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min(p.units, sm_count(device));
  conv1x1_dw_kernel<NWG, BN, NACC><<<grid, NWG * WG + PRODUCER, smem, s>>>(xm, gm, p);
  return (int)cudaGetLastError();
}

// dW's kernel for this shape: C rows per warpgroup box (one or two boxes),
// 64 or 128 O columns, an accumulator per region a box meets (three only
// with 64 columns, for registers)
template <int NWG>
int dispatch_dw(const CUtensorMap& xm, const CUtensorMap& gm, const DwArgs& p,
                int device, cudaStream_t s) {
  const int nacc = p.reg.most(64);
  if (nacc == 3) return launch_dw<NWG, 64, 3>(xm, gm, p, device, s);
  if (p.O <= 64)
    return nacc == 2 ? launch_dw<NWG, 64, 2>(xm, gm, p, device, s)
                     : launch_dw<NWG, 64, 1>(xm, gm, p, device, s);
  return nacc == 2 ? launch_dw<NWG, 128, 2>(xm, gm, p, device, s)
                   : launch_dw<NWG, 128, 1>(xm, gm, p, device, s);
}

}  // namespace

// g (M, O) and w (C, O): contiguous bf16, 16-byte aligned; O % 8 == 0,
// C % 8 == 0, fold % 8 == 0. fold == 0: dx = g @ w^T; else dx = S^T (g @
// w^T) over clips of T frames of HW rows.
extern "C" int wd_conv1x1_dx_bf16(const void* g, const void* w, void* dx,
                                  int64_t M, int O, int C, int64_t HW, int T,
                                  int fold, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  if (M > INT32_MAX - 256 || HW > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DxArgs p{(bf16*)dx, M, O, (int)HW, T, Regions{fold, C}, 0, 0};
  // 256 columns (whole rows) only where a tile is one K step: two stages
  // of three g boxes and a 256-row W box are all the ring then holds
  if (C <= 64) return dispatch_dx<64, 8, 16>(g, w, p, device, s);
  if (C > 128 && C <= 256 && O <= 64) return dispatch_dx<256, 32, 64>(g, w, p, device, s);
  return dispatch_dx<128, 16, 32, 64>(g, w, p, device, s);
}

// x (M, C), g (M, O): contiguous bf16, 16-byte aligned; C % 8 == 0,
// O % 8 == 0, fold % 8 == 0. dw (C, O) fp32. K (the rows, cut into 64-row
// chunks within each clip of T * HW rows, or within all M rows when fold
// == 0) is dealt to `splits` partial sums, chunk q to split q mod splits;
// with more than one, work holds that many (C, O) fp32 partials. fold > 0 shifts x's fold columns as S does.
extern "C" int wd_conv1x1_dw_bf16(const void* x, const void* g, void* dw,
                                  void* work, int64_t M, int C, int O,
                                  int64_t HW, int T, int fold, int64_t splits,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = (int64_t)C * O;
  if (M == 0) return (int)cudaMemsetAsync(dw, 0, n * sizeof(float), s);
  const int64_t clip_rows = fold ? HW * T : M;
  if (splits < 1 || clip_rows > INT32_MAX || M % clip_rows)
    return (int)cudaErrorInvalidValue;
  const int64_t clips = M / clip_rows;
  const int64_t per_clip = (clip_rows + TILE_K - 1) / TILE_K;
  const int64_t total = clips * per_clip;
  if (total > INT32_MAX) return (int)cudaErrorInvalidValue;

  // x and g as (channels, T * HW, clips): a box's rows stay in one clip
  CUtensorMap xm, gm;
  const uint32_t box[3] = {TILE_K, TILE_K, 1};
  const uint64_t xdims[3] = {(uint64_t)C, (uint64_t)clip_rows, (uint64_t)clips};
  const uint64_t xstr[2] = {(uint64_t)C * 2, (uint64_t)(clip_rows * C * 2)};
  if (!make_map(&xm, x, 3, xdims, xstr, box)) return (int)cudaErrorInvalidValue;
  const uint64_t gdims[3] = {(uint64_t)O, (uint64_t)clip_rows, (uint64_t)clips};
  const uint64_t gstr[2] = {(uint64_t)O * 2, (uint64_t)(clip_rows * O * 2)};
  if (!make_map(&gm, g, 3, gdims, gstr, box)) return (int)cudaErrorInvalidValue;

  DwArgs p{};
  p.out = splits == 1 ? (float*)dw : (float*)work;
  p.reg = Regions{fold, C};
  p.O = O;
  p.hw = fold ? (int)HW : 0;
  p.chunks_per_clip = (int)per_clip;
  p.total_chunks = (int)total;
  p.splits = (int)splits;
  err = (cudaError_t)(C <= 64 ? dispatch_dw<1>(xm, gm, p, device, s)
                              : dispatch_dw<2>(xm, gm, p, device, s));
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t n4 = n / 4;
  const int64_t want = (n4 + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  dw_reduce_kernel<<<blocks, 256, 0, s>>>((const float4*)work, (float4*)dw, n4,
                                         (int)splits);
  return (int)cudaGetLastError();
}
