// y = shift(x) @ W: the TSM temporal shift fused into a stride-1 1x1 conv.
//
// Replaces workoutdetector_tpu/ops/pallas/shift_matmul.py:
// _shift_matmul_fwd_impl (_kernel), forward only. x is (M = B*T*HW, C) bf16
// rows r = (b*T + t)*HW + p, W is (C, O) bf16, y is (M, O) bf16 with an fp32
// accumulator, rounded once on store. Channels [0, fold) read frame t+1
// (zero at t = T-1), [fold, 2 fold) frame t-1 (zero at t = 0); the shift
// never crosses a clip.
//
// Bound on the H100: bytes count x and W read once and y written once. At
// the TSM-R50 sites (K = C = 64..2048, O = 64..512) the arithmetic
// intensity M*K*O / (M*K + K*O + M*O) runs from 21 FLOP/byte (C = O = 64)
// to ~400 (C = 2048, O = 512): under the card's ~295 FLOP/byte bf16 ridge
// bytes bind, at the three layer4 sites the tensor cores do. Summed over
// a 16-clip forward's 10 sites the bound is 0.288 ms.
//
// Design, on wd_wgmma.cuh as conv1x1_bwd.cu: a persistent grid of one
// block per SM walks output tiles of 128 rows x BN columns (BN = 64, 128
// or 256, the least that holds O; wider O takes several column tiles).
// Two consumer warpgroups own 64 rows each and share the tile's W (a
// cooperative tile: a 64-row tile per warpgroup would load W twice as
// often). One producer thread issues TMA loads into a ring of stages
// guarded by full/empty mbarriers (its warpgroup gives most of its
// registers to the consumers); a stage is one 64-deep K step, each
// warpgroup's 64 x 64 x box and the 64 x BN W box. wgmma runs 16-deep
// k-steps (M = 64 per warpgroup, N = BN). The producer runs up to a ring
// ahead, into the next tile, while the consumers store this one.
//
// W as it lies: (C, O) row-major is N-major for wgmma's B (64-column atoms
// 8 KB apart, read with the transpose bit), so no W^T copy is made.
//
// The shift rides on the x loads. x is seen as 3-D maps (channels, T*HW,
// clips), one per channel region, each based at its region's first
// channel with its channel extent cut to the region. A row tile is 64 rows
// of one clip; a K chunk's box for region r loads at the tile's rows + HW
// (first fold), - HW (second fold) or + 0: TMA's zero fill past the clip's
// ends and outside the region's channels puts exactly shift(x)'s values in
// shared memory. No shifted tensor is written and no row index is computed
// per element. A K chunk that meets several regions (fold 32 at C = 256:
// [0, 32) and [32, 64) of chunk 0; fold 8 at C = 64: all three) takes one
// ring stage per region (a region pass), its x boxes zero outside that
// region, and each pass runs all four 16-deep k-steps of the chunk: the
// zeros add nothing, so the sum is exact wherever the folds cut (fold 8
// cuts inside a k-step, so choosing k-steps could not do it), and the
// MMAs run straight through (wgmmas issued under a branch made ptxas
// fence each of them, C7519). The repeated products fall in chunk 0 of
// sites that bytes bind (C = 256: 20 k-steps of 16; C = 64: 12 of 4).
// fold = 0 is one region and all M rows one clip.
//
// Row tiles lie in one clip: a clip of T*HW rows takes ceil(T*HW / 64)
// tiles (at 7x7, 392 rows a clip, the 7th tile holds 8 real rows: 56 of
// the 448 rows walked, 12.5 %, are padding, loaded as zeros, their stores
// dropped; 2 % at 14x14, none at 28x28 and 56x56).
// Consecutive row tiles pair into a block tile; the pairs walk the rows
// with the column tiles innermost, so a pair's x is in L2 for its next
// column tile.
//
// Epilogue: each warpgroup rounds its 64 x BN accumulators to bf16 once,
// 64 columns at a time, into a 128-byte-swizzled shared box (two a
// warpgroup, used in turn), and one thread stores each box by TMA through
// the 3-D map of y, which drops the rows past the clip and the columns
// past O. The stores drain while the next tile's K loop runs. (Two boxes,
// not the whole 64 x 256 tile, leave room for a fourth ring stage at BN =
// 256.)
// Each output element is summed by one warpgroup in a fixed order: the
// same bits on every run.
//
// Measured on the H100 and not kept (tools/shift_matmul_bench.py): W
// resident in shared memory for a whole block (C <= 256: no W box in the
// ring), and a chunk's region stages joined into one pass whose k-steps
// each read their region's box (fold % 16 == 0): neither was faster; the
// second's extra bookkeeping slowed the unshifted product too. Tiles of
// 128 columns at O = 256 and 512 won at some sites (layer4_0, the
// training layer3 sites) and lost at others (inference layer3_1..5, both
// layer4_1..2): no net gain.
#include "wd_wgmma.cuh"

namespace {

using namespace wd;
using bf16 = __nv_bfloat16;

constexpr int WG = 128;  // threads of a warpgroup
// a third warpgroup feeds the ring (its first thread issues the loads) and
// gives its registers to the two consumer warpgroups: 168 a thread at
// launch (65,536 / 384), then 40 for it and 232 for them, so that a 64 x
// 256 fp32 accumulator (128 registers) and its addressing fit unspilled
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int BM = 64;                    // rows of a warpgroup's tile
constexpr int A_BYTES = BM * ROW_BYTES;   // a warpgroup's x box (64 x 64)

template <int BN>
struct Cfg {
  static constexpr int STAGE = 2 * A_BYTES + BN * ROW_BYTES;  // x boxes, W box
  static constexpr int SLICES = BN / 64;  // 64-column output boxes of a tile
  static constexpr int BUFS = SLICES < 2 ? SLICES : 2;  // staged a warpgroup
  static constexpr int OUT_BYTES = BUFS * ATOM_BYTES;   // a warpgroup's boxes
  static constexpr int FREE = SMEM_MAX - 1024 - 2 * OUT_BYTES - 256;
  static constexpr int STAGES = FREE / STAGE > 8 ? 8 : FREE / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * OUT_BYTES + 2 * STAGES * 8;
  static_assert(STAGES >= 2 && SMEM <= SMEM_MAX, "shift_matmul shared memory");
};

// the tile width for O columns: the least of 64, 128, 256 that holds O
__host__ __device__ inline int tile_width(int O) { return O <= 64 ? 64 : O <= 128 ? 128 : 256; }

struct Plan {
  Regions reg;
  int O, HW;           // HW: the row shift of the fold regions
  int clips, tiles_per_clip;  // 64-row tiles of a clip of clip_rows rows
  int row_tiles;       // clips x tiles_per_clip
  int n_tiles;         // column tiles of BN
  int tiles;           // block tiles: pairs of row tiles x column tiles
  int chunks;          // 64-deep K chunks
  int stages;          // ring stages a block tile takes (region passes)
  int64_t clip_rows;
};

// does K chunk kb take a ring stage (a pass) for region r?
__host__ __device__ inline bool takes(const Regions& reg, int kb, int r) {
  return reg.meets(r, kb * TILE_K, TILE_K);
}

// row offset of region r's box: the first fold reads frame t+1, the second
// frame t-1
__host__ __device__ inline int row_shift(int HW, int r) {
  return r == 0 ? HW : r == 1 ? -HW : 0;
}

// the clip and first row of row tile s (past the last: a clip past the
// tensor, so its loads are zeros and its stores are dropped)
__device__ __forceinline__ void row_tile(const Plan& p, int s, int& clip, int& row) {
  clip = s / p.tiles_per_clip;
  row = (s - clip * p.tiles_per_clip) * BM;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t off = smem_u32(p) & 1023u;
  return off ? p + (1024 - off) : p;
}

template <int BN>
__global__ void __launch_bounds__(3 * WG, 1)
shift_matmul_kernel(const __grid_constant__ CUtensorMap x0,
                    const __grid_constant__ CUtensorMap x1,
                    const __grid_constant__ CUtensorMap x2,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap y_map, const Plan p) {
  using Cf = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* out = ring + Cf::STAGES * Cf::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 2 * Cf::OUT_BYTES);
  uint64_t* empty = full + Cf::STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 2 * WG) {  // producer: every tile of this block, in order
    regs_dec<PRODUCER_REGS>();
    if (tid == 2 * WG) {
      tma_prefetch_map(&x0);
      tma_prefetch_map(&x1);
      tma_prefetch_map(&x2);
      tma_prefetch_map(&w_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int pair = tile / p.n_tiles, n0 = (tile - pair * p.n_tiles) * BN;
        int clip[2], row[2];
        row_tile(p, 2 * pair, clip[0], row[0]);
        row_tile(p, 2 * pair + 1, clip[1], row[1]);
        for (int kb = 0; kb < p.chunks; ++kb) {
          for (int r = 0; r < 3; ++r) {
            if (!takes(p.reg, kb, r)) continue;
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* st = ring + stage * Cf::STAGE;
            mbar_expect_tx(&full[stage], Cf::STAGE);
            const CUtensorMap* xm = r == 0 ? &x0 : r == 1 ? &x1 : &x2;
            const int c = kb * TILE_K - p.reg.lo(r), dr = row_shift(p.HW, r);
            for (int w = 0; w < 2; ++w)
              tma_load_3d(st + w * A_BYTES, xm, &full[stage], c, row[w] + dr, clip[w]);
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(st + 2 * A_BYTES + j * ATOM_BYTES, &w_map, &full[stage],
                          n0 + 64 * j, kb * TILE_K);
            if (++stage == Cf::STAGES) { stage = 0; phase ^= 1; }
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns row tile 2 pair + wg of each block tile
  regs_inc<CONSUMER_REGS>();
  const int wg = tid / WG, t = tid % WG;
  unsigned char* mine = out + wg * Cf::OUT_BYTES;
  float acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int pair = tile / p.n_tiles, n0 = (tile - pair * p.n_tiles) * BN;
    int clip, row0;
    row_tile(p, 2 * pair + wg, clip, row0);
    // the tile's stages in the producer's order; which chunk and region
    // each holds does not matter here
    int held = -1;  // the stage the MMA in flight still reads
    for (int v = 0; v < p.stages; ++v) {
      mbar_wait(&full[stage], phase);
      unsigned char* st = ring + stage * Cf::STAGE;
      const uint64_t da = sw128_desc(st + wg * A_BYTES, 16, 1024);
      const uint64_t db = sw128_desc(st + 2 * A_BYTES, ATOM_BYTES, 1024);
      wgmma_fence();
      wgmma<BN, 0, 1>(acc, da, db, v > 0);  // the first product starts acc
#pragma unroll
      for (int k = 1; k < TILE_K / 16; ++k)
        wgmma<BN, 0, 1>(acc, desc_add(da, 32 * k), desc_add(db, 2048 * k), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one has been read
      if (held >= 0 && t == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == Cf::STAGES) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    acc_fence(acc);
    if (held >= 0 && t == 0) mbar_arrive(&empty[held]);

    // the 64 x BN tile, rounded to bf16 once, 64 columns at a time into
    // the 128-byte-swizzled box of y's map, once the store that last used
    // the box has read it
#pragma unroll
    for (int a = 0; a < Cf::SLICES; ++a) {
      unsigned char* box = mine + (a % Cf::BUFS) * ATOM_BYTES;
      if (t == 0) bulk_wait_read<Cf::BUFS - 1>();
      named_barrier(1 + wg, WG);
#pragma unroll
      for (int i = 32 * a; i < 32 * a + 32; i += 2) {
        const int r = frag_row(t, i), c = frag_col(t, i) & 63;
        *reinterpret_cast<__nv_bfloat162*>(box + r * ROW_BYTES +
                                           (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
      fence_async_smem();
      named_barrier(1 + wg, WG);
      if (t == 0) {
        if (n0 + 64 * a < p.O) tma_store_3d(&y_map, box, n0 + 64 * a, row0, clip);
        bulk_commit();
      }
    }
  }
  if (t == 0) bulk_wait<0>();
}

int sm_count(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

// The walk for x (M, C) over clips of T frames of HW rows, W (C, O) and
// fold; false where the kernel does not take the shape.
bool make_plan(int64_t M, int64_t HW, int T, int C, int O, int fold, Plan* p) {
  if (M < 1 || C < 8 || C % 8 || O < 16 || O % 16 || fold < 0 || fold % 8 ||
      2 * fold > C || T < 1 || HW < 1)
    return false;
  p->reg = Regions{fold, C};
  p->O = O;
  // unshifted, all rows are one clip
  p->clip_rows = fold ? HW * T : M;
  if (M % p->clip_rows || p->clip_rows + HW + BM > INT32_MAX) return false;
  p->HW = fold ? (int)HW : 0;
  const int64_t clips = M / p->clip_rows;
  const int64_t per_clip = (p->clip_rows + BM - 1) / BM;
  const int64_t n_tiles = (O + tile_width(O) - 1) / tile_width(O);
  const int64_t tiles = (clips * per_clip + 1) / 2 * n_tiles;
  if (tiles > INT32_MAX) return false;
  p->clips = (int)clips;
  p->tiles_per_clip = (int)per_clip;
  p->row_tiles = (int)(clips * per_clip);
  p->n_tiles = (int)n_tiles;
  p->tiles = (int)tiles;
  p->chunks = (C + TILE_K - 1) / TILE_K;
  p->stages = 0;
  for (int kb = 0; kb < p->chunks; ++kb)
    for (int r = 0; r < 3; ++r) p->stages += takes(p->reg, kb, r);
  return true;
}

template <int BN>
int smem_bytes() { return Cfg<BN>::SMEM; }
template <int BN>
int stages() { return Cfg<BN>::STAGES; }

template <int BN>
int launch(const void* x, const void* w, void* y, const Plan& p, int device,
           cudaStream_t s) {
  const int C = p.reg.C;
  const uint32_t box3[3] = {TILE_K, BM, 1}, box2[2] = {TILE_K, TILE_K};
  CUtensorMap xm[3], wm, ym;
  for (int r = 0; r < 3; ++r) {
    // region r's channels; an empty region (never loaded) maps all of x
    const bool empty = p.reg.lo(r) >= p.reg.hi(r);
    const int lo = empty ? 0 : p.reg.lo(r), width = empty ? C : p.reg.hi(r) - lo;
    const uint64_t dims[3] = {(uint64_t)width, (uint64_t)p.clip_rows, (uint64_t)p.clips};
    const uint64_t strides[2] = {(uint64_t)C * 2, (uint64_t)(p.clip_rows * C * 2)};
    if (!make_map(&xm[r], (const bf16*)x + lo, 3, dims, strides, box3))
      return (int)cudaErrorInvalidValue;
  }
  const uint64_t wdims[2] = {(uint64_t)p.O, (uint64_t)C};
  const uint64_t wstrides[1] = {(uint64_t)p.O * 2};
  const uint64_t ydims[3] = {(uint64_t)p.O, (uint64_t)p.clip_rows, (uint64_t)p.clips};
  const uint64_t ystrides[2] = {(uint64_t)p.O * 2, (uint64_t)(p.clip_rows * p.O * 2)};
  if (!make_map(&wm, w, 2, wdims, wstrides, box2) ||
      !make_map(&ym, y, 3, ydims, ystrides, box3))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(shift_matmul_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<BN>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min(p.tiles, sm_count(device));
  shift_matmul_kernel<BN><<<grid, 3 * WG, Cfg<BN>::SMEM, s>>>(
      xm[0], xm[1], xm[2], wm, ym, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, C), w (C, O), y (M, O): contiguous bf16, 16-byte aligned; C % 8 ==
// 0, O % 16 == 0, fold % 8 == 0 with 2 fold <= C, M a whole number of
// clips of T frames of HW rows when fold > 0; rows are indexed in 32 bits
// (within a clip).
extern "C" int wd_shift_matmul_bf16(const void* x, const void* w, void* y,
                                    int64_t M, int64_t HW, int T, int C, int O,
                                    int fold, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  Plan p;
  if (!make_plan(M, HW, T, C, O, fold, &p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile_width(O)) {
    case 64: return launch<64>(x, w, y, p, device, s);
    case 128: return launch<128>(x, w, y, p, device, s);
    default: return launch<256>(x, w, y, p, device, s);
  }
}

// The kernel's own plan for a shape, as ops/kernels/shift_matmul.py's
// shift_matmul_plan mirrors it: out[0..9] = tile width, ring stages, shared
// memory bytes, clip rows, clips, row tiles a clip, row tiles, column
// tiles, block tiles, ring stages a block tile takes; then per stage of a
// block tile (up to max_steps) its K chunk, region and row offset. Returns
// cudaErrorInvalidValue where the kernel does not take the shape.
extern "C" int wd_shift_matmul_plan(int64_t M, int64_t HW, int T, int C, int O,
                                    int fold, int64_t* out, int max_steps) {
  Plan p;
  if (!make_plan(M, HW, T, C, O, fold, &p)) return (int)cudaErrorInvalidValue;
  const int bn = tile_width(O);
  out[0] = bn;
  out[1] = bn == 64 ? stages<64>() : bn == 128 ? stages<128>() : stages<256>();
  out[2] = bn == 64 ? smem_bytes<64>() : bn == 128 ? smem_bytes<128>() : smem_bytes<256>();
  out[3] = p.clip_rows;
  out[4] = p.clips;
  out[5] = p.tiles_per_clip;
  out[6] = p.row_tiles;
  out[7] = p.n_tiles;
  out[8] = p.tiles;
  int n = 0;
  for (int kb = 0; kb < p.chunks; ++kb)
    for (int r = 0; r < 3; ++r) {
      if (!takes(p.reg, kb, r)) continue;
      if (n < max_steps) {
        int64_t* q = out + 10 + 3 * n;
        q[0] = kb;
        q[1] = r;
        q[2] = row_shift(p.HW, r);
      }
      ++n;
    }
  out[9] = n;
  return 0;
}
