// One whole stride-1 inference ResNet bottleneck in one kernel, on wgmma:
//
//   y1  = relu(s1 * (shift(x) @ W1) + b1)          1x1, BN folded, -> bf16
//   y2  = relu(s2 * conv3x3_same(y1) + b2)          -> bf16
//   y3  = s3 * (y2 @ W3) + b3                       fp32
//   out = relu(y3 + res), res = x or sd * (x @ Wd) + bd   (fp32) -> bf16
//
// Replaces workoutdetector_tpu/ops/pallas/fused_block.py: fused_bottleneck
// (_kernel), with the same rounding points (y1 and y2 in bf16; the residual,
// its downsample and the sum in fp32; conv1's output at halo pixels outside
// the frame zeroed after the ReLU, standing in for conv2's zero padding), for
// F = 64 and 128 (TSM-R50's stages 0-1) and a downsample over at most 128
// channels. Other widths take fused_block_wmma.cu.
//
// Bound on the H100: at layer1/layer2 (C = 256/512, F = 64/128) the block
// does ~140 FLOP per byte of x + out, under the ~295 FLOP/byte bf16 ridge,
// so bytes bind: x read once and out written once.
//
// Design. A persistent grid of one block per SM; a block is two warpgroups
// (256 threads, up to 255 registers each: a producer warp would cap them at
// 168 and the accumulators spilled). Each warpgroup owns one frame's
// TH x TW = 4 x 16 output tile at a time (the two tiles of a pair are
// neighbours); the block walks its pairs. Per tile:
//   conv1 over the tile and a 1-px halo (6 x 18 = 108 pixels, two 64-row
//     wgmma tiles), K = C in 64-channel chunks, one pass of the chunks per
//     64 columns of F (F = 128 streams them twice: half the accumulators).
//     The warpgroup stages each chunk of shift(x) itself with cp.async, 16
//     bytes (8 channels) a copy,
//     into a 128-byte-swizzled 128-row tile, two chunks ahead: a copy takes
//     its 8 channels from frame t + 1 (channels [0, fold)), t - 1 ([fold,
//     2 fold)) or t, zero-filled where that frame leaves the clip or the
//     pixel leaves the frame, so every fold that is a multiple of 8 (8, 32
//     and 64 at the three sites) is one rule and no 16-byte TMA box (whose
//     swizzle phase would not match the 128-byte rows) is needed. The tile
//     is wgmma's K-major layout, so A is read from shared memory (a proxy
//     fence orders the copies before the products). The next tile's first
//     two chunks are staged as soon as conv1 is done, under conv2 and conv3;
//   the epilogue (BN, ReLU, the zero outside the frame) works on the
//     accumulator registers and writes y1 in bf16 to shared memory,
//     128-byte swizzled, 64-channel panels of 108 rows;
//   conv2, the 3 x 3 SAME conv over y1: 9 taps x F/64 chunks. A tap reads
//     y1 at the row offset dy (TW + 2) + dx, which is not a multiple of the
//     8-row swizzle atom, so no A descriptor can point at it: A comes from
//     registers, by ldmatrix with one row address a lane (any row offset
//     works, and 8 consecutive rows of the swizzled panel hit 8 distinct
//     bank groups);
//   its epilogue packs y2 = relu(BN) to bf16 straight into the register A
//     fragments of conv3 (an m64nN accumulator's two neighbouring 8-column
//     blocks are the A fragment of a 16-deep step): y2 never leaves
//     registers;
//   conv3 (+ the downsample, whose A is the tile's unshifted x, staged at the
//     tile's start and read from shared memory) in 64-column passes of O;
//     its epilogue adds the residual (x from device memory, loaded under
//     the products, or the downsample in fp32) and writes out in bf16.
// The folded BN scales and biases are staged in shared memory once per
// block; y1's epilogue takes its thread's 8 column pairs into registers
// before its first store (read between its stores they made the epilogue
// twice as slow), and each epilogue works out a fragment row's place in the
// frame once.
// Weights: every 64 x 64 weight tile (W1, W2, W3, Wd in the order the
// warpgroups use them) comes by TMA into an 8-deep ring of mbarrier-guarded
// stages, issued by thread 0 as the warpgroups consume (Feed); both
// warpgroups read each tile, so one pass over the weights serves 128 output
// pixels (the WMMA kernel read them once per 64 pixels, and by cp.async with
// a block barrier per 32-deep chunk). L2 bytes of weights per launch:
// (C F + 9 F^2 + F O (+ C O)) x 2 x tile pairs, at 16 clips 0.50 GB at
// layer1_1..2 (3,584 pairs of 139,264 bytes), 0.53 GB at layer1_0 (3,584 of
// 147,456), 0.50 GB at layer2 (896 of 557,056); the WMMA kernel's twice
// that. (A ring per warpgroup, each reading every weight tile, decouples
// the two but ran slower on the H100: its 4 stages do not cover layer2's
// 68 tiles a pair.)
// No fp32 scratch tile: every epilogue reads its accumulator registers
// (wd::frag_row / frag_col). Each output element has one writer and a fixed
// summation order: two runs give the same bits.
#include "attention_common.cuh"
#include "wd_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using wdattn::cp_async16;
using wdattn::cp_async_commit;
using wdattn::cp_async_wait;
using wdattn::pack_bf16;

constexpr int TH = 4, TW = 16;             // output tile of a warpgroup
constexpr int HWD = TW + 2;                // halo row width
constexpr int M1 = (TH + 2) * HWD;         // 108 halo pixels
constexpr int WG = 128, NWG = 2;
constexpr int NT = NWG * WG;               // two warpgroups, up to 255 registers
constexpr int ATOM = 8192;                 // a 64 x 64 bf16 weight tile
constexpr int STAGES = 8;                  // the weight ring
constexpr int XBUF = 128 * 128;            // a 64-channel chunk of 128 rows
constexpr int Y1P = 112 * 128;             // a 64-channel panel of y1 (108 rows)
constexpr int XCBUF = 2 * ATOM;            // the downsample's A: C <= 128
constexpr int SMEM_MAX = 232448;

// Shared memory of one block for F = 64 nf, O outputs and a downsample (or
// not): the ring, per warpgroup its x buffers, the downsample's x panels and
// nf y1 panels, the ring's barriers, the folded BN scales and biases (fp32:
// 2 F for each of conv1 and conv2, 2 O for conv3 and the downsample); 1024
// bytes of slack to align the tiles.
constexpr int NB = 2;  // x buffers a warpgroup keeps: chunks staged ahead
__host__ __device__ constexpr int wg_bytes(int nf) {
  return NB * XBUF + XCBUF + nf * Y1P;
}
__host__ __device__ constexpr int scale_floats(int nf, int O, bool ds) {
  return 4 * 64 * nf + 2 * O * (ds ? 2 : 1);
}
__host__ __device__ constexpr int fused_smem(int nf, int O, bool ds) {
  return 1024 + STAGES * ATOM + NWG * wg_bytes(nf) + 2 * STAGES * 8 +
         4 * scale_floats(nf, O, ds);
}

struct FusedArgs {
  const bf16* x;
  bf16* out;
  const float *sb1, *sb2, *sb3, *sbd;
  int H, W, C, O, T, fold;
  int tiles_x, tiles_per_frame, tiles, pairs;
  int kc1;  // 64-channel chunks of C
  int no;   // 64-column passes of O
  int ds;   // a downsample
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t off = wd::smem_u32(p) & 1023u;
  return off ? p + (1024 - off) : p;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(wd::smem_u32(p))
               : "memory");
}

// The register A fragments of a 64-deep chunk of 16 rows (rows row0 .. row0
// + 15 of a 128-byte-swizzled tile, this warp's): a[kk] for k-step kk.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const unsigned char* tile,
                                       int row0, int lane) {
  const int row = row0 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(a[kk], tile + row * 128 + (((2 * kk + (lane >> 4)) ^ (row & 7)) << 4));
}

// acc (64 x 64) += A (64 x 64, registers) W (the ring's next 64 x 64 tile)
__device__ __forceinline__ void mma_tile(float (&acc)[32], const uint32_t (&a)[4][4],
                                         uint64_t db, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wd::wgmma_ra_n64<1>(acc, a[kk], wd::desc_add(db, 2048 * kk), accumulate || kk > 0);
}

__device__ __forceinline__ void mma_done(float (&acc)[32]) {
  wd::wgmma_commit();
  wd::wgmma_wait<0>();
  wd::acc_fence(acc);
}

struct Tile {
  int n, ty0, tx0, tq;  // frame, origin, time in the clip
  bool valid;
};

// Warpgroup wg's tile of a pair: pairs are neighbouring tiles; a tile past
// the last is not valid (its loads are zero-filled, its stores skipped).
__device__ __forceinline__ Tile tile_of(const FusedArgs& p, int pair, int wg) {
  Tile tl;
  const int tile = 2 * pair + wg;
  tl.valid = tile < p.tiles;
  const int in = tl.valid ? tile % p.tiles_per_frame : 0;
  tl.n = tl.valid ? tile / p.tiles_per_frame : 0;
  tl.ty0 = in / p.tiles_x * TH;
  tl.tx0 = in % p.tiles_x * TW;
  tl.tq = tl.n % p.T;
  return tl;
}

// The residual x (C == O) of conv3's pass nb3 at the thread's accumulator
// elements, as bf16 pairs (zero outside the frame)
__device__ __forceinline__ void load_residual(uint32_t (&xr)[16], const FusedArgs& p,
                                              const Tile& tl, int nb3, int t) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = wd::frag_row(t, i), col = nb3 * 64 + wd::frag_col(t, i);
    const int gy = tl.ty0 + r / TW, gx = tl.tx0 + r % TW;
    const bool in = tl.valid && gy < p.H && gx < p.W && col < p.O;
    xr[i / 2] = in ? __ldg(reinterpret_cast<const unsigned int*>(
                         p.x + (((int64_t)tl.n * p.H + gy) * p.W + gx) * p.C + col))
                   : 0u;
  }
}

// Stage chunk kc of shift(x) at the tile's 108 halo pixels into a swizzled
// 128-row tile (rows 108.. are never read into a stored result).
__device__ __forceinline__ void stage_halo(unsigned char* buf, const FusedArgs& p,
                                           const Tile& tl, int kc, int t) {
  for (int v = t; v < M1 * 8; v += WG) {
    const int r = v >> 3, j = v & 7;
    const int gy = tl.ty0 - 1 + r / HWD, gx = tl.tx0 - 1 + r % HWD;
    const int k = kc * 64 + 8 * j;
    bool ok = tl.valid && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W && k < p.C;
    int src = tl.n;
    if (k < p.fold) {
      ok = ok && tl.tq < p.T - 1;
      src = tl.n + 1;
    } else if (k < 2 * p.fold) {
      ok = ok && tl.tq > 0;
      src = tl.n - 1;
    }
    const bf16* g = p.x + (((int64_t)src * p.H + gy) * p.W + gx) * p.C + k;
    cp_async16(buf + r * 128 + ((j ^ (r & 7)) << 4), ok ? g : p.x, ok);
  }
}

// Stage the tile's 64 output pixels of x, unshifted, all C channels, as
// 64-row panels (the downsample's A)
__device__ __forceinline__ void stage_center(unsigned char* buf, const FusedArgs& p,
                                             const Tile& tl, int t) {
  for (int v = t; v < p.kc1 * 64 * 8; v += WG) {
    const int kc = v >> 9, r = (v >> 3) & 63, j = v & 7;
    const int gy = tl.ty0 + r / TW, gx = tl.tx0 + r % TW;
    const int k = kc * 64 + 8 * j;
    const bool ok = tl.valid && gy < p.H && gx < p.W && k < p.C;
    const bf16* g = p.x + (((int64_t)tl.n * p.H + gy) * p.W + gx) * p.C + k;
    cp_async16(buf + kc * ATOM + r * 128 + ((j ^ (r & 7)) << 4), ok ? g : p.x, ok);
  }
}

// The weight tiles of a tile pair, in use order, and their loads into the
// block's ring, which both warpgroups read. Thread 0 of warpgroup 0 issues
// them as that warpgroup consumes: before it waits for tile j it issues every
// tile up to j + STAGES - 1 whose stage both warpgroups have freed (a
// test, which does not wait), and blocks only for tile j itself. Warpgroup 1
// only waits for tiles already issued, so it always frees that stage: no
// deadlock.
template <int NF, bool DS>
struct Feed {
  static constexpr int F = 64 * NF;
  const CUtensorMap *w1, *w2, *w3, *wd;
  unsigned char* ring;
  uint64_t *full, *empty;
  int kc1, no, per_pair, total, issued;

  // map and (column, row) of the j-th tile of a pair
  __device__ __forceinline__ void tile(int j, const CUtensorMap*& m, int& col,
                                       int& row) const {
    if (j < kc1 * NF) {  // conv1: a pass of all chunks per column block
      m = w1, col = j / kc1 * 64, row = j % kc1 * 64;
      return;
    }
    j -= kc1 * NF;
    if (j < 9 * NF * NF) {  // conv2: tap, chunk, column block
      m = w2, col = j % NF * 64, row = j / (NF * NF) * F + j / NF % NF * 64;
      return;
    }
    j -= 9 * NF * NF;
    const int per = NF + (DS ? kc1 : 0);  // conv3 (+ downsample) per pass
    col = j / per * 64;
    j %= per;
    if (j < NF) m = w3, row = j * 64;
    else m = wd, row = (j - NF) * 64;
  }

  __device__ __forceinline__ void issue() {
    const int s = issued % STAGES;
    const CUtensorMap* m;
    int col, row;
    tile(issued % per_pair, m, col, row);
    wd::mbar_expect_tx(&full[s], ATOM);
    wd::tma_load_2d(ring + s * ATOM, m, &full[s], col, row);
    ++issued;
  }

  // tile `need` must be in flight; up to need + STAGES - 1 may be
  __device__ __forceinline__ void fill(int need) {
    while (issued < total && issued < need + STAGES) {
      const uint32_t parity = ((issued / STAGES) & 1) ^ 1;  // its stage's last release
      if (issued <= need)
        wd::mbar_wait(&empty[issued % STAGES], parity);
      else if (!wd::mbar_test(&empty[issued % STAGES], parity))
        break;
      issue();
    }
  }
};

template <int NF, bool DS>
__global__ void __launch_bounds__(NT, 1)
fused_bottleneck_kernel(const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const __grid_constant__ CUtensorMap w3_map,
                        const __grid_constant__ CUtensorMap wd_map,
                        const FusedArgs p) {
  constexpr int F = 64 * NF;
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int wg = tid / WG, t = tid % WG, warp = t / 32, lane = tid % 32;
  // the weight ring, then per warpgroup its x buffers, downsample panels
  // and y1 panels; then the ring's mbarriers and the scales
  unsigned char* ring = align1024(smem_raw);
  unsigned char* xb = ring + STAGES * ATOM + wg * wg_bytes(NF);  // its x buffers
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + STAGES * ATOM + NWG * wg_bytes(NF));
  uint64_t* empty = full + STAGES;
  // the folded BN [scale; bias] rows of conv1, conv2, conv3, the downsample
  float* sb1 = reinterpret_cast<float*>(empty + STAGES);
  float* sb2 = sb1 + 2 * F;
  float* sb3 = sb2 + 2 * F;
  float* sbd = sb3 + 2 * p.O;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wd::mbar_init(&full[s], 1);
      wd::mbar_init(&empty[s], NWG);
    }
    wd::mbar_fence_init();
    wd::tma_prefetch_map(&w1_map);
    wd::tma_prefetch_map(&w2_map);
    wd::tma_prefetch_map(&w3_map);
    if (DS) wd::tma_prefetch_map(&wd_map);
  }
  for (int i = tid; i < 2 * F; i += NT) {
    sb1[i] = p.sb1[i];
    sb2[i] = p.sb2[i];
  }
  for (int i = tid; i < 2 * p.O; i += NT) {
    sb3[i] = p.sb3[i];
    if (DS) sbd[i] = p.sbd[i];
  }
  __syncthreads();

  const bool feeder = tid == 0;
  Feed<NF, DS> feed{&w1_map, &w2_map, &w3_map, &wd_map, ring, full, empty,
                    p.kc1, p.no, 0, 0, 0};
  feed.per_pair = p.kc1 * NF + 9 * NF * NF + p.no * (NF + (DS ? p.kc1 : 0));
  feed.total = feed.per_pair * ((p.pairs - 1 - (int)blockIdx.x) / (int)gridDim.x + 1);
  // weight tiles this warpgroup has waited for and released, in order
  int taken = 0, freed = 0;
  // wait for the next weight tile (thread 0 first keeps the ring fed); B
  // descriptor of it, N-major
  auto next_w = [&]() {
    if (feeder) feed.fill(taken);
    wd::mbar_wait(&full[taken % STAGES], (taken / STAGES) & 1);
    return wd::sw128_desc(ring + taken++ % STAGES * ATOM, 8192, 1024);
  };
  auto done_w = [&]() {  // the oldest tile taken and not yet released
    if (t == 0) wd::mbar_arrive(&empty[freed % STAGES]);
    ++freed;
  };

  unsigned char* xc = xb + NB * XBUF;             // the downsample's A
  unsigned char* y1 = xc + XCBUF;                 // NF panels
  // cp.async groups, in commit order per tile: the first NB chunks of the
  // stream (staged during the tile before, or here for the first), the
  // downsample's x panels, then one group per chunk q (chunk q + NB, or
  // empty); the next tile's first NB chunks are staged once conv1 is done.
  Tile tl = tile_of(p, blockIdx.x, wg);
  const int nq = NF * p.kc1;
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    if (q < nq) stage_halo(xb + q * XBUF, p, tl, q % p.kc1, t);
    cp_async_commit();
  }
  for (int pair = blockIdx.x; pair < p.pairs; pair += gridDim.x) {
    Tile next;
    wd::named_barrier(1 + wg, WG);  // the last tile's reads of xc and y1 are done
    if (DS) stage_center(xc, p, tl, t);
    cp_async_commit();

    // ---- conv1: shift(x) @ W1 over the 108 halo pixels, two 64-row tiles
    // (rows 108.. of the second are never stored), A from shared memory; a
    // pass of all C per 64 columns of F (the chunks stream again for the
    // second pass of F = 128: 64 accumulators a thread, not 128), each pass
    // ending in its epilogue: y1 = relu(s1 acc + b1), zero outside the
    // frame, bf16, into its swizzled panel. Chunk q of the stream is channel
    // chunk q % kc1.
#pragma unroll
    for (int nb = 0; nb < NF; ++nb) {
      float acc1[2][32];
      for (int kc = 0; kc < p.kc1; ++kc) {
        const int q = nb * p.kc1 + kc;
        // this thread's copies of chunk q landed: NB groups follow each of
        // the first NB chunks (the x panels among them), NB - 1 later ones
        if (q < NB)
          cp_async_wait<NB>();
        else
          cp_async_wait<NB - 1>();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wd::named_barrier(1 + wg, WG);  // ... every thread's, visible to wgmma
        const unsigned char* buf = xb + (q % NB) * XBUF;
        const uint64_t da0 = wd::sw128_desc(buf, 16, 1024);
        const uint64_t da1 = wd::sw128_desc(buf + 64 * 128, 16, 1024);
        const uint64_t db = next_w();
        wd::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int acc = kc > 0 || kk > 0;
          wd::wgmma<64, 0, 1>(acc1[0], wd::desc_add(da0, 32 * kk),
                              wd::desc_add(db, 2048 * kk), acc);
          wd::wgmma<64, 0, 1>(acc1[1], wd::desc_add(da1, 32 * kk),
                              wd::desc_add(db, 2048 * kk), acc);
        }
        wd::wgmma_commit();
        wd::wgmma_wait<0>();
        wd::acc_fence(acc1[0]);
        wd::acc_fence(acc1[1]);
        done_w();
        wd::named_barrier(1 + wg, WG);  // every product that read the buffer is done
        if (q + NB < nq) stage_halo(xb + (q % NB) * XBUF, p, tl, (q + NB) % p.kc1, t);
        cp_async_commit();
      }
      if (nb == NF - 1) {
        // the x buffers are free: the next tile's first chunks land during
        // the epilogue, conv2 and conv3 (NB groups, empty without a next
        // tile)
        next = tile_of(p, pair + gridDim.x, wg);
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          if (q < nq) stage_halo(xb + q * XBUF, p, next, q % p.kc1, t);
          cp_async_commit();
        }
      }
      // the thread's 8 column pairs' scales and biases into registers
      // first (a load after a store through another pointer would wait for
      // it); then, per fragment row (4 a thread), its place in the frame
      float2 sc[8], bi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * 64 + wd::frag_col(t, 4 * j);
        sc[j] = *reinterpret_cast<const float2*>(sb1 + col);
        bi[j] = *reinterpret_cast<const float2*>(sb1 + F + col);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 64 + wd::frag_row(t, 2 * h);
          if (r >= M1) continue;
          const int gy = tl.ty0 - 1 + r / HWD, gx = tl.tx0 - 1 + r % HWD;
          const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
          unsigned char* row = y1 + nb * Y1P + r * 128;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int i = 4 * j + 2 * h, c = wd::frag_col(t, i);
            const float v0 = in ? fmaxf(fmaf(acc1[mt][i], sc[j].x, bi[j].x), 0.0f) : 0.0f;
            const float v1 = in ? fmaxf(fmaf(acc1[mt][i + 1], sc[j].y, bi[j].y), 0.0f) : 0.0f;
            *reinterpret_cast<uint32_t*>(row + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) =
                pack_bf16(v0, v1);
          }
        }
    }
    wd::named_barrier(1 + wg, WG);  // y1 is complete

    // ---- conv2: 3 x 3 SAME over y1; warp w computes output row w. A tap
    // reads y1 at a row offset the swizzle atom does not divide: A in
    // registers, by ldmatrix. Step s: tap s / NF, chunk s % NF. Unrolled at
    // F = 64 only: F = 128's 18 unrolled steps spilled. (Issuing a step
    // while the one before runs, A double-buffered, took more registers and
    // ran no faster on the H100.)
    float acc2[NF][32];
#pragma unroll (NF == 1 ? 9 : 1)
    for (int st = 0; st < 9 * NF; ++st) {
      const int tap = st / NF, kc = st % NF;
      uint32_t a[4][4];
      load_a(a, y1 + kc * Y1P, (warp + tap / 3) * HWD + tap % 3, lane);
      uint64_t db[NF];
#pragma unroll
      for (int nb = 0; nb < NF; ++nb) db[nb] = next_w();
      wd::wgmma_fence();
#pragma unroll
      for (int nb = 0; nb < NF; ++nb) mma_tile(acc2[nb], a, db[nb], st > 0);
      wd::wgmma_commit();
      wd::wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NF; ++nb) {
        wd::acc_fence(acc2[nb]);
        done_w();
      }
    }
    // conv3's first residual x in flight under the epilogue and its products
    uint32_t xr[16];
    if (!DS) load_residual(xr, p, tl, 0, t);
    // y2 = relu(s2 acc + b2) in bf16, straight into conv3's A fragments
    uint32_t y2a[NF][4][4];
#pragma unroll
    for (int nb = 0; nb < NF; ++nb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j, col = nb * 64 + wd::frag_col(t, i);
          const float2 s = *reinterpret_cast<const float2*>(sb2 + col);
          const float2 b = *reinterpret_cast<const float2*>(sb2 + F + col);
          y2a[nb][kk][j] = pack_bf16(fmaxf(fmaf(acc2[nb][i], s.x, b.x), 0.0f),
                                     fmaxf(fmaf(acc2[nb][i + 1], s.y, b.y), 0.0f));
        }

    // ---- conv3 (+ downsample) + residual + ReLU, 64 columns of O a pass
    if (DS) {
      cp_async_wait<NB>();  // the x panels (the next tile's NB groups may fly)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wd::named_barrier(1 + wg, WG);  // ... every thread's, visible to wgmma
    }
    // the thread's two fragment rows (pixels) of the output tile
    int64_t opix[2];
    bool ovalid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wd::frag_row(t, 2 * h);
      const int gy = tl.ty0 + r / TW, gx = tl.tx0 + r % TW;
      ovalid[h] = tl.valid && gy < p.H && gx < p.W;
      opix[h] = ((int64_t)tl.n * p.H + gy) * p.W + gx;
    }
    for (int nb3 = 0; nb3 < p.no; ++nb3) {
      float acc3[32], accd[32];
#pragma unroll
      for (int kc = 0; kc < NF; ++kc) {
        const uint64_t db = next_w();
        wd::wgmma_fence();
        mma_tile(acc3, y2a[kc], db, kc > 0);
        mma_done(acc3);
        done_w();
      }
      if (DS) {  // A: the unshifted x panels, K-major from shared memory
        for (int kc = 0; kc < p.kc1; ++kc) {
          const uint64_t da = wd::sw128_desc(xc + kc * ATOM, 16, 1024);
          const uint64_t db = next_w();
          wd::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wd::wgmma<64, 0, 1>(accd, wd::desc_add(da, 32 * kk),
                                wd::desc_add(db, 2048 * kk), kc > 0 || kk > 0);
          mma_done(accd);
          done_w();
        }
      }
      // out = relu(s3 acc + b3 + res), bf16 pairs straight from the
      // accumulators (staging the tile in shared memory for 16-byte stores
      // ran no faster on the H100)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ovalid[h]) continue;
        bf16* orow = p.out + opix[h] * p.O;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * h, col = nb3 * 64 + wd::frag_col(t, i);
          if (col >= p.O) continue;
          // the scales from shared memory here: held in registers for the
          // whole pass, they made F = 128 spill
          const float2 s3 = *reinterpret_cast<const float2*>(sb3 + col);
          const float2 b3 = *reinterpret_cast<const float2*>(sb3 + p.O + col);
          float2 res;
          if (DS) {
            const float2 sd = *reinterpret_cast<const float2*>(sbd + col);
            const float2 bd = *reinterpret_cast<const float2*>(sbd + p.O + col);
            res = make_float2(fmaf(accd[i], sd.x, bd.x), fmaf(accd[i + 1], sd.y, bd.y));
          } else {
            res = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[i / 2]));
          }
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(fmaxf(fmaf(acc3[i], s3.x, b3.x) + res.x, 0.0f),
                        fmaxf(fmaf(acc3[i + 1], s3.y, b3.y) + res.y, 0.0f));
        }
      }
      // the next pass's residual x, in flight under its products
      if (!DS && nb3 + 1 < p.no) load_residual(xr, p, tl, nb3 + 1, t);
    }
    tl = next;
  }
}

// a 2-D map of a row-major (rows, cols) bf16 weight: 64 x 64 boxes
bool weight_map(CUtensorMap* map, const void* w, int rows, int cols) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, 64};
  return wd::make_map(map, w, 2, dims, strides, box);
}

int sm_count(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

template <int NF, bool DS>
int launch(const void* const (&w)[4], const FusedArgs& p, int device,
           cudaStream_t stream) {
  constexpr int F = 64 * NF;
  CUtensorMap maps[4];
  if (!weight_map(&maps[0], w[0], p.C, F) || !weight_map(&maps[1], w[1], 9 * F, F) ||
      !weight_map(&maps[2], w[2], F, p.O) ||
      !(DS ? weight_map(&maps[3], w[3], p.C, p.O) : weight_map(&maps[3], w[2], F, p.O)))
    return (int)cudaErrorInvalidValue;
  const int smem = fused_smem(NF, p.O, DS);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_kernel<NF, DS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min(p.pairs, sm_count(device));
  fused_bottleneck_kernel<NF, DS><<<grid, NT, smem, stream>>>(maps[0], maps[1],
                                                              maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory the kernel takes for (C, F, O, a downsample),
// or 0 where it does not take the shape (F other than 64 and 128, or a
// downsample over more than 128 channels, whose unshifted x panels would not
// fit their buffer): the route's rule, which the wrapper
// (fused_block.py: wgmma_route, wgmma_smem) follows.
extern "C" int wd_fused_bottleneck_smem(int C, int F, int O, int ds) {
  if ((F != 64 && F != 128) || (ds && (C + 63) / 64 * ATOM > XCBUF)) return 0;
  const int smem = fused_smem(F / 64, O, ds != 0);
  return smem <= SMEM_MAX ? smem : 0;
}

// x (NF, H, W, C) bf16; w1 (C, F), w2 (9F, F) = HWIO (3,3,F,F) flattened,
// w3 (F, O), wd (C, O) or null (then C == O): bf16. sb*: (2, ch) fp32
// [scale; bias]. out (NF, H, W, O) bf16. T = frames per clip (1 when
// fold == 0). C % 8 == 0, O % 16 == 0, fold % 8 == 0, and (C, F, wd) with
// wd_fused_bottleneck_smem > 0 (else cudaErrorInvalidValue).
extern "C" int wd_fused_bottleneck_bf16(
    const void* x, const void* w1, const void* sb1, const void* w2,
    const void* sb2, const void* w3, const void* sb3, const void* wd,
    const void* sbd, void* out, int NF, int H, int W, int C, int F, int O,
    int T, int fold, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (NF == 0) return 0;
  if (wd_fused_bottleneck_smem(C, F, O, wd != nullptr) == 0 || C % 8 || O % 16 ||
      fold % 8 || T < 1)
    return (int)cudaErrorInvalidValue;
  FusedArgs p;
  p.x = (const bf16*)x;
  p.out = (bf16*)out;
  p.sb1 = (const float*)sb1;
  p.sb2 = (const float*)sb2;
  p.sb3 = (const float*)sb3;
  p.sbd = (const float*)sbd;
  p.H = H;
  p.W = W;
  p.C = C;
  p.O = O;
  p.T = T;
  p.fold = fold;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_per_frame = p.tiles_x * ((H + TH - 1) / TH);
  const int64_t tiles = (int64_t)NF * p.tiles_per_frame;
  if (tiles > INT32_MAX - 1) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.pairs = (p.tiles + 1) / 2;
  p.kc1 = (C + 63) / 64;
  p.no = (O + 63) / 64;
  p.ds = wd != nullptr;
  const void* const w[4] = {w1, w2, w3, wd};
  cudaStream_t s = (cudaStream_t)stream;
  if (F == 64)
    return p.ds ? launch<1, true>(w, p, device, s) : launch<1, false>(w, p, device, s);
  return p.ds ? launch<2, true>(w, p, device, s) : launch<2, false>(w, p, device, s);
}
