// Kernel K2: the banded delay-grid spread of the NUFFT engine, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel prisim_tpu/engine/nufft_banded.py::_sweep_kernel
// (launched by _banded_spread). It computes what the plain version
// engine/nufft_banded.py::banded_spread_plain computes: for baseline b of
// direction d = d_of_b[b] and every source s of d's stream,
//   t = |b| u_ds, phi = t/(c h)             (two-float),
//   m0 = rint(phi.h) (half to even),  z0 = (phi.h - m0) + phi.l   (f64),
//   carrier e^{-2 pi i nu_mid t / c}         (f64 sincospi of the
//                                             frac-reduced two-float cycles),
//   w_j(z0), j < K                            (f64 Horner on tap_w),
// and a valid source (u.h < 2.5; pads sit at u = 3) whose first-tap row
// f = m0 - K/2 - blk_lo[b] G_blk lies in [0, n_blk[b] G_blk) adds
// w_j [P_k cos, -P_k sin] (k < r) to row f + j of b's (R_max, 2r) rows.
// A source whose payload column is all zero adds exact zeros and is
// skipped (below the horizon the beam, and with it the payload, is 0).
// Everything after the two-float bin is float64, and the rows are summed
// in float64 and added into the caller's float64 rows, so that a
// snapshot's chunks accumulate in one array.
//
// What bounds it: float64 operations. The useful work is 2r (2K + 1)
// of them per valid (baseline, source) pair (the K taps' products, an FMA
// counted as 2, and the carrier), plus K Horner chains, a sincospi and a
// two-float bin per pair. At the north star (247,726,080 valid pairs per
// snapshot, r = 32, K = 9) that is 4.5 ms at the FP64 tensor-core peak
// (67 TFLOP/s) and 8.9 ms at the vector peak (34 TFLOP/s). What the
// earlier output-stationary design lost (339.6 ms per north-star snapshot
// on an H100 80GB HBM3 at 700 W; per output block of 32 rows: a serial
// scan of every tile of the stream, the setup of every tile's sources
// repeated in every row block it reached, a dense 32-row window of which 9
// rows are nonzero, and 9 shared loads per 8 FMAs) and what this design
// does about it:
//
// 1. A worklist built on the device. Pass 1 takes [min, max] of u over the
//    live sources of each (direction, tile of 128 sources), one warp per
//    tile; pass 2 counts, for each item (baseline, block of 64 rows), the
//    tiles whose conservative first-tap row span reaches it (one warp per
//    item, 32 tiles per ballot); an exclusive scan (a torch op) gives the
//    offsets; pass 3 fills each item's list in tile order. The spread walks
//    only its list; items run in the order the wrapper gives (most work
//    first), and only the live items (those with a tile) get a block: the
//    grid is n_live x column blocks x splits, not every item, so a chunk
//    whose sources reach few rows (or, below the horizon, none: then the
//    wrapper launches nothing) costs blocks only where it adds something.
//    Where the live items cannot fill the card (the HERA-37 slice: 156 of
//    them), the wrapper splits each list among up to 8 blocks (grid z),
//    each writing float64 partial rows of its item into scratch sized to
//    the live items; k2_split_sum_kernel then sums them in split order
//    and adds the sum into the rows.
// 2. Setup once per (item, source): a block (4 warps) owns 64 rows x 64
//    columns, the taller tile, so a source's bin, carrier and taps are
//    computed once for every row they reach in the item. The K taps of the
//    hits run across threads, one 12-FMA Horner chain per (hit, tap), not
//    one chain of K x 12 FMAs per source: a thread keeps one tap's
//    coefficients in registers and runs four hits' chains at once.
// 3. Asynchronous loads: a 2-stage ring in shared memory. One thread
//    issues, a stage ahead, four bulk asynchronous copies (cp.async.bulk,
//    the TMA's 1-D form) of the next live tile: its payload slab (r rows of
//    kPitch doubles, one contiguous block of the wrapper's tile-major
//    payload, the pad keeping the MMA's B loads off each other's banks),
//    its u_h/u_l and its live flags, completing on the stage's mbarrier;
//    the threads wait on its phase. The loads overlap the previous tile's
//    setup and products.
// 4. The product on the FP64 tensor cores: rows += window . (P o carrier)
//    with mma.sync m16n8k8 f64 (sm_90). The hits of a tile are compacted
//    in source order, and for each of the 4 row tiles of 16 rows the hits
//    that put a tap in it (a hit reaches one or two) are listed in source
//    order, so a k-step of 8 hits feeds only the row tile they reach: at
//    9 taps in 16 rows, about half the window is nonzero, against a
//    quarter when every chunk of hits met every row tile it touched. A
//    warp owns 16 columns (2 n-tiles of 8) of all 4 row tiles. A row
//    tile's consecutive k-steps go to two accumulator sets in turn, added
//    at the end, so that back-to-back products do not wait on each
//    other's results. The window's A fragment is read from the hits'
//    taps, zero outside them; the payload's B fragment is P times the
//    carrier.
// 5. Accumulation and determinism: the epilogue is a read-modify-write,
//    rows[v] = rows[v] + (acc0 + acc1), the float64 operations of a dense
//    write followed by an add, in the same order; the items without a
//    tile leave their rows as they were. Every output value (or partial
//    value, with splits) has one writer, summed in the order of its list
//    and of the hits within a tile (data order), the two accumulator sets
//    and then the splits added in split order (by the second kernel) before
//    the sum meets the rows; no atomics.
//
// With PRISIM_PHASE_CLOCKS defined, thread 0 of every block adds clock64()
// deltas per phase into a device array (read by prisim_phase_clocks).
//
// Build without --use_fast_math: rintf and sincospi must stay the
// IEEE-accurate library versions, and twofloat.cuh pins the compensated
// arithmetic against FMA contraction.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "twofloat.cuh"

using prisim::df;

namespace {

constexpr int kThreads = 128;                       // threads per spread block
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 64;                             // rows per item
constexpr int kRowTiles = kRB / 16;                 // m16 row tiles
constexpr int kCols = 64;                           // columns per block
constexpr int kST = 128;                            // sources per tile
constexpr int kStages = 2;                          // copy ring depth
// Row pitch of a tile's payload slab, in doubles: 2 more than a tile, so
// that the 8 rows a warp reads at once (one per MMA column) start 4 banks
// apart in shared memory and a load takes 2 wavefronts, not 8. The wrapper
// lays the payload out tile by tile with this pitch (zeros in the pad), so
// that a slab is one contiguous copy.
constexpr int kPitch = kST + 2;
constexpr int kMaxK = 15;                           // taps
constexpr int kMaxCoef = 16;                        // polynomial degree + 1
constexpr float kPadU = 2.5f;                       // u >= this: a pad
constexpr int kFarQ = -(1 << 20);                   // the zero hit's row
constexpr int kHitSlots = kST + 8;                  // hits, the zero hit at kST

#ifdef PRISIM_PHASE_CLOCKS
__device__ unsigned long long g_phase_clk[8];
#define PHASE_START() long long phase_t0 = clock64()
#define PHASE_MARK(i)                                                    \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      const long long phase_t1 = clock64();                              \
      atomicAdd(&g_phase_clk[i],                                         \
                static_cast<unsigned long long>(phase_t1 - phase_t0));   \
      phase_t0 = phase_t1;                                               \
    }                                                                    \
  } while (0)
#else
#define PHASE_START() \
  do {                \
  } while (0)
#define PHASE_MARK(i) \
  do {                \
  } while (0)
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Bulk asynchronous copy global -> shared of `bytes` (a multiple of 16,
// both addresses 16-byte aligned), completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// d += a . b for one m16n8k8 float64 tile (sm_90): A 16 x 8 (a0 row g,
// a1 row g + 8 at column t; a2, a3 the same rows at column t + 4), B 8 x 8
// (b0 row t, b1 row t + 4, column g), D 16 x 8 (d0, d1 row g, columns 2t,
// 2t + 1; d2, d3 row g + 8); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_f64_k8(double (&d)[4], double a0,
                                           double a1, double a2, double a3,
                                           double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// The conservative first-tap row span of a tile, relative to the owned
// range's base: phi is monotone in u (|b| > 0); rint moves a row by at
// most one and u.l by far less. Returns false for a tile with no live
// source.
__device__ __forceinline__ bool tile_rows(float2 ur, double blen64,
                                          double inv_ch, int half, int base,
                                          double* lo, double* hi) {
  if (!(ur.x <= ur.y)) return false;
  *lo = floor(blen64 * ur.x * inv_ch) - 2.0 - half - base;
  *hi = ceil(blen64 * ur.y * inv_ch) + 2.0 - half - base;
  return true;
}

// Pass 1: [min, max] of u.h over the live sources (u.h < 2.5 and a
// nonzero payload) of each (direction, tile of kST sources); (inf, -inf)
// when the tile has none. One warp per tile: each lane reads 4 sources
// (one 16-byte load of u, one 4-byte load of flags), then a shuffle
// reduction. S is a multiple of kST.
constexpr int kUrangeWarps = 8;
static_assert(kST == 4 * 32, "tile_urange_kernel reads 4 sources a lane");

__global__ void __launch_bounds__(32 * kUrangeWarps)
tile_urange_kernel(const float* __restrict__ u_h,
                   const uint8_t* __restrict__ live, float2* __restrict__ urange,
                   int S, int n_tiles) {
  const int d = blockIdx.y;
  const int tile = blockIdx.x * kUrangeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (tile >= n_tiles) return;
  const int s = tile * kST + 4 * lane;
  const float4 u = *reinterpret_cast<const float4*>(
      u_h + static_cast<size_t>(d) * S + s);
  const uchar4 f = *reinterpret_cast<const uchar4*>(live + s);
  const float us[4] = {u.x, u.y, u.z, u.w};
  const bool ok[4] = {f.x != 0, f.y != 0, f.z != 0, f.w != 0};
  float lo = INFINITY;
  float hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (ok[i] && us[i] < kPadU) {
      lo = fminf(lo, us[i]);
      hi = fmaxf(hi, us[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    urange[static_cast<size_t>(d) * n_tiles + tile] = make_float2(lo, hi);
  }
}

// Passes 2 and 3: one warp per item (b, row block rb); `fill` false
// counts the tiles that reach the item, true writes them in tile order at
// offsets[item].
__global__ void __launch_bounds__(256)
worklist_kernel(const float2* __restrict__ urange,
                const float* __restrict__ blen_h, const float* __restrict__ blen_l,
                const int* __restrict__ d_of_b, const int* __restrict__ blk_lo,
                const int* __restrict__ n_blk, int* __restrict__ counts,
                const int* __restrict__ offsets, int* __restrict__ tiles,
                int B, int n_rb, int n_tiles, int K, int G_blk, double inv_ch,
                bool fill) {
  const int item = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (item >= B * n_rb) return;
  const int b = item / n_rb;
  const int R0 = (item - b * n_rb) * kRB;
  const int d = d_of_b[b];
  const int half = K / 2;
  const int base = blk_lo[b] * G_blk;
  const int own_hi = n_blk[b] * G_blk;
  const double blen64 = static_cast<double>(blen_h[b]) + blen_l[b];
  int n = 0;
  int at = fill ? offsets[item] : 0;
  // first-tap rows that reach this item: [R0 - K + 1, R0 + kRB - 1]
  if (R0 < own_hi + K - 1) {
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int tile = t0 + lane;
      bool reach = false;
      double lo, hi;
      if (tile < n_tiles &&
          tile_rows(urange[static_cast<size_t>(d) * n_tiles + tile], blen64,
                    inv_ch, half, base, &lo, &hi)) {
        reach = hi >= R0 - K + 1 && lo <= R0 + kRB - 1;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, reach);
      if (fill && reach) {
        tiles[at + __popc(ballot & ((1u << lane) - 1u))] = tile;
      }
      at += __popc(ballot);
      n += __popc(ballot);
    }
  }
  if (!fill && lane == 0) counts[item] = n;
}

// Bytes of one ring stage at rank r, all of them copied: the P slab (r
// rows of kPitch doubles), u_h, u_l, live flags.
__host__ __device__ constexpr size_t stage_bytes(int r) {
  return static_cast<size_t>(r) * kPitch * sizeof(double) +
         2 * kST * sizeof(float) + kST;
}

size_t k2_smem(int r, int K) {
  return kStages * stage_bytes(r) +
         static_cast<size_t>(kST) * K * sizeof(double) +          // taps
         kHitSlots * (sizeof(double) + sizeof(double2) +          // z0, car
                      2 * sizeof(int)) +                          // src, q
         kRowTiles * kST * sizeof(int) +                          // row lists
         kStages * sizeof(uint64_t);
}

__global__ void __launch_bounds__(kThreads)
banded_k2_kernel(const float* __restrict__ u_h, const float* __restrict__ u_l,
                 const double* __restrict__ P_t,
                 const uint8_t* __restrict__ live,
                 const float* __restrict__ blen_h,
                 const float* __restrict__ blen_l,
                 const int* __restrict__ d_of_b,
                 const int* __restrict__ blk_lo, const int* __restrict__ n_blk,
                 const double* __restrict__ tap_w,
                 const int* __restrict__ order, const int* __restrict__ counts,
                 const int* __restrict__ offsets,
                 const int* __restrict__ tiles, double* __restrict__ rows,
                 double* __restrict__ partial, int S, int B, int n_rb,
                 int R_max, int r, int K, int ncoef, int G_blk, float ivh,
                 float ivl, float nmh, float nml) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t sbytes = stage_bytes(r);
  unsigned char* stage0 = smem;
  double* wtab = reinterpret_cast<double*>(smem + kStages * sbytes);  // [kST][K]
  double* hit_z0 = wtab + kST * K;                               // [kHitSlots]
  double2* hit_car = reinterpret_cast<double2*>(hit_z0 + kHitSlots);
  int* hit_src = reinterpret_cast<int*>(hit_car + kHitSlots);    // [kHitSlots]
  int* hit_q = hit_src + kHitSlots;                              // [kHitSlots]
  int* rt_list = hit_q + kHitSlots;                      // [kRowTiles][kST]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rt_list + kRowTiles * kST);
  __shared__ double taps[kMaxK * kMaxCoef];
  __shared__ int warp_hits[1 + kRowTiles][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int item = order[blockIdx.x];
  const int b = item / n_rb;
  const int R0 = (item - b * n_rb) * kRB;
  // this block's share (split blockIdx.z of gridDim.z) of the item's list
  const int n_all = counts[item];
  const int per = (n_all + gridDim.z - 1) / gridDim.z;
  const int l0 = min(n_all, static_cast<int>(blockIdx.z) * per);
  const int n_list = min(n_all, l0 + per) - l0;
  const int* list = tiles + offsets[item] + l0;
  const int d = d_of_b[b];
  const int half = K / 2;
  const int base = blk_lo[b] * G_blk;
  const int own_hi = n_blk[b] * G_blk;     // owned first-tap rows [0, own_hi)
  const df blen = {blen_h[b], blen_l[b]};
  const df ivc = {ivh, ivl};
  const df nmc = {nmh, nml};
  const int two_r = 2 * r;
  const int per_k = kThreads / K;          // hits a round of the taps covers
  const int tap_j = tid % K;               // this thread's tap
  PHASE_START();

  // this warp's two n-tiles: B column g of each, payload row kc, sign
  int kc[2];
  bool cos_col[2], col_ok[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = blockIdx.y * kCols + warp * 16 + nt * 8 + g;
    col_ok[nt] = col < two_r;
    cos_col[nt] = col < r;
    kc[nt] = col_ok[nt] ? (col < r ? col : col - r) : 0;
  }
  // two accumulator sets: a row tile's consecutive k-steps alternate
  // between them, so that back-to-back products do not wait on each other
  double acc[2][kRowTiles][2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int rt = 0; rt < kRowTiles; ++rt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][rt][nt][e] = 0.0;
      }
    }
  }

  for (int i = tid; i < K * ncoef; i += kThreads) taps[i] = tap_w[i];
  const uint32_t tx_bytes = static_cast<uint32_t>(sbytes);
  const size_t slab = static_cast<size_t>(r) * kPitch;   // doubles
  auto issue = [&](int li) {               // thread 0: tile list[li]
    unsigned char* st = stage0 + (li % kStages) * sbytes;
    uint64_t* bar = bars + li % kStages;
    const size_t s0 = static_cast<size_t>(list[li]) * kST;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_expect_tx(bar, tx_bytes);
    bulk_g2s(st, P_t + list[li] * slab, slab * sizeof(double), bar);
    unsigned char* tail = st + slab * sizeof(double);
    bulk_g2s(tail, u_h + static_cast<size_t>(d) * S + s0, kST * sizeof(float),
             bar);
    bulk_g2s(tail + kST * sizeof(float), u_l + static_cast<size_t>(d) * S + s0,
             kST * sizeof(float), bar);
    bulk_g2s(tail + 2 * kST * sizeof(float), live + s0, kST, bar);
  };
  if (tid == 0) {
    hit_src[kST] = 0;                      // the zero hit: no taps, no payload
    hit_q[kST] = kFarQ;
    hit_car[kST] = make_double2(0.0, 0.0);
    for (int st = 0; st < kStages; ++st) bar_init(bars + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int li = 0; li < kStages && li < n_list; ++li) issue(li);
  }
  __syncthreads();
  PHASE_MARK(0);

  for (int li = 0; li < n_list; ++li) {
    const unsigned char* st = stage0 + (li % kStages) * sbytes;
    const double* Ps = reinterpret_cast<const double*>(st);        // [r][kPitch]
    const float* uhs = reinterpret_cast<const float*>(
        st + static_cast<size_t>(r) * kPitch * sizeof(double));
    const float* uls = uhs + kST;
    const uint8_t* lvs = reinterpret_cast<const uint8_t*>(uls + kST);
    while (!bar_try_wait(bars + li % kStages, (li / kStages) & 1)) {
    }
    PHASE_MARK(1);

    // A. bin of each source; compact the hits in source order
    df t = {0.f, 0.f};
    df ph = {0.f, 0.f};
    float m0 = 0.f;
    int q = 0;
    bool hit = false;
    const float uh = uhs[tid];
    if (lvs[tid] && uh < kPadU) {
      const df u = {uh, uls[tid]};
      t = prisim::df_mul(blen, u);
      ph = prisim::df_mul(t, ivc);
      m0 = rintf(ph.h);
      const int first = static_cast<int>(m0) - half - base;
      q = first - R0;
      hit = first >= 0 && first < own_hi && q > -K && q < kRB;
    }
    // the hits in source order, and for each row tile the hits that put
    // a tap in it (a hit reaches one or two), in source order
    const unsigned below = (1u << lane) - 1u;
    unsigned ballots[1 + kRowTiles];
    ballots[0] = __ballot_sync(0xffffffffu, hit);
#pragma unroll
    for (int rt = 0; rt < kRowTiles; ++rt) {
      ballots[1 + rt] = __ballot_sync(
          0xffffffffu, hit && q <= 16 * rt + 15 && q + K - 1 >= 16 * rt);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i <= kRowTiles; ++i) warp_hits[i][warp] = __popc(ballots[i]);
    }
    __syncthreads();
    int at[1 + kRowTiles], n_in[1 + kRowTiles];
#pragma unroll
    for (int i = 0; i <= kRowTiles; ++i) {
      at[i] = 0;
      n_in[i] = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) at[i] += warp_hits[i][w];
        n_in[i] += warp_hits[i][w];
      }
      at[i] += __popc(ballots[i] & below);
    }
    if (hit) {
      const int idx = at[0];
      hit_src[idx] = tid;
      hit_q[idx] = q;
      hit_z0[idx] = static_cast<double>(__fsub_rn(ph.h, m0)) + ph.l;
      hit_car[idx] = prisim::phasor64(prisim::df_frac(prisim::df_mul(t, nmc)));
#pragma unroll
      for (int rt = 0; rt < kRowTiles; ++rt) {
        if (ballots[1 + rt] >> lane & 1u) rt_list[rt * kST + at[1 + rt]] = idx;
      }
    }
    const int n_hit = n_in[0];
    int n_rt[kRowTiles];                          // padded to k-steps of 8
#pragma unroll
    for (int rt = 0; rt < kRowTiles; ++rt) {
      n_rt[rt] = (n_in[1 + rt] + 7) & ~7;
      if (tid >= n_in[1 + rt] && tid < n_rt[rt]) rt_list[rt * kST + tid] = kST;
    }
    __syncthreads();
    PHASE_MARK(2);

    // B. the taps of every hit, one Horner chain per (hit, tap): thread t
    // evaluates tap j = t % K, its coefficients in registers, for hits
    // t / K, t / K + per, ..., four independent chains at a time
    if (tid < per_k * K) {
      double co[kMaxCoef];
#pragma unroll
      for (int c = 0; c < kMaxCoef; ++c) {
        co[c] = c < ncoef ? taps[tap_j * ncoef + c] : 0.0;
      }
      for (int h0 = tid / K; h0 < n_hit; h0 += 4 * per_k) {
        double w[4], z[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          z[u] = hit_z0[min(h0 + u * per_k, n_hit - 1)];
          w[u] = co[0];
        }
#pragma unroll
        for (int c = 1; c < kMaxCoef; ++c) {
          if (c < ncoef) {
#pragma unroll
            for (int u = 0; u < 4; ++u) w[u] = fma(w[u], z[u], co[c]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (h0 + u * per_k < n_hit) wtab[(h0 + u * per_k) * K + tap_j] = w[u];
        }
      }
    }
    __syncthreads();
    PHASE_MARK(3);

    // C. rows += window . (P o carrier) on the FP64 tensor cores, row
    // tile by row tile over the hits that reach it: one m16n8k8 k-step of
    // 8 hits at a time, consecutive k-steps into the two accumulator sets;
    // this lane holds hits tg and tg + 4 of each k-step
#pragma unroll
    for (int rt = 0; rt < kRowTiles; ++rt) {
      const int* lst = rt_list + rt * kST;
      for (int c0 = 0; c0 < n_rt[rt]; c0 += 16) {
        const bool two = c0 + 8 < n_rt[rt];      // warp-uniform
        double a[4][2], bf[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int h = (u < 2 || two) ? lst[c0 + 4 * u + tg] : kST;
          const int hq = hit_q[h];
          const int hs = hit_src[h];
          const double2 car = hit_car[h];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            bf[u][nt] = col_ok[nt] ? Ps[kc[nt] * kPitch + hs] *
                                         (cos_col[nt] ? car.x : car.y)
                                   : 0.0;
          }
          const int j0 = 16 * rt + g - hq;        // tap of row g, row g + 8
          const int j1 = j0 + 8;
          a[u][0] = (j0 >= 0 && j0 < K) ? wtab[h * K + j0] : 0.0;
          a[u][1] = (j1 >= 0 && j1 < K) ? wtab[h * K + j1] : 0.0;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_f64_k8(acc[0][rt][nt], a[0][0], a[0][1], a[1][0], a[1][1],
                     bf[0][nt], bf[1][nt]);
        }
        if (two) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma_f64_k8(acc[1][rt][nt], a[2][0], a[2][1], a[3][0], a[3][1],
                       bf[2][nt], bf[3][nt]);
          }
        }
      }
    }
    __syncthreads();                       // this stage and the hits consumed
    PHASE_MARK(4);
    if (tid == 0 && li + kStages < n_list) issue(li + kStages);
  }

  // one split: added into the caller's rows; with splits: this split's
  // partial rows of the item (live slot blockIdx.x), which
  // k2_split_sum_kernel adds in split order
  const bool split = gridDim.z > 1;
  double* dst = split ? partial : rows;
  const size_t row0 =
      split ? (static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) * kRB
            : static_cast<size_t>(b) * R_max + R0;
#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = blockIdx.y * kCols + warp * 16 + nt * 8 + 2 * tg;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = R0 + 16 * rt + g + (e >= 2 ? 8 : 0);
        const int cc = col + (e & 1);
        if (row < R_max && cc < two_r) {
          double* v = dst + (row0 + (row - R0)) * two_r + cc;
          const double sum = acc[0][rt][nt][e] + acc[1][rt][nt][e];
          *v = split ? sum : *v + sum;
        }
      }
    }
  }
  PHASE_MARK(5);
}

// The splits' partial rows (n_split, n_live, kRB, 2r) of the live items
// (slot i holds item order[i]) summed in split order and added into rows
// (B, R_max, 2r): one thread per (slot, row, column).
__global__ void __launch_bounds__(256)
k2_split_sum_kernel(const double* __restrict__ partial,
                    const int* __restrict__ order, double* __restrict__ rows,
                    int n_live, int n_split, int n_rb, int R_max, int two_r) {
  const size_t per = static_cast<size_t>(kRB) * two_r;
  const size_t n = static_cast<size_t>(n_live) * per;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int slot = static_cast<int>(i / per);
    const int rem = static_cast<int>(i - slot * per);
    const int item = order[slot];
    const int b = item / n_rb;
    const int row = (item - b * n_rb) * kRB + rem / two_r;
    if (row >= R_max) continue;
    double sum = partial[i];
    for (int z = 1; z < n_split; ++z) sum = sum + partial[z * n + i];
    double* v = rows + (static_cast<size_t>(b) * R_max + row) * two_r +
                rem % two_r;
    *v = *v + sum;
  }
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes of one spread block at rank r with K taps.
size_t prisim_banded_k2_smem(int r, int K) { return k2_smem(r, K); }

// Rows per item and sources per tile of the worklist; doubles per payload
// row of a tile in P_t.
int prisim_banded_k2_rows_per_item() { return kRB; }
int prisim_banded_k2_tile() { return kST; }
int prisim_banded_k2_pitch() { return kPitch; }

// Worklist passes 1 and 2 on `stream`: urange float32 (D, n_tiles, 2)
// scratch, counts int32 (B * n_rb,) of tiles per item (b, rb), rb the
// block of kRB rows. u_h float32 (D, S), live uint8 (S,), S a multiple of
// the tile. Returns the cudaError_t of the launches.
int prisim_banded_k2_count(const void* u_h, const void* live, const void* blen_h,
                           const void* blen_l, const void* d_of_b,
                           const void* blk_lo, const void* n_blk, void* urange,
                           void* counts, int D, int S, int B, int n_rb, int K,
                           int G_blk, double inv_ch, void* stream) {
  const int n_tiles = S / kST;
  if (D < 1 || S < kST || S % kST || B < 1 || n_rb < 1 || D > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tile_urange_kernel<<<dim3((n_tiles + kUrangeWarps - 1) / kUrangeWarps, D),
                       32 * kUrangeWarps, 0, st>>>(
      static_cast<const float*>(u_h), static_cast<const uint8_t*>(live),
      static_cast<float2*>(urange), S, n_tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_items = B * n_rb;
  worklist_kernel<<<(n_items + 7) / 8, 256, 0, st>>>(
      static_cast<const float2*>(urange), static_cast<const float*>(blen_h),
      static_cast<const float*>(blen_l), static_cast<const int*>(d_of_b),
      static_cast<const int*>(blk_lo), static_cast<const int*>(n_blk),
      static_cast<int*>(counts), nullptr, nullptr, B, n_rb, n_tiles, K, G_blk,
      inv_ch, false);
  return static_cast<int>(cudaGetLastError());
}

// Worklist pass 3: tiles int32 (sum of counts,) filled at the exclusive
// scan `offsets` of the counts, each item's tiles in increasing order.
int prisim_banded_k2_fill(const void* urange, const void* blen_h,
                          const void* blen_l, const void* d_of_b,
                          const void* blk_lo, const void* n_blk,
                          const void* offsets, void* tiles, int S, int B,
                          int n_rb, int K, int G_blk, double inv_ch,
                          void* stream) {
  if (S < kST || S % kST || B < 1 || n_rb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_items = B * n_rb;
  worklist_kernel<<<(n_items + 7) / 8, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(urange), static_cast<const float*>(blen_h),
      static_cast<const float*>(blen_l), static_cast<const int*>(d_of_b),
      static_cast<const int*>(blk_lo), static_cast<const int*>(n_blk), nullptr,
      static_cast<const int*>(offsets), static_cast<int*>(tiles), B, n_rb,
      S / kST, K, G_blk, inv_ch, true);
  return static_cast<int>(cudaGetLastError());
}

// Spread blocks of rank r with K taps that fit on one SM at once (0 on an
// error).
int prisim_banded_k2_blocks_per_sm(int r, int K) {
  const size_t smem = k2_smem(r, K);
  if (cudaFuncSetAttribute(banded_k2_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, banded_k2_kernel, kThreads, smem) != cudaSuccess) {
    return 0;
  }
  return n;
}

// The spread on `stream`, added into `rows`: one block per live item, in
// `order` (B * n_rb item indices, the n_live items with a tile first), per
// 64 columns of the 2r and per split: split z of n_split takes the z-th
// share of the item's list. Device pointers: u_h/u_l float32 (D, S)
// direction streams; P_t float64 (S / 128, r, pitch) the payload tile by
// tile (prisim_banded_k2_pitch doubles a row, zeros past the tile's 128);
// live uint8 (S,); blen_h/blen_l float32 (B,); d_of_b, blk_lo, n_blk int32
// (B,); tap_w float64 (K, ncoef); counts/offsets/tiles the worklist; rows
// float64 (B, R_max, 2r), to which each live item's rows are added (the
// rows of items without a tile are not touched); with n_split > 1,
// partial float64 (n_split, n_live, 64, 2r) scratch for the splits'
// partial rows, summed in split order by a second launch before they are
// added (null with one split). Returns the cudaError_t.
int prisim_banded_k2(const void* u_h, const void* u_l, const void* P_t,
                     const void* live, const void* blen_h, const void* blen_l,
                     const void* d_of_b, const void* blk_lo,
                     const void* n_blk, const void* tap_w, const void* order,
                     const void* counts, const void* offsets,
                     const void* tiles, void* rows, void* partial, int S,
                     int B, int R_max, int r, int K, int ncoef, int G_blk,
                     float ivh, float ivl, float nmh, float nml, int n_live,
                     int n_split, void* stream) {
  const int n_rb = (R_max + kRB - 1) / kRB;
  if (S < kST || S % kST || B < 1 || R_max < 1 || r < 1 || K < 1 ||
      K > kMaxK || (K & 1) == 0 || ncoef < 1 || ncoef > kMaxCoef ||
      G_blk < 1 || (2 * r + kCols - 1) / kCols > 65535 || n_split < 1 ||
      n_split > 65535 || n_live < 1 || n_live > B * n_rb ||
      (n_split > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = k2_smem(r, K);
  cudaError_t e = cudaFuncSetAttribute(
      banded_k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_live, (2 * r + kCols - 1) / kCols, n_split);
  banded_k2_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(u_h), static_cast<const float*>(u_l),
      static_cast<const double*>(P_t), static_cast<const uint8_t*>(live),
      static_cast<const float*>(blen_h), static_cast<const float*>(blen_l),
      static_cast<const int*>(d_of_b), static_cast<const int*>(blk_lo),
      static_cast<const int*>(n_blk), static_cast<const double*>(tap_w),
      static_cast<const int*>(order), static_cast<const int*>(counts),
      static_cast<const int*>(offsets), static_cast<const int*>(tiles),
      static_cast<double*>(rows), static_cast<double*>(partial), S, B, n_rb,
      R_max, r, K, ncoef, G_blk, ivh, ivl, nmh, nml);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(n_live) * kRB * 2 * r;
  const unsigned blocks =
      static_cast<unsigned>(n / 256 + 1 < 65535 ? n / 256 + 1 : 65535);
  k2_split_sum_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const double*>(partial), static_cast<const int*>(order),
      static_cast<double*>(rows), n_live, n_split, n_rb, R_max, 2 * r);
  return static_cast<int>(cudaGetLastError());
}

#ifdef PRISIM_PHASE_CLOCKS
// Copy the 8 phase clock sums to `host` and zero them.
int prisim_phase_clocks(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase_clk, sizeof(g_phase_clk));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clk, zero, sizeof(zero)));
}
#endif

}  // extern "C"
