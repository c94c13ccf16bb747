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
// Everything after the two-float bin is float64, and the rows are summed
// and returned in float64: the TPU kernel's f32 MXU dot needed Kahan
// carries and dot_split, which have no role here.
//
// Design: output-stationary. A block owns kRows = 32 rows x kCols = 64
// columns of one baseline's rows and walks that baseline's whole source
// stream in tiles of kST = 128 sources; every output value has exactly one
// writer (no atomics, a deterministic order: source order). The TPU kept a
// baseline's whole (R_max, 2r) rows resident in VMEM; at the north star
// that is 840 x 64 doubles = 430 KB, more than a block's shared memory, so
// here each block holds only its 32 x 64 tile, in registers. A tile whose
// sources cannot reach the block's rows is skipped from a per-(direction,
// tile) [min, max] table of u built by a first pass (the spatial sort makes
// most tiles miss). For a tile that may reach, the block
//   1. computes each source's first-tap row; the sources that hit are
//      compacted in source order (warp ballots), and for each hit the
//      block stores its carrier and its K weights laid out on the block's
//      32 rows (zero elsewhere): a dense (hits x 32) window in shared
//      memory, built only where taps land (no dense G_win x T_s window);
//   2. gathers the hits' payload P (r values each) into shared memory;
//   3. each thread owns one column and 8 rows and accumulates
//      acc[row] += w[hit][row] * (P[hit][k] * carrier) in float64.
// What bounds it: float64 instruction throughput in step 3 (8 FMAs and 8
// shared loads per hit and thread, ~3.5x the K * 2r useful FMAs), plus the
// setup of step 1 (two-float bin, sincospi and 99 Horner FMAs per hit).
//
// Build without --use_fast_math: rintf and sincospi must stay the
// IEEE-accurate library versions, and twofloat.cuh pins the compensated
// arithmetic against FMA contraction.
#include <cuda_runtime.h>
#include <math.h>

#include "twofloat.cuh"

using prisim::df;

namespace {

constexpr int kThreads = 256;                       // threads per block
constexpr int kRows = 32;                           // output rows per block
constexpr int kCols = 64;                           // output columns per block
constexpr int kRowsPerThread = kRows * kCols / kThreads;   // 8
constexpr int kST = 128;                            // sources per tile
constexpr int kWStride = kRows + 1;                 // padded window row
constexpr int kMaxK = 15;                           // taps
constexpr int kMaxCoef = 16;                        // polynomial degree + 1
constexpr float kPadU = 2.5f;                       // u >= this: a pad

// Pass 1: [min, max] of u.h over the valid sources of each (direction,
// tile of kST sources); (inf, -inf) when the tile has none.
__global__ void __launch_bounds__(kST)
tile_urange_kernel(const float* __restrict__ u_h, float2* __restrict__ urange,
                   int S, int n_tiles) {
  __shared__ float smin[kST];
  __shared__ float smax[kST];
  const int d = blockIdx.y;
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int s = tile * kST + t;
  float lo = INFINITY;
  float hi = -INFINITY;
  if (s < S) {
    const float u = u_h[static_cast<size_t>(d) * S + s];
    if (u < kPadU) {
      lo = u;
      hi = u;
    }
  }
  smin[t] = lo;
  smax[t] = hi;
  __syncthreads();
  for (int w = kST / 2; w > 0; w >>= 1) {
    if (t < w) {
      smin[t] = fminf(smin[t], smin[t + w]);
      smax[t] = fmaxf(smax[t], smax[t + w]);
    }
    __syncthreads();
  }
  if (t == 0) {
    urange[static_cast<size_t>(d) * n_tiles + tile] =
        make_float2(smin[0], smax[0]);
  }
}

__global__ void __launch_bounds__(kThreads)
banded_k2_kernel(const float* __restrict__ u_h, const float* __restrict__ u_l,
                 const double* __restrict__ P_r,
                 const float* __restrict__ blen_h,
                 const float* __restrict__ blen_l,
                 const int* __restrict__ d_of_b,
                 const int* __restrict__ blk_lo, const int* __restrict__ n_blk,
                 const double* __restrict__ tap_w,
                 const float2* __restrict__ urange, double* __restrict__ out,
                 int S, int n_tiles, int R_max, int r, int K, int ncoef,
                 int G_blk, float ivh, float ivl, float nmh, float nml,
                 double inv_ch) {
  extern __shared__ double smem[];
  double* wwin = smem;                                 // [kST][kWStride]
  double* pay = wwin + kST * kWStride;                 // [kST][r + 1]
  double2* car = reinterpret_cast<double2*>(pay + kST * (r + 1));  // [kST]
  int* hit_src = reinterpret_cast<int*>(car + kST);    // [kST]
  __shared__ double taps[kMaxK * kMaxCoef];
  __shared__ int warp_hits[kST / 32];

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int R0 = blockIdx.y * kRows;
  const int col = blockIdx.z * kCols + (tid % kCols);
  const int rg = (tid / kCols) * kRowsPerThread;       // first owned row
  const int two_r = 2 * r;
  const bool col_live = col < two_r;
  const int kcol = col < r ? col : col - r;
  const int d = d_of_b[b];
  const int half = K / 2;
  const int base = blk_lo[b] * G_blk;
  const int own_hi = n_blk[b] * G_blk;       // owned first-tap rows [0, own_hi)
  const df blen = {blen_h[b], blen_l[b]};
  const df ivc = {ivh, ivl};
  const df nmc = {nmh, nml};
  const double blen64 = static_cast<double>(blen.h) + blen.l;

  for (int i = tid; i < K * ncoef; i += kThreads) taps[i] = tap_w[i];
  double acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.0;

  // first-tap rows that reach this block: [R0 - K + 1, R0 + kRows - 1]
  const bool block_live = R0 < own_hi + K - 1;
  for (int tile = 0; block_live && tile < n_tiles; ++tile) {
    // Conservative first-tap row range of the tile: phi is monotone in u
    // (|b| > 0); rint moves a row by at most one and u.l by far less.
    const float2 ur = urange[static_cast<size_t>(d) * n_tiles + tile];
    if (!(ur.x <= ur.y)) continue;
    const double row_lo = floor(blen64 * ur.x * inv_ch) - 2.0 - half - base;
    const double row_hi = ceil(blen64 * ur.y * inv_ch) + 2.0 - half - base;
    if (row_hi < R0 - K + 1 || row_lo > R0 + kRows - 1) continue;

    __syncthreads();                     // previous tile's tables consumed
    // 1. first-tap row of each source; compact the hits in source order
    const int s = tile * kST + tid;
    bool hit = false;
    int q = 0;
    df t = {0.f, 0.f};
    df ph = {0.f, 0.f};
    float m0 = 0.f;
    if (tid < kST && s < S) {
      const float uh = u_h[static_cast<size_t>(d) * S + s];
      if (uh < kPadU) {
        const df u = {uh, u_l[static_cast<size_t>(d) * S + s]};
        t = prisim::df_mul(blen, u);
        ph = prisim::df_mul(t, ivc);
        m0 = rintf(ph.h);
        const int first = static_cast<int>(m0) - half - base;
        q = first - R0;
        hit = first >= 0 && first < own_hi && q > -K && q < kRows;
      }
    }
    unsigned ballot = 0;
    if (tid < kST) {
      ballot = __ballot_sync(0xffffffffu, hit);
      if ((tid & 31) == 0) warp_hits[tid >> 5] = __popc(ballot);
    }
    __syncthreads();
    int n_hit = 0;
    int idx = 0;
#pragma unroll
    for (int w = 0; w < kST / 32; ++w) {
      if (w < (tid >> 5)) idx += warp_hits[w];
      n_hit += warp_hits[w];
    }
    if (n_hit == 0) continue;
    if (hit) {
      idx += __popc(ballot & ((1u << (tid & 31)) - 1u));
      hit_src[idx] = s;
      car[idx] = prisim::phasor64(prisim::df_frac(prisim::df_mul(t, nmc)));
      const double z0 = static_cast<double>(__fsub_rn(ph.h, m0)) + ph.l;
      double* wrow = wwin + idx * kWStride;
      for (int row = 0; row < kRows; ++row) wrow[row] = 0.0;
      for (int j = 0; j < K; ++j) {
        const int row = q + j;
        if (row < 0 || row >= kRows) continue;
        const double* co = taps + j * ncoef;
        double w = co[0];
        for (int c = 1; c < ncoef; ++c) w = fma(w, z0, co[c]);
        wrow[row] = w;
      }
    }
    __syncthreads();
    // 2. the hits' payload, gathered from P_r (r, S)
    for (int e = tid; e < n_hit * r; e += kThreads) {
      const int k = e / n_hit;
      const int i = e - k * n_hit;
      pay[i * (r + 1) + k] = P_r[static_cast<size_t>(k) * S + hit_src[i]];
    }
    __syncthreads();
    // 3. acc[row] += w[hit][row] * (P[hit][k] * carrier)
    if (col_live) {
      for (int i = 0; i < n_hit; ++i) {
        const double2 cr = car[i];
        const double v = pay[i * (r + 1) + kcol] * (col < r ? cr.x : cr.y);
        const double* w = wwin + i * kWStride + rg;
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) acc[j] = fma(w[j], v, acc[j]);
      }
    }
  }

  if (!col_live) return;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int row = R0 + rg + j;
    if (row < R_max) {
      out[(static_cast<size_t>(b) * R_max + row) * two_r + col] = acc[j];
    }
  }
}

size_t k2_smem(int r) {
  return static_cast<size_t>(kST) * kWStride * sizeof(double) +
         static_cast<size_t>(kST) * (r + 1) * sizeof(double) +
         kST * sizeof(double2) + kST * sizeof(int);
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes of one K2 block at rank r.
size_t prisim_banded_k2_smem(int r) { return k2_smem(r); }

// Launch K2 on `stream`. Device pointers: u_h/u_l float32 (D, S) direction
// streams; P_r float64 (r, S); blen_h/blen_l float32 (B,); d_of_b, blk_lo,
// n_blk int32 (B,); tap_w float64 (K, ncoef); urange float32 scratch of
// 2 * D * ceil(S / 128) values; out float64 (B, R_max, 2r), every element
// written. Returns the cudaError_t of the launches.
int prisim_banded_k2(const void* u_h, const void* u_l, const void* P_r,
                     const void* blen_h, const void* blen_l,
                     const void* d_of_b, const void* blk_lo,
                     const void* n_blk, const void* tap_w, void* urange,
                     void* out, int D, int S, int B, int R_max, int r, int K,
                     int ncoef, int G_blk, float ivh, float ivl, float nmh,
                     float nml, double inv_ch, void* stream) {
  const int n_tiles = (S + kST - 1) / kST;
  const int n_rb = (R_max + kRows - 1) / kRows;
  if (D < 1 || S < 1 || B < 1 || R_max < 1 || r < 1 || K < 1 ||
      K > kMaxK || (K & 1) == 0 || ncoef < 1 || ncoef > kMaxCoef ||
      G_blk < 1 || n_rb > 65535 || D > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tile_urange_kernel<<<dim3(n_tiles, D), kST, 0, st>>>(
      static_cast<const float*>(u_h), static_cast<float2*>(urange), S,
      n_tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = k2_smem(r);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(banded_k2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B, n_rb, (2 * r + kCols - 1) / kCols);
  banded_k2_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(u_h), static_cast<const float*>(u_l),
      static_cast<const double*>(P_r), static_cast<const float*>(blen_h),
      static_cast<const float*>(blen_l), static_cast<const int*>(d_of_b),
      static_cast<const int*>(blk_lo), static_cast<const int*>(n_blk),
      static_cast<const double*>(tap_w),
      static_cast<const float2*>(urange), static_cast<double*>(out), S,
      n_tiles, R_max, r, K, ncoef, G_blk, ivh, ivl, nmh, nml, inv_ch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
