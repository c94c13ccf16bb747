// Kernel delay_spread: the sorted delay-grid spread of the delay-space NUFFT
// engine, for Hopper (sm_90a).
//
// Replaces prisim_tpu/engine/nufft_delay.py::nufft_delay_multirank_sorted
// (and the scatter and gather spreads of that module, three formulations
// of one function). That is XLA, not a Pallas kernel: an argsort per
// baseline, two-float compensated cumsums and boundary gathers, because
// XLA on a TPU has no fast scatter. It computes what the plain version
// engine/cuda_spread.py::delay_spread_plain computes: for every baseline b,
// rank i and grid bin g,
//   grid[b, g, i] = sum_s sum_{j=-K/2..K/2} [(m0_sb + j) mod n = g]
//                   w_j(z0_sb) P[s, i] e^{-2 pi i frac(tau_sb nu_c)},
// with tau_sb = tau_h + tau_l joined in float64 on load, nu_c the carrier
// frequency (mid-band plus a channel shard's offset), m0 and z0 the
// folded bins and offsets the wrapper computed once in float64 (the sort
// read the same m0), w_j the degree-12 tap polynomials (Horner, float64).
// Everything is float64; the grid is returned in float64.
//
// What bounds it: float64 operations. Per (source, baseline) pair the
// taps' products are 2 K r FMAs (4 K r operations: 1,664 at K = 13,
// r = 32), plus K Horner chains of 12 FMAs and a sincospi. The HERA-37
// slice (24,576 sources above the horizon x 666 baselines) is about
// 32 GFLOP, ~0.95 ms at the FP64 vector peak (34 TFLOP/s).
//
// Design. Bins are contended: a short baseline puts all its sources in a
// few dozen bins. So the wrapper sorts each baseline's sources by m0 (a
// torch sort, set-up), and the kernel walks them in that order:
// 1. A block owns one baseline, a segment of its sorted sources and up
//    to 32 ranks. It stages 128 sources at a time in shared memory: the
//    payload rows gathered by the sort's permutation (cp.async, a warp a
//    row, every copy of the step in flight at once), and, while they
//    arrive, each source's carrier and K tap weights (a thread a source,
//    its K Horner chains side by side). 53 KB of shared memory a block:
//    4 blocks on an SM.
// 2. A lane owns one rank (and, for r < 32, a sub-stream of the sources)
//    and keeps all K taps' complex sums of the current run of equal bins
//    in registers: per source one shared load of its payload, a broadcast
//    of its carrier (2 multiplies), K/2 broadcast loads of its taps and
//    2K FMAs.
// 3. When the bin changes, the lane adds its K sums to the grid in device
//    memory (atomicAdd, float64): once per run and rank, not once per
//    source, so atomics are rare where bins are crowded and the grid
//    needs no shared copy (one baseline's grid is 32 KB a rank).
// Atomics make the order of the run sums vary between launches: results
// agree to float64 rounding, not bit for bit.
//
// Build without --use_fast_math: sincospi and rint must stay the
// IEEE-accurate library versions.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                  // threads per block
constexpr int kChunk = 128;                    // sources staged per step
constexpr int kRanks = 32;                     // ranks per block (grid z)
constexpr int kMaxK = 15;                      // taps
constexpr int kMaxCoef = 16;                   // polynomial degree + 1
constexpr int kWPitch = 16;                    // doubles of a source's taps

constexpr size_t kSmemBytes =
    sizeof(double) * kChunk * kRanks +         // payload rows
    sizeof(double) * kChunk * kWPitch +        // tap weights
    sizeof(double2) * kChunk +                 // carriers
    sizeof(double) * kMaxK * kMaxCoef +        // tap coefficients
    sizeof(int) * kChunk * 2;                  // sources, bins

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8-byte asynchronous copy global -> shared (cp.async, sm_80+).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void flush(double* gb, int m, int half, int K,
                                      int n, int r, int rank,
                                      double (&are)[kMaxK],
                                      double (&aim)[kMaxK]) {
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < K) {
      int g = (m + j - half) % n;
      if (g < 0) g += n;
      double* d = gb + (static_cast<long long>(g) * r + rank) * 2;
      atomicAdd(d, are[j]);
      atomicAdd(d + 1, aim[j]);
      are[j] = 0.0;
      aim[j] = 0.0;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    delay_spread_kernel(const float* __restrict__ th,
                        const float* __restrict__ tl,
                        const double* __restrict__ z0,
                        const int* __restrict__ key,
                        const int* __restrict__ perm,
                        const double* __restrict__ P, long long p_bstride,
                        const double* __restrict__ taps, int K, int ncoef,
                        double nu_c, double* __restrict__ grid, int S, int r,
                        int n, int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ps = reinterpret_cast<double*>(smem);
  double* ws = ps + kChunk * kRanks;
  double2* car = reinterpret_cast<double2*>(ws + kChunk * kWPitch);
  double* tap_s = reinterpret_cast<double*>(car + kChunk);
  int* src = reinterpret_cast<int*>(tap_s + kMaxK * kMaxCoef);
  int* bins = src + kChunk;

  const int b = blockIdx.x;
  const int rank0 = blockIdx.z * kRanks;
  const int nr = min(kRanks, r - rank0);
  // lanes per source group: the smallest power of two >= nr; the warp
  // walks 32 / npow sources at once, one per group
  int npow = 1;
  while (npow < nr) npow <<= 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = lane % npow;
  const int sub = lane / npow;
  const int step = 32 / npow;
  const bool active = rank < nr;
  const long long row = static_cast<long long>(b) * S;
  const int p_begin = blockIdx.y * seg;
  const int p_end = min(S, p_begin + seg);
  const int half = K / 2;
  const double* Pb = P + b * p_bstride + rank0;
  double* gb = grid + static_cast<long long>(b) * n * r * 2;

  for (int t = tid; t < K * ncoef; t += kThreads) tap_s[t] = taps[t];

  double are[kMaxK], aim[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) are[j] = aim[j] = 0.0;
  int cur = -1;

  for (int p0 = p_begin; p0 < p_end; p0 += kChunk) {
    const int cnt = min(kChunk, p_end - p0);
    __syncthreads();  // the last chunk is read; tap_s is written
    int s = 0;
    if (tid < cnt) {
      s = perm[row + p0 + tid];
      src[tid] = s;
      bins[tid] = key[row + p0 + tid];
    }
    __syncthreads();
    // the payload rows gathered by the permutation, a warp per source and
    // a lane per rank, every copy of the chunk in flight at once
    if (lane < nr) {
      for (int t = warp; t < cnt; t += kThreads / 32)
        cp_async8(ps + t * kRanks + lane,
                  Pb + static_cast<long long>(src[t]) * r + lane);
    }
    // meanwhile each source's carrier and taps
    if (tid < cnt) {
      const double tau = static_cast<double>(th[row + s]) +
                         static_cast<double>(tl[row + s]);
      double cyc = tau * nu_c;
      cyc -= rint(cyc);
      double sn, cs;
      sincospi(2.0 * cyc, &sn, &cs);
      car[tid] = make_double2(cs, -sn);
      const double z = z0[row + s];
      // the K Horner chains side by side, so that their latencies overlap
      double w[kMaxK];
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (j < K) w[j] = tap_s[j * ncoef];
      for (int d = 1; d < ncoef; ++d) {
#pragma unroll
        for (int j = 0; j < kMaxK; ++j)
          if (j < K) w[j] = fma(w[j], z, tap_s[j * ncoef + d]);
      }
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (j < K) ws[tid * kWPitch + j] = w[j];
    }
    cp_async_wait_all();
    __syncthreads();
    if (active) {
      const int q_end = min(cnt, (warp + 1) * 32);
      for (int q = warp * 32 + sub; q < q_end; q += step) {
        const int m = bins[q];
        if (m != cur) {
          if (cur >= 0)
            flush(gb, cur, half, K, n, r, rank0 + rank, are, aim);
          cur = m;
        }
        const double pv = ps[q * kRanks + rank];
        const double2 c = car[q];
        const double xr = pv * c.x;
        const double xi = pv * c.y;
        const double2* wq = reinterpret_cast<const double2*>(ws + q * kWPitch);
#pragma unroll
        for (int j2 = 0; j2 < (kMaxK + 1) / 2; ++j2) {
          const double2 w2 = wq[j2];
          if (2 * j2 < K) {
            are[2 * j2] = fma(w2.x, xr, are[2 * j2]);
            aim[2 * j2] = fma(w2.x, xi, aim[2 * j2]);
          }
          if (2 * j2 + 1 < K) {
            are[2 * j2 + 1] = fma(w2.y, xr, are[2 * j2 + 1]);
            aim[2 * j2 + 1] = fma(w2.y, xi, aim[2 * j2 + 1]);
          }
        }
      }
    }
  }
  if (active && cur >= 0)
    flush(gb, cur, half, K, n, r, rank0 + rank, are, aim);
}

}  // namespace

extern "C" {

// Constants the wrapper checks against its own.
int prisim_spread_max_taps() { return kMaxK; }
int prisim_spread_max_coef() { return kMaxCoef; }

// Spread on `stream`. Pointers are device pointers to contiguous arrays:
// th/tl float32 (B, S) two-float delays; z0 float64 (B, S) offsets; key
// int32 (B, S) each row's folded bins in ascending order and perm int32
// (B, S) the source of each sorted position; P float64, rank i of source
// s for baseline b at P[b * p_bstride + s * r + i]; taps float64
// (K, ncoef) highest degree first; grid float64 (B, n, r, 2), zeroed by
// the caller and added to. seg sources of a row per block. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for K > kMaxK,
// ncoef > kMaxCoef or a shape the grid cannot hold).
int prisim_delay_spread(const void* th, const void* tl, const void* z0,
                        const void* key, const void* perm, const void* P,
                        long long p_bstride, const void* taps, int K,
                        int ncoef, double nu_c, void* grid, int S, int B,
                        int r, int n, int seg, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || ncoef < 1 || ncoef > kMaxCoef || S < 1 ||
      B < 1 || r < 1 || n < 1 || seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_seg = (static_cast<long long>(S) + seg - 1) / seg;
  const int n_rg = (r + kRanks - 1) / kRanks;
  if (n_seg > 65535 || n_rg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      delay_spread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 blocks(B, static_cast<unsigned>(n_seg), n_rg);
  delay_spread_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(th), static_cast<const float*>(tl),
      static_cast<const double*>(z0), static_cast<const int*>(key),
      static_cast<const int*>(perm), static_cast<const double*>(P),
      p_bstride, static_cast<const double*>(taps), K, ncoef, nu_c,
      static_cast<double*>(grid), S, r, n, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
