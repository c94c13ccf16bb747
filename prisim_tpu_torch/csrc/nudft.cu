// Kernels K1a, K1b and K1c: NUDFT visibilities for Hopper (sm_90a).
//
// Replace the three modes of the TPU kernel
// prisim_tpu/engine/pallas_nudft.py::_kernel. K1a (point sources) is its
// own kernel, nudft_point_kernel (its note is below, above the kernel);
// K1b and K1c are instances of the template nudft_kernel, whose note
// follows. On a uniform channel grid
// nu_c = nu0 + (chan0 + c) dnu they compute
//   V[b, c]   = sum_s A[s, c] w[s, b, c] exp(-2 pi i nu_c (s_eff . b) / c_l)
//   G_k[b, c] = sum_s s_sky[s, k] A[s, c] w[s, b, c] exp(...)   (K1b)
//   w[s, b, c] = exp(-alpha[s, b] (nu_c / c_l)^2),                (K1c)
//   alpha = max(|b|^2 - (s_sky . b)^2, 0) / (2 sigma_s^2),
// with w = 1 for K1a and K1b alone, and for sigma = inf (a point source).
// K1b is <kGrad = true, kExt = false>, K1c <false, true>; <true, true>
// runs both at once.
//
// Arithmetic, as in the plain version (engine/nudft.py): the delay
// k = s.b and the cycle counts p0 = k nu0/c, d = k dnu/c are two-float
// and reduced mod 1; with c = q L + r the phasor is U[s,b,q] W[s,b,r],
// where U is taken at the cycle count p0 + (q L + chan0) d and W at r d,
// each reduced mod 1 in two-float and turned into a float64 phasor by
// sincospi. The products are summed in float64. (On the slice shape an
// f32 phasor and product chain floors at 2.1e-6 of max|V| against the f64
// golden even with an exact sum, above the engines' 2e-6 bar; see
// PERF.md.) The f64 sums need no Kahan compensation. The gaussian weight
// is float32: alpha is taken in float64 with every rounding pinned
// (__dadd_rn, __dmul_rn, __ddiv_rn) and rounded to float32, as is the
// channel factor (nu_c/c)^2, and w = expf(-alpha k2) with the accurate
// expf (no fast math), so that the weight equals the plain version's.
// A w is exact in float64.
//
// What bounds it on the H100: float64 issue (64 FP64 lanes per SM and
// clock, half the FP32 rate). The template's complex multiply-add is 8
// FP64 instructions; each of the Q + L phasors per (source, baseline) is
// one sincospi (~64 phasors per 1024 channels). K1b adds the three
// moments, 14 FP64 instructions per term in all, and K1c one FP64
// multiply, the conversion and an expf (FP32 and MUFU pipes) per term. Amplitude
// traffic is S*C*4 bytes per block; a block owns NB baselines so each
// amplitude load feeds NB terms, and blocks that run together read the
// same source tiles, which L2 serves.
//
// Design: one block owns NB baselines x (kThreads * CPT) channels and
// loops over ALL sources in tiles of ST (no reduction crosses blocks;
// this loop takes the place of the TPU grid's sequential source axis).
// Per tile the threads build the two-float cycle scalars (and alpha) per
// (baseline, source) pair, then the U and W phasor tables in shared
// memory; each thread then owns CPT channels c = c0 + tid + j*kThreads
// (all with the same fine index r, since L divides kThreads) and
// accumulates in float64 registers. K1b's 3 extra complex accumulators
// per output would take 96 more registers at K1a's NB=2 x CPT=4, past what
// __launch_bounds__(256) leaves without spills, so gradient mode runs
// CPT=2. Ragged S, B and C are masked in the kernel. The outputs are
// written as complex64 (B, nchan) and (3, B, nchan).
#include <cuda_runtime.h>

#include "twofloat.cuh"

using prisim::df;

namespace {

constexpr int kThreads = 256;             // threads per block

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

// Modes of the C interface (bit flags).
constexpr int kModeGrad = 1;
constexpr int kModeExt = 2;

template <int NB, int CPT, bool kGrad, bool kExt>
struct Cfg {
  static constexpr int kTile = kThreads * CPT;   // channels per block
  static int tq_cap(int Q, int L) { return (kTile / L < Q) ? kTile / L : Q; }
  // Shared-memory bytes of one block for a source tile of ST.
  static size_t smem(int Q, int L, int ST) {
    const size_t ns = static_cast<size_t>(NB) * ST;
    return ns * (tq_cap(Q, L) + L) * sizeof(double2) +
           (kGrad ? 3 * static_cast<size_t>(ST) * sizeof(double) : 0) +
           (4 + (kExt ? 1 : 0)) * ns * sizeof(float);
  }
};

// alpha = max(|b|^2 - (s . b)^2, 0) / (2 sigma^2) in float64, every
// rounding pinned in the order of engine/nudft.py::ext_alpha, rounded to
// float32.
__device__ __forceinline__ float ext_alpha(const float* s, float sigma,
                                           const float* bh, const float* bl) {
  double b[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    b[ax] = __dadd_rn(static_cast<double>(bh[ax]), static_cast<double>(bl[ax]));
  }
  const double k = __dadd_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(s[0]), b[0]),
                __dmul_rn(static_cast<double>(s[1]), b[1])),
      __dmul_rn(static_cast<double>(s[2]), b[2]));
  const double bl2 = __dadd_rn(__dadd_rn(__dmul_rn(b[0], b[0]),
                                         __dmul_rn(b[1], b[1])),
                               __dmul_rn(b[2], b[2]));
  const double proj2 = fmax(__dadd_rn(bl2, -__dmul_rn(k, k)), 0.0);
  const double sig = static_cast<double>(sigma);
  return __double2float_rn(__ddiv_rn(__dmul_rn(0.5, proj2), __dmul_rn(sig, sig)));
}

template <int NB, int CPT, bool kGrad, bool kExt>
__global__ void __launch_bounds__(kThreads)
nudft_kernel(const float* __restrict__ seh, const float* __restrict__ sel,
             const float* __restrict__ blh, const float* __restrict__ bll,
             const float* __restrict__ amps, const float* __restrict__ ssky,
             const float* __restrict__ sigma, float2* __restrict__ out,
             float2* __restrict__ gout, int S, int B, int nchan, int Q, int L,
             int ST, int TQ_cap, float g0h, float g0l, float gdh, float gdl,
             int chan0) {
  extern __shared__ double2 smem[];
  const int NS = NB * ST;                   // (baseline, source) pairs
  double2* U = smem;                        // [NS][TQ_cap]
  double2* W = U + NS * TQ_cap;             // [NS][L]
  double* sk = reinterpret_cast<double*>(W + NS * L);   // [ST][3] (K1b)
  float* p0h_s = reinterpret_cast<float*>(sk + (kGrad ? 3 * ST : 0));
  float* p0l_s = p0h_s + NS;
  float* dh_s = p0l_s + NS;
  float* dl_s = dh_s + NS;
  float* alpha_s = dl_s + NS;               // [NS] (K1c)

  constexpr int kTile = Cfg<NB, CPT, kGrad, kExt>::kTile;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * NB;
  const int c0 = blockIdx.y * kTile;
  const int q0 = c0 / L;
  const int TQ = min(TQ_cap, Q - q0);
  const int r = tid & (L - 1);
  const df g0 = {g0h, g0l};
  const df gd = {gdh, gdl};

  int qi[CPT];
  bool live[CPT];
  float k2[CPT];                            // (nu_c / c)^2 (K1c)
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    live[j] = c0 + tid + j * kThreads < nchan;
    qi[j] = min((tid + j * kThreads) / L, TQ - 1);
    if constexpr (kExt) {
      const double x = __dadd_rn(
          __dadd_rn(static_cast<double>(g0h), static_cast<double>(g0l)),
          __dmul_rn(__dadd_rn(static_cast<double>(gdh),
                              static_cast<double>(gdl)),
                    static_cast<double>(chan0 + c0 + tid + j * kThreads)));
      k2[j] = __double2float_rn(__dmul_rn(x, x));
    }
  }
  constexpr int kOut = kGrad ? 4 : 1;       // V, then G_0..G_2
  double acc_r[kOut][NB][CPT], acc_i[kOut][NB][CPT];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc_r[o][bi][j] = acc_i[o][bi][j] = 0.0;
    }
  }

  for (int s0 = 0; s0 < S; s0 += ST) {
    const int ns = min(ST, S - s0);
    __syncthreads();                        // previous tables consumed

    // 1. per (baseline, source) pair: two-float cycle scalars, alpha
    if (tid < NS) {
      const int bi = tid / ST;
      const int s = s0 + (tid - bi * ST);
      const int b = b0 + bi;
      df p0 = {0.f, 0.f};
      df d = {0.f, 0.f};
      float alpha = 0.f;
      if (s < S && b < B) {
        float sh[3], sl[3], bh[3], bl[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          sh[ax] = seh[3 * s + ax];
          sl[ax] = sel[3 * s + ax];
          bh[ax] = blh[3 * b + ax];
          bl[ax] = bll[3 * b + ax];
        }
        const df k = prisim::df_dot3(sh, sl, bh, bl);
        p0 = prisim::df_frac(prisim::df_mul(k, g0));
        d = prisim::df_frac(prisim::df_mul(k, gd));
        if constexpr (kExt) alpha = ext_alpha(ssky + 3 * s, sigma[s], bh, bl);
      }
      p0h_s[tid] = p0.h;
      p0l_s[tid] = p0.l;
      dh_s[tid] = d.h;
      dl_s[tid] = d.l;
      if constexpr (kExt) alpha_s[tid] = alpha;
    }
    if constexpr (kGrad) {
      if (tid < 3 * ST) {
        sk[tid] = (tid < 3 * ns) ? static_cast<double>(ssky[3 * s0 + tid]) : 0.0;
      }
    }
    __syncthreads();

    // 2. phasor tables: U over this block's coarse groups, W over r
    for (int idx = tid; idx < NS * TQ; idx += kThreads) {
      const int pr = idx / TQ;
      const int j = idx - pr * TQ;
      const df d = {dh_s[pr], dl_s[pr]};
      const df p0 = {p0h_s[pr], p0l_s[pr]};
      const float step = static_cast<float>((q0 + j) * L + chan0);
      U[pr * TQ_cap + j] = prisim::phasor64(
          prisim::df_frac(prisim::df_add(p0, prisim::df_mul_f(d, step))));
    }
    for (int idx = tid; idx < NS * L; idx += kThreads) {
      const int pr = idx / L;
      const int j = idx - pr * L;
      const df d = {dh_s[pr], dl_s[pr]};
      W[pr * L + j] = prisim::phasor64(
          prisim::df_frac(prisim::df_mul_f(d, static_cast<float>(j))));
    }
    __syncthreads();

    // 3. multiply-accumulate in float64: acc += U * (A w W)
    for (int si = 0; si < ns; ++si) {
      const float* arow =
          amps + static_cast<size_t>(s0 + si) * nchan + c0 + tid;
      double a[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        a[j] = live[j] ? static_cast<double>(__ldg(arow + j * kThreads)) : 0.0;
      }
      double s3[3];
      if constexpr (kGrad) {
#pragma unroll
        for (int k = 0; k < 3; ++k) s3[k] = sk[3 * si + k];
      }
#pragma unroll
      for (int bi = 0; bi < NB; ++bi) {
        const int pr = bi * ST + si;
        const double2 w = W[pr * L + r];
        const double2* u = U + pr * TQ_cap;
        float alpha = 0.f;
        if constexpr (kExt) alpha = alpha_s[pr];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          double aw = a[j];
          if constexpr (kExt) {
            aw *= static_cast<double>(expf(-__fmul_rn(alpha, k2[j])));
          }
          const double2 uu = u[qi[j]];
          const double tr = aw * w.x;
          const double ti = aw * w.y;
          if constexpr (kGrad) {
            const double er = uu.x * tr - uu.y * ti;
            const double ei = uu.x * ti + uu.y * tr;
            acc_r[0][bi][j] += er;
            acc_i[0][bi][j] += ei;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              acc_r[1 + k][bi][j] += s3[k] * er;
              acc_i[1 + k][bi][j] += s3[k] * ei;
            }
          } else {
            acc_r[0][bi][j] += uu.x * tr - uu.y * ti;
            acc_i[0][bi][j] += uu.x * ti + uu.y * tr;
          }
        }
      }
    }
  }

#pragma unroll
  for (int bi = 0; bi < NB; ++bi) {
    const int b = b0 + bi;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (!live[j]) continue;
      const size_t at = static_cast<size_t>(b) * nchan + c0 + tid + j * kThreads;
      out[at] = make_float2(static_cast<float>(acc_r[0][bi][j]),
                            static_cast<float>(acc_i[0][bi][j]));
      if constexpr (kGrad) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          gout[static_cast<size_t>(k) * B * nchan + at] =
              make_float2(static_cast<float>(acc_r[1 + k][bi][j]),
                          static_cast<float>(acc_i[1 + k][bi][j]));
        }
      }
    }
  }
}

template <int NB, int CPT, bool kGrad, bool kExt>
int launch(const void* seh, const void* sel, const void* blh, const void* bll,
           const void* amps, const void* ssky, const void* sigma, void* out,
           void* gout, int S, int B, int nchan, int Q, int L, int ST,
           float g0h, float g0l, float gdh, float gdl, int chan0,
           cudaStream_t stream) {
  using C = Cfg<NB, CPT, kGrad, kExt>;
  auto kernel = nudft_kernel<NB, CPT, kGrad, kExt>;
  if (NB * ST > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = C::smem(Q, L, ST);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((B + NB - 1) / NB, (nchan + C::kTile - 1) / C::kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(seh), static_cast<const float*>(sel),
      static_cast<const float*>(blh), static_cast<const float*>(bll),
      static_cast<const float*>(amps), static_cast<const float*>(ssky),
      static_cast<const float*>(sigma), static_cast<float2*>(out),
      static_cast<float2*>(gout), S, B, nchan, Q, L, ST, C::tq_cap(Q, L),
      g0h, g0l, gdh, gdl, chan0);
  return static_cast<int>(cudaGetLastError());
}

// Kernel K1a: point sources, V[b, c] = sum_s A[s, c] e^{-2 pi i nu_c (s . b) / c}.
//
// What bounds it: float64 issue. The least a term can take is 6 FP64
// instructions, 2 DMUL for A W and 4 DFMA into the accumulators (~10 ms
// at the slice's 666 x 1024 x 49,152 terms, 5 ms counting only the
// sources above the horizon). What the template cost on top when it ran
// K1a (69.6 ms at the slice on an H100 80GB HBM3 at 700 W), and what this
// kernel does about it:
//
// 1. Phasors by float64 anchored rotations (the reference's recur='rot',
//    pallas_nudft.py:214-260, in float64): along each chain of `aper`
//    phasors, U over the coarse index q (step L d) and W over the fine
//    index r (step d), only the anchor and the step phasor are a sincospi
//    of a two-float reduced cycle count; the others are a complex multiply
//    by the step (every rounding pinned, as the plain version rounds
//    them). 2 sincospi per aper phasors instead of aper (aper is
//    engine/nudft.py's ANCHOR, 16, set by measurement); in float64 the
//    drift over 16 steps is ~1e-15, far below the complex64 output.
// 2. A 6-instruction MAC: tr = A w.re, ti = A w.im (2 DMUL), then 4 DFMA
//    chained into the accumulators.
// 3. Fewer conversions: a block owns kPNB = 4 baselines (accumulators in
//    registers), so each f32 -> f64 amplitude conversion feeds 4 terms.
// 4. Pipelined tiles: the phasor tables are double-buffered; the chains of
//    tile i + 1 are built into one buffer while the MACs of tile i read the
//    other, one barrier per tile. The build needs no separate pass: each
//    chain derives its pair's two-float scalars.
// 5. Only live sources: the wrapper orders the sources whose amplitudes
//    are not all zero first (stable) and passes their count; the zero rows
//    below the horizon add exact zeros and are not visited.
// 6. The grid splits the live sources into n_split contiguous ranges so
//    that the blocks fill whole waves of the card; each split writes float64
//    partial sums, which the wrapper adds in split order. Every output has
//    one writer per split and a sum order fixed by the data.
constexpr int kPNB = 4;                     // baselines per block
constexpr int kPCPT = 4;                    // channels per thread
constexpr int kPST = 8;                     // sources per tile
constexpr int kPTile = kThreads * kPCPT;    // channels per block

int point_tq(int Q, int L) { return (kPTile / L < Q) ? kPTile / L : Q; }

size_t point_smem(int Q, int L) {
  return 2 * static_cast<size_t>(kPNB) * kPST * (point_tq(Q, L) + L) *
             sizeof(double2) +
         2 * kPST * sizeof(int);
}

// frac(p0 + k d) in two-float, as the plain version's _phasors forms it.
__device__ __forceinline__ df cycles(df p0, df d, float k) {
  return prisim::df_frac(prisim::df_add(p0, prisim::df_mul_f(d, k)));
}

// x * y for phasors (re, im), every rounding pinned (no contraction), as
// the plain version multiplies them.
__device__ __forceinline__ double2 cmul_rn(double2 x, double2 y) {
  return make_double2(__dsub_rn(__dmul_rn(x.x, y.x), __dmul_rn(x.y, y.y)),
                      __dadd_rn(__dmul_rn(x.x, y.y), __dmul_rn(x.y, y.x)));
}

__global__ void __launch_bounds__(kThreads, 2)
nudft_point_kernel(const float* __restrict__ seh, const float* __restrict__ sel,
                   const float* __restrict__ blh, const float* __restrict__ bll,
                   const float* __restrict__ amps, const int* __restrict__ perm,
                   const int* __restrict__ n_live_p, double2* __restrict__ part,
                   int B, int nchan, int Q, int L, int TQ_cap, float g0h,
                   float g0l, float gdh, float gdl, int chan0, int aper,
                   int n_split) {
  extern __shared__ double2 smem[];
  constexpr int NS = kPNB * kPST;           // (baseline, source) pairs
  double2* Ubuf = smem;                     // [2][NS][TQ_cap]
  double2* Wbuf = Ubuf + 2 * NS * TQ_cap;   // [2][NS][L]
  int* srcs = reinterpret_cast<int*>(Wbuf + 2 * NS * L);   // [2][kPST]

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kPNB;
  const int c0 = blockIdx.y * kPTile;
  const int q0 = c0 / L;
  const int TQ = min(TQ_cap, Q - q0);
  const int r = tid & (L - 1);
  const df g0 = {g0h, g0l};
  const df gd = {gdh, gdl};
  const df zero = {0.f, 0.f};
  const int n_live = *n_live_p;
  const int per = ((n_live + kPST - 1) / kPST + n_split - 1) / n_split * kPST;
  const int s_begin = blockIdx.z * per;
  const int s_end = min(n_live, s_begin + per);
  const int nU = (TQ + aper - 1) / aper;
  const int nW = (L + aper - 1) / aper;
  PHASE_START();

  int qi[kPCPT];
  bool live[kPCPT];
#pragma unroll
  for (int j = 0; j < kPCPT; ++j) {
    live[j] = c0 + tid + j * kThreads < nchan;
    qi[j] = min((tid + j * kThreads) / L, TQ - 1);
  }
  double acc_r[kPNB][kPCPT], acc_i[kPNB][kPCPT];
#pragma unroll
  for (int bi = 0; bi < kPNB; ++bi) {
#pragma unroll
    for (int j = 0; j < kPCPT; ++j) acc_r[bi][j] = acc_i[bi][j] = 0.0;
  }

  // the U and W chains of the tile at s_t into buffer `buf`
  auto build = [&](int s_t, int buf) {
    double2* U = Ubuf + buf * NS * TQ_cap;
    double2* W = Wbuf + buf * NS * L;
    if (tid < kPST) srcs[buf * kPST + tid] = s_t + tid < s_end ? perm[s_t + tid] : 0;
    for (int ch = tid; ch < NS * (nU + nW); ch += kThreads) {
      const int pr = ch / (nU + nW);
      const int a = ch - pr * (nU + nW);
      const int bi = pr / kPST;
      const int s = s_t + (pr - bi * kPST);
      const int b = b0 + bi;
      df p0 = zero;
      df d = zero;
      if (s < s_end && b < B) {
        const int src = perm[s];
        float sh[3], sl[3], bh[3], bl[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          sh[ax] = seh[3 * src + ax];
          sl[ax] = sel[3 * src + ax];
          bh[ax] = blh[3 * b + ax];
          bl[ax] = bll[3 * b + ax];
        }
        const df k = prisim::df_dot3(sh, sl, bh, bl);
        p0 = prisim::df_frac(prisim::df_mul(k, g0));
        d = prisim::df_frac(prisim::df_mul(k, gd));
      }
      double2* dst;
      int n;
      double2 x, step;
      if (a < nU) {                         // U[q0 + m], m in [m0, m0 + n)
        const int m0 = a * aper;
        n = min(aper, TQ - m0);
        dst = U + pr * TQ_cap + m0;
        x = prisim::phasor64(
            cycles(p0, d, static_cast<float>((q0 + m0) * L + chan0)));
        step = prisim::phasor64(cycles(zero, d, static_cast<float>(L)));
      } else {                              // W[m], m in [m0, m0 + n)
        const int m0 = (a - nU) * aper;
        n = min(aper, L - m0);
        dst = W + pr * L + m0;
        x = prisim::phasor64(cycles(zero, d, static_cast<float>(m0)));
        step = prisim::phasor64(cycles(zero, d, 1.f));
      }
      dst[0] = x;
      for (int j = 1; j < n; ++j) {
        x = cmul_rn(x, step);
        dst[j] = x;
      }
    }
  };

  // acc += U * (A W) for the tile at s_t in buffer `buf`
  auto mac = [&](int s_t, int buf) {
    const double2* U = Ubuf + buf * NS * TQ_cap;
    const double2* W = Wbuf + buf * NS * L;
    const int ns = min(kPST, s_end - s_t);
    for (int si = 0; si < ns; ++si) {
      const float* arow = amps +
          static_cast<size_t>(srcs[buf * kPST + si]) * nchan + c0 + tid;
      double a[kPCPT];
#pragma unroll
      for (int j = 0; j < kPCPT; ++j) {
        a[j] = live[j] ? static_cast<double>(__ldg(arow + j * kThreads)) : 0.0;
      }
#pragma unroll
      for (int bi = 0; bi < kPNB; ++bi) {
        const int pr = bi * kPST + si;
        const double2 w = W[pr * L + r];
        const double2* u = U + pr * TQ_cap;
#pragma unroll
        for (int j = 0; j < kPCPT; ++j) {
          const double tr = a[j] * w.x;
          const double ti = a[j] * w.y;
          const double2 uu = u[qi[j]];
          acc_r[bi][j] = fma(uu.x, tr, acc_r[bi][j]);
          acc_r[bi][j] = fma(-uu.y, ti, acc_r[bi][j]);
          acc_i[bi][j] = fma(uu.x, ti, acc_i[bi][j]);
          acc_i[bi][j] = fma(uu.y, tr, acc_i[bi][j]);
        }
      }
    }
  };

  if (s_begin < s_end) build(s_begin, 0);
  __syncthreads();
  PHASE_MARK(0);
  int it = 0;
  for (int s_t = s_begin; s_t < s_end; s_t += kPST, ++it) {
    const int buf = it & 1;
    if (s_t + kPST < s_end) build(s_t + kPST, buf ^ 1);
    PHASE_MARK(1);
    mac(s_t, buf);
    PHASE_MARK(2);
    __syncthreads();
    PHASE_MARK(3);
  }

#pragma unroll
  for (int bi = 0; bi < kPNB; ++bi) {
    const int b = b0 + bi;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < kPCPT; ++j) {
      if (!live[j]) continue;
      part[(static_cast<size_t>(blockIdx.z) * B + b) * nchan + c0 + tid +
           j * kThreads] = make_double2(acc_r[bi][j], acc_i[bi][j]);
    }
  }
  PHASE_MARK(4);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of `mode` (1 K1b, 2 K1c, 3 both) needs
// for a source tile of ST; 0 for an unknown mode.
size_t prisim_nudft_smem(int Q, int L, int ST, int mode) {
  switch (mode) {
    case kModeGrad: return Cfg<2, 2, true, false>::smem(Q, L, ST);
    case kModeExt: return Cfg<2, 4, false, true>::smem(Q, L, ST);
    case kModeGrad | kModeExt: return Cfg<2, 2, true, true>::smem(Q, L, ST);
    default: return 0;
  }
}

// Launch the NUDFT of `mode` (1 K1b, 2 K1c, 3 both; K1a is
// prisim_nudft_point) on `stream`. Pointers are device pointers
// to contiguous float32 arrays: seh/sel (S, 3), blh/bll (B, 3), amps
// (S, nchan), s_sky (S, 3) for K1b or K1c, sigma (S,) for K1c (unused
// ones may be null); `out` is complex64 (B, nchan) and `gout` complex64
// (3, B, nchan) for K1b. L must be a power of two <= 256, 2 * ST <= 256
// and, for K1b, 3 * ST <= 256. Returns the cudaError_t of the launch.
int prisim_nudft(const void* seh, const void* sel, const void* blh,
                 const void* bll, const void* amps, const void* ssky,
                 const void* sigma, void* out, void* gout, int S, int B,
                 int nchan, int Q, int L, int ST, float g0h, float g0l,
                 float gdh, float gdl, int chan0, int mode, void* stream) {
  const bool grad = mode & kModeGrad;
  const bool ext = mode & kModeExt;
  if (L < 1 || L > kThreads || (L & (L - 1)) || ST < 1 || Q * L < nchan ||
      S < 1 || B < 1 || nchan < 1 || (mode & ~(kModeGrad | kModeExt)) ||
      ((grad || ext) && ssky == nullptr) || (ext && sigma == nullptr) ||
      (grad && (gout == nullptr || 3 * ST > kThreads)) || mode == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kModeGrad:
      return launch<2, 2, true, false>(seh, sel, blh, bll, amps, ssky, sigma,
                                       out, gout, S, B, nchan, Q, L, ST, g0h,
                                       g0l, gdh, gdl, chan0, st);
    case kModeExt:
      return launch<2, 4, false, true>(seh, sel, blh, bll, amps, ssky, sigma,
                                       out, gout, S, B, nchan, Q, L, ST, g0h,
                                       g0l, gdh, gdl, chan0, st);
    default:
      return launch<2, 2, true, true>(seh, sel, blh, bll, amps, ssky, sigma,
                                      out, gout, S, B, nchan, Q, L, ST, g0h,
                                      g0l, gdh, gdl, chan0, st);
  }
}

// K1a's blocks: ceil(B / 4) x ceil(nchan / 1024) per split, and how many
// fit on one SM at once (0 on an error).
int prisim_nudft_point_blocks_per_sm(int Q, int L) {
  const size_t smem = point_smem(Q, L);
  if (cudaFuncSetAttribute(nudft_point_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, nudft_point_kernel, kThreads, smem) != cudaSuccess) {
    return 0;
  }
  return n;
}

// Launch K1a on `stream`: float32 seh/sel (S, 3), blh/bll (B, 3), amps
// (S, nchan); perm int32 (S,) with the n_live (int32 on the device) live
// sources first; part float64 (n_split, B, nchan, 2) partial sums, every
// element written. L a power of two <= 256, aper >= 1. Returns the
// cudaError_t of the launch.
int prisim_nudft_point(const void* seh, const void* sel, const void* blh,
                       const void* bll, const void* amps, const void* perm,
                       const void* n_live, void* part, int B, int nchan,
                       int Q, int L, float g0h, float g0l, float gdh,
                       float gdl, int chan0, int aper, int n_split,
                       void* stream) {
  if (L < 1 || L > kThreads || (L & (L - 1)) || Q * L < nchan || B < 1 ||
      nchan < 1 || aper < 1 || n_split < 1 || n_split > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = point_smem(Q, L);
  cudaError_t e = cudaFuncSetAttribute(
      nudft_point_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + kPNB - 1) / kPNB, (nchan + kPTile - 1) / kPTile,
                  n_split);
  nudft_point_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seh), static_cast<const float*>(sel),
      static_cast<const float*>(blh), static_cast<const float*>(bll),
      static_cast<const float*>(amps), static_cast<const int*>(perm),
      static_cast<const int*>(n_live), static_cast<double2*>(part), B, nchan,
      Q, L, point_tq(Q, L), g0h, g0l, gdh, gdl, chan0, aper, n_split);
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
