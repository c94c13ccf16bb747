// Kernels K1a, K1b and K1c: NUDFT visibilities for Hopper (sm_90a).
//
// Replace the three modes of the TPU kernel
// prisim_tpu/engine/pallas_nudft.py::_kernel. All three are instances of
// one kernel, nudft_k1<kGrad, kExt>: K1a (point sources) <false, false>,
// K1b (gradient moments) <true, false>, K1c (extended sources)
// <false, true>, and both modes at once <true, true>. On a uniform channel
// grid nu_c = nu0 + (chan0 + c) dnu they compute
//   V[b, c]   = sum_s A[s, c] w[s, b, c] exp(-2 pi i nu_c (s_eff . b) / c_l)
//   G_k[b, c] = sum_s s_sky[s, k] A[s, c] w[s, b, c] exp(...)   (K1b)
//   w[s, b, c] = exp(-alpha[s, b] (nu_c / c_l)^2),                (K1c)
//   alpha = max(|b|^2 - (s_sky . b)^2, 0) / (2 sigma_s^2),
// with w = 1 for K1a and K1b alone, and for sigma = inf (a point source).
//
// Arithmetic, as in the plain version (engine/nudft.py): the delay
// k = s.b and the cycle counts p0 = k nu0/c, d = k dnu/c are two-float
// and reduced mod 1; with c = q L + r the phasor is U[s,b,q] W[s,b,r],
// where U is taken at the cycle count p0 + (q L + chan0) d and W at r d.
// The products are summed in float64. (On the slice shape an f32 phasor
// and product chain floors at 2.1e-6 of max|V| against the f64 golden
// even with an exact sum, above the engines' 2e-6 bar; see PERF.md.) The
// f64 sums need no Kahan compensation. The gaussian weight is float32:
// alpha is taken in float64 with every rounding pinned (__dadd_rn,
// __dmul_rn, __ddiv_rn) and rounded to float32, as is the channel factor
// (nu_c/c)^2, and w = expf(-alpha k2) with the accurate expf (no fast
// math), so that the weight equals the plain version's. A w is exact in
// float64, and so is its product with the f32 amplitude.
//
// What bounds it on the H100: float64 issue (64 FP64 lanes per SM and
// clock, half the FP32 rate). The least a term can take is 6 FP64
// instructions for K1a (2 DMUL for A W and 4 DFMA into the accumulators;
// ~10 ms at the slice's 666 x 1024 x 49,152 terms, 5 ms counting only the
// sources above the horizon), 14 for K1b (A W, E = U (A W) once, V += E
// and the three G_k += s_k E) and 7 for K1c (one DMUL by the weight), whose
// weight also takes an expf (FP32 and MUFU pipes) and a conversion per
// term. What the earlier one-phasor-per-sincospi template cost on top
// (K1a 69.6 ms, K1b 96.0 ms, K1c 95.6 ms at the slice on an H100 80GB
// HBM3 at 700 W), and what this kernel does about it:
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
// 2. The least MAC of each mode: tr = A w.re, ti = A w.im (2 DMUL), then
//    for K1a and K1c 4 DFMA chained into the accumulators; for K1b E once
//    (2 DMUL, 2 DFMA), 2 DADD into V and 6 DFMA into the moments, whose
//    s_k of the tile's sources sit in shared memory.
// 3. Fewer conversions: a block owns NB baselines (accumulators in
//    registers), so each f32 -> f64 amplitude conversion feeds NB terms.
//    Shape<> sets NB, the channels per thread CPT, the sources per tile
//    ST and the blocks per SM that __launch_bounds__ asks registers for,
//    per mode, all without spills: 4 x 4, 8 sources a tile, 2 blocks per
//    SM for K1a and K1c (K1c keeps each pair's alpha in shared memory
//    beside its chains and its 4 channel factors in registers). K1b
//    carries 4 outputs, so 4 x 4 would take 128 doubles of accumulators;
//    at 4 x 2 or 2 x 4 (225-228 registers) only one block fits on an SM,
//    and 2 x 2 at two blocks ran faster at 8, 16 and 32 sources a tile,
//    fastest at 32, where 192 of the 256 threads build chains
//    (profile_banded.py --k1-shapes, PERF.md).
// 4. Pipelined tiles: the phasor tables are double-buffered; the chains of
//    tile i + 1 are built into one buffer while the MACs of tile i read the
//    other, one barrier per tile. The build needs no separate pass: each
//    chain derives its pair's two-float scalars.
// 5. Only live sources: the wrapper orders the sources whose amplitudes
//    are not all zero first (stable) and passes their count; the zero rows
//    below the horizon add exact zeros and are not visited. Every
//    per-source input (directions, amplitudes, s_sky, sigma) is read
//    through the same permutation.
// 6. The grid splits the live sources into n_split contiguous ranges so
//    that the blocks fill whole waves of the card; each split writes float64
//    partial sums, which the wrapper adds in split order. Every output has
//    one writer per split and a sum order fixed by the data.
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

// Modes of the C interface (bit flags; 0 is K1a).
constexpr int kModeGrad = 1;
constexpr int kModeExt = 2;

// NB baselines per block, CPT channels per thread, ST sources per tile,
// and the blocks per SM that __launch_bounds__ asks registers for.
template <bool kGrad, bool kExt>
struct Shape {                                           // K1a
  static constexpr int NB = 4, CPT = 4, ST = 8, kMinBlocks = 2;
};
template <>
struct Shape<false, true> {                              // K1c
  static constexpr int NB = 4, CPT = 4, ST = 8, kMinBlocks = 2;
};
template <bool kExt>
struct Shape<true, kExt> {                               // K1b, K1b + K1c
  static constexpr int NB = 2, CPT = 2, ST = 32, kMinBlocks = 2;
};

template <bool kGrad, bool kExt>
struct Cfg : Shape<kGrad, kExt> {
  using S = Shape<kGrad, kExt>;
  // a tile's source indices (and its s_k, 3 a source) are filled by one
  // thread each
  static_assert(S::ST <= kThreads && (!kGrad || 3 * S::ST <= kThreads),
                "a tile has more sources than the block can fill");
  static constexpr int kTile = kThreads * S::CPT;       // channels per block
  static constexpr int NS = S::NB * S::ST;              // (baseline, source) pairs
  static int tq(int Q, int L) { return (kTile / L < Q) ? kTile / L : Q; }
  // Shared-memory bytes of one block: the double-buffered U and W tables
  // and source indices, then the tile's s_k (K1b) and alphas (K1c).
  static size_t smem(int Q, int L) {
    return 2 * static_cast<size_t>(NS) * (tq(Q, L) + L) * sizeof(double2) +
           2 * S::ST * sizeof(int) +
           (kGrad ? 2 * 3 * S::ST * sizeof(double) : 0) +
           (kExt ? 2 * NS * sizeof(float) : 0);
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

template <bool kGrad, bool kExt>
__global__ void __launch_bounds__(kThreads, Shape<kGrad, kExt>::kMinBlocks)
nudft_k1(const float* __restrict__ seh, const float* __restrict__ sel,
         const float* __restrict__ blh, const float* __restrict__ bll,
         const float* __restrict__ amps, const float* __restrict__ ssky,
         const float* __restrict__ sigma, const int* __restrict__ perm,
         const int* __restrict__ n_live_p, double2* __restrict__ part,
         int B, int nchan, int Q, int L, int TQ_cap, float g0h, float g0l,
         float gdh, float gdl, int chan0, int aper, int n_split) {
  using C = Cfg<kGrad, kExt>;
  constexpr int NB = C::NB, CPT = C::CPT, NS = C::NS, kTile = C::kTile;
  constexpr int kST = C::ST;                // sources per tile
  constexpr int kOut = kGrad ? 4 : 1;       // V, then G_0..G_2
  extern __shared__ double2 smem[];
  double2* Ubuf = smem;                     // [2][NS][TQ_cap]
  double2* Wbuf = Ubuf + 2 * NS * TQ_cap;   // [2][NS][L]
  int* srcs = reinterpret_cast<int*>(Wbuf + 2 * NS * L);           // [2][kST]
  double* skbuf = reinterpret_cast<double*>(srcs + 2 * kST);       // [2][kST][3]
  float* alphabuf = reinterpret_cast<float*>(skbuf + (kGrad ? 6 * kST : 0));
                                                                   // [2][NS]

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * NB;
  const int c0 = blockIdx.y * kTile;
  const int q0 = c0 / L;
  const int TQ = min(TQ_cap, Q - q0);
  const int r = tid & (L - 1);
  const df g0 = {g0h, g0l};
  const df gd = {gdh, gdl};
  const df zero = {0.f, 0.f};
  const int n_live = *n_live_p;
  const int per = ((n_live + kST - 1) / kST + n_split - 1) / n_split * kST;
  const int s_begin = blockIdx.z * per;
  const int s_end = min(n_live, s_begin + per);
  const int nU = (TQ + aper - 1) / aper;
  const int nW = (L + aper - 1) / aper;
  PHASE_START();

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
  double acc_r[kOut][NB][CPT], acc_i[kOut][NB][CPT];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc_r[o][bi][j] = acc_i[o][bi][j] = 0.0;
    }
  }

  // the U and W chains of the tile at s_t into buffer `buf`, with the
  // tile's source indices, s_k (K1b) and alphas (K1c)
  auto build = [&](int s_t, int buf) {
    double2* U = Ubuf + buf * NS * TQ_cap;
    double2* W = Wbuf + buf * NS * L;
    if (tid < kST) srcs[buf * kST + tid] = s_t + tid < s_end ? perm[s_t + tid] : 0;
    if constexpr (kGrad) {
      if (tid < 3 * kST) {
        const int i = tid / 3;
        skbuf[buf * 3 * kST + tid] =
            s_t + i < s_end
                ? static_cast<double>(ssky[3 * perm[s_t + i] + tid - 3 * i])
                : 0.0;
      }
    }
    for (int ch = tid; ch < NS * (nU + nW); ch += kThreads) {
      const int pr = ch / (nU + nW);
      const int a = ch - pr * (nU + nW);
      const int bi = pr / kST;
      const int s = s_t + (pr - bi * kST);
      const int b = b0 + bi;
      df p0 = zero;
      df d = zero;
      float alpha = 0.f;
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
        if constexpr (kExt) {
          if (a == 0) alpha = ext_alpha(ssky + 3 * src, sigma[src], bh, bl);
        }
      }
      if constexpr (kExt) {
        if (a == 0) alphabuf[buf * NS + pr] = alpha;
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

  // acc += U * (A w W) for the tile at s_t in buffer `buf`, and the moments
  auto mac = [&](int s_t, int buf) {
    const double2* U = Ubuf + buf * NS * TQ_cap;
    const double2* W = Wbuf + buf * NS * L;
    const int ns = min(kST, s_end - s_t);
    for (int si = 0; si < ns; ++si) {
      const float* arow = amps +
          static_cast<size_t>(srcs[buf * kST + si]) * nchan + c0 + tid;
      double a[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        a[j] = live[j] ? static_cast<double>(__ldg(arow + j * kThreads)) : 0.0;
      }
      double s3[3];
      if constexpr (kGrad) {
#pragma unroll
        for (int k = 0; k < 3; ++k) s3[k] = skbuf[buf * 3 * kST + 3 * si + k];
      }
#pragma unroll
      for (int bi = 0; bi < NB; ++bi) {
        const int pr = bi * kST + si;
        const double2 w = W[pr * L + r];
        const double2* u = U + pr * TQ_cap;
        float alpha = 0.f;
        if constexpr (kExt) alpha = alphabuf[buf * NS + pr];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          double aw = a[j];
          if constexpr (kExt) {
            aw *= static_cast<double>(expf(-__fmul_rn(alpha, k2[j])));
          }
          const double tr = aw * w.x;
          const double ti = aw * w.y;
          const double2 uu = u[qi[j]];
          if constexpr (kGrad) {
            const double er = fma(uu.x, tr, -(uu.y * ti));
            const double ei = fma(uu.x, ti, uu.y * tr);
            acc_r[0][bi][j] += er;
            acc_i[0][bi][j] += ei;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              acc_r[1 + k][bi][j] = fma(s3[k], er, acc_r[1 + k][bi][j]);
              acc_i[1 + k][bi][j] = fma(s3[k], ei, acc_i[1 + k][bi][j]);
            }
          } else {
            acc_r[0][bi][j] = fma(uu.x, tr, acc_r[0][bi][j]);
            acc_r[0][bi][j] = fma(-uu.y, ti, acc_r[0][bi][j]);
            acc_i[0][bi][j] = fma(uu.x, ti, acc_i[0][bi][j]);
            acc_i[0][bi][j] = fma(uu.y, tr, acc_i[0][bi][j]);
          }
        }
      }
    }
  };

  if (s_begin < s_end) build(s_begin, 0);
  __syncthreads();
  PHASE_MARK(0);
  int it = 0;
  for (int s_t = s_begin; s_t < s_end; s_t += kST, ++it) {
    const int buf = it & 1;
    if (s_t + kST < s_end) build(s_t + kST, buf ^ 1);
    PHASE_MARK(1);
    mac(s_t, buf);
    PHASE_MARK(2);
    __syncthreads();
    PHASE_MARK(3);
  }

#pragma unroll
  for (int o = 0; o < kOut; ++o) {
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      const int b = b0 + bi;
      if (b >= B) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (!live[j]) continue;
        part[((static_cast<size_t>(blockIdx.z) * kOut + o) * B + b) * nchan +
             c0 + tid + j * kThreads] =
            make_double2(acc_r[o][bi][j], acc_i[o][bi][j]);
      }
    }
  }
  PHASE_MARK(4);
}

// Baselines per block, channels per block and the blocks that fit on one
// SM at once (0 on an error) of the instance <kGrad, kExt>.
template <bool kGrad, bool kExt>
int shape(int Q, int L, int* out) {
  using C = Cfg<kGrad, kExt>;
  out[0] = C::NB;
  out[1] = C::kTile;
  out[2] = 0;
  const size_t smem = C::smem(Q, L);
  if (cudaFuncSetAttribute(nudft_k1<kGrad, kExt>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return 0;
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[2], nudft_k1<kGrad, kExt>, kThreads, smem) != cudaSuccess) {
    out[2] = 0;
  }
  return 0;
}

template <bool kGrad, bool kExt>
int launch(const void* seh, const void* sel, const void* blh, const void* bll,
           const void* amps, const void* ssky, const void* sigma,
           const void* perm, const void* n_live, void* part, int B, int nchan,
           int Q, int L, float g0h, float g0l, float gdh, float gdl,
           int chan0, int aper, int n_split, cudaStream_t stream) {
  using C = Cfg<kGrad, kExt>;
  const size_t smem = C::smem(Q, L);
  // set at every launch: shape() of another (Q, L) may have lowered it
  cudaError_t e = cudaFuncSetAttribute(
      nudft_k1<kGrad, kExt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + C::NB - 1) / C::NB, (nchan + C::kTile - 1) / C::kTile,
                  n_split);
  nudft_k1<kGrad, kExt><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(seh), static_cast<const float*>(sel),
      static_cast<const float*>(blh), static_cast<const float*>(bll),
      static_cast<const float*>(amps), static_cast<const float*>(ssky),
      static_cast<const float*>(sigma), static_cast<const int*>(perm),
      static_cast<const int*>(n_live), static_cast<double2*>(part), B, nchan,
      Q, L, C::tq(Q, L), g0h, g0l, gdh, gdl, chan0, aper, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The block shape of `mode` (0 K1a, 1 K1b, 2 K1c, 3 K1b + K1c): out[0]
// baselines per block, out[1] channels per block, out[2] the blocks that
// fit on one SM at once (0 on an error). Returns cudaErrorInvalidValue
// for an unknown mode, else 0.
int prisim_nudft_shape(int mode, int Q, int L, int* out) {
  switch (mode) {
    case 0: return shape<false, false>(Q, L, out);
    case kModeGrad: return shape<true, false>(Q, L, out);
    case kModeExt: return shape<false, true>(Q, L, out);
    case kModeGrad | kModeExt: return shape<true, true>(Q, L, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch the NUDFT of `mode` on `stream`. Pointers are device pointers to
// contiguous arrays: float32 seh/sel (S, 3), blh/bll (B, 3), amps
// (S, nchan), s_sky (S, 3) for K1b or K1c and sigma (S,) for K1c (unused
// ones may be null); perm int32 (S,) with the n_live (int32 on the
// device) live sources first; part float64 (n_split, 1 or 4, B, nchan, 2)
// partial sums of V (and G_0..G_2 for K1b), every element written. L a
// power of two <= 256, aper >= 1. Returns the cudaError_t of the launch.
int prisim_nudft_launch(const void* seh, const void* sel, const void* blh,
                        const void* bll, const void* amps, const void* ssky,
                        const void* sigma, const void* perm,
                        const void* n_live, void* part, int B, int nchan,
                        int Q, int L, float g0h, float g0l, float gdh,
                        float gdl, int chan0, int aper, int n_split, int mode,
                        void* stream) {
  const bool grad = mode & kModeGrad;
  const bool ext = mode & kModeExt;
  if (L < 1 || L > kThreads || (L & (L - 1)) || Q * L < nchan || B < 1 ||
      nchan < 1 || aper < 1 || n_split < 1 || n_split > 65535 ||
      (mode & ~(kModeGrad | kModeExt)) ||
      ((grad || ext) && ssky == nullptr) || (ext && sigma == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
#define PRISIM_LAUNCH(G, E)                                                  \
  launch<G, E>(seh, sel, blh, bll, amps, ssky, sigma, perm, n_live, part, B, \
               nchan, Q, L, g0h, g0l, gdh, gdl, chan0, aper, n_split, st)
  switch (mode) {
    case 0: return PRISIM_LAUNCH(false, false);
    case kModeGrad: return PRISIM_LAUNCH(true, false);
    case kModeExt: return PRISIM_LAUNCH(false, true);
    default: return PRISIM_LAUNCH(true, true);
  }
#undef PRISIM_LAUNCH
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
