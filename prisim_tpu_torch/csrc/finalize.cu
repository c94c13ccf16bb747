// Kernel phase_cubes: the finalize's re-phasing of the three visibility
// cubes (sky, sky + noise, noise) and their transpose from the engines'
// (T, B, C) order to the container's (B, C, T), in one pass,
//   out[k, b, c, t] = cube_k[t, b, c] * phasor(path[b, t], nu[c]),
// which is what vis.py::phase_centering computes after the transpose the
// host made of the engine's cube. It replaces no TPU kernel: XLA fused the
// JAX package's chain. Two instances, one for each of phase_centering's
// branches:
//
// complex64 (all three cubes complex64): the cycle count
// x = path * (nu / c) in float64, less rint(x), the angle 2 pi x rounded
// once to float32, the phasor (cos a, -sin a) and the complex64 product
// V * phasor as numpy takes it, (Vr pr - Vi pi, Vr pi + Vi pr). The
// operations are phase_centering's, each rounded on its own (__dmul_rn and
// the like, so that no FMA contracts two), and the angle is the host's bit
// for bit; cos and sin are taken in float64 and rounded to float32, so the
// phasor is the correctly rounded one, where CUDA's sincosf may be 2 ulps
// off and numpy's and torch's float32 cos and sin an ulp. Only the phasor
// may differ from the host's, by an ulp: about zenith (a zero path: the
// phasor is (1, -0)) the cubes are the host's bit for bit, elsewhere they
// agree to an ulp or two of |V|.
//
// complex128 (a cube is complex128, as vis is where a gains file's
// complex128 gains multiplied it; the wrapper widens the others, exactly):
// numpy's exp(-2j pi path nu / c) with its evaluation order, the argument
// y = ((-2 pi path) nu) (1 / c), each product rounded (numpy divides a
// complex by c through the reciprocal 1 / c), the phasor (cos y, sin y)
// in float64 and the complex128 product. The argument is the host's bit
// for bit; cos, sin and the product agree to a few float64 ulps.
//
// Without a path (no phasing) either instance transposes.
//
// What bounds it on the H100: HBM, reading three (T, B, C) complex64 cubes
// and writing them once (774 MB at the north star's 630 x 1024 x 25,
// 0.23 ms at 3.35 TB/s); the float64 cycle count, cosine and sine (a few
// dozen FP64 operations), once an element for the three cubes, are far
// from the FP64 peak.
// Layout: one block of 256 threads per (baseline, tile of channels: 32 of
// complex64, 16 of complex128, 256 bytes a row), looping over tiles of 32
// accumulations. The block reads each cube's tile along C (t-major, so a
// warp reads whole 256-byte rows of one accumulation) into shared memory,
// padded by one element a row against bank conflicts, and writes it along
// T: for one baseline the output's (c, t) elements of a tile are
// contiguous in memory whenever the tile holds every accumulation
// (T <= 32), so a warp writes consecutive bytes. The baseline's path row
// for the tile and the tile's channel values stay in shared memory; the
// phasor is computed once an element and applied to the three cubes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileT = 32;
constexpr int kCubes = 3;
// 2.0 * np.pi as Python evaluates it, before the product with the cycles
constexpr double kTwoPi = 6.283185307179586;

template <typename V>
struct Phase;

// phase_centering's complex64 branch
template <>
struct Phase<float2> {
  static constexpr int kTileC = 32;
  // per accumulation: the path; per channel: nu / c
  __device__ static double row(double path) { return path; }
  __device__ static double col(double nu, double c) {
    return __ddiv_rn(nu, c);
  }
  __device__ static float2 phasor(double row, double col, double) {
    const double x = __dmul_rn(row, col);
    const double cyc = __dsub_rn(x, rint(x));
    const float ang = __double2float_rn(__dmul_rn(kTwoPi, cyc));
    double s, co;
    sincos(static_cast<double>(ang), &s, &co);
    return make_float2(__double2float_rn(co), -__double2float_rn(s));
  }
  __device__ static float2 mul(float2 v, float2 p) {
    return make_float2(__fsub_rn(__fmul_rn(v.x, p.x), __fmul_rn(v.y, p.y)),
                       __fadd_rn(__fmul_rn(v.x, p.y), __fmul_rn(v.y, p.x)));
  }
};

// phase_centering's other branch: np.exp of the complex128 argument
template <>
struct Phase<double2> {
  static constexpr int kTileC = 16;
  // per accumulation: -2 pi path; per channel: nu
  __device__ static double row(double path) {
    return __dmul_rn(-kTwoPi, path);
  }
  __device__ static double col(double nu, double) { return nu; }
  __device__ static double2 phasor(double row, double col, double inv_c) {
    const double y = __dmul_rn(__dmul_rn(row, col), inv_c);
    double s, co;
    sincos(y, &s, &co);
    return make_double2(co, s);
  }
  __device__ static double2 mul(double2 v, double2 p) {
    return make_double2(
        __dsub_rn(__dmul_rn(v.x, p.x), __dmul_rn(v.y, p.y)),
        __dadd_rn(__dmul_rn(v.x, p.y), __dmul_rn(v.y, p.x)));
  }
};

template <typename V, bool kPhase>
__global__ void __launch_bounds__(kThreads)
phase_cubes_kernel(const V* __restrict__ sky, const V* __restrict__ vis,
                   const V* __restrict__ noise, V* __restrict__ out,
                   const double* __restrict__ path,
                   const double* __restrict__ freqs, double c, int T, int B,
                   int C) {
  using P = Phase<V>;
  constexpr int kTileC = P::kTileC;
  __shared__ V tile[kCubes][kTileC][kTileT + 1];
  __shared__ double row_t[kTileT];
  __shared__ double col_c[kTileC];

  const int n_ct = (C + kTileC - 1) / kTileC;
  const int b = blockIdx.x / n_ct;
  const int c0 = (blockIdx.x - b * n_ct) * kTileC;
  const int nc = min(kTileC, C - c0);
  const size_t plane = static_cast<size_t>(B) * C * T;
  const V* const cubes[kCubes] = {sky, vis, noise};
  const double inv_c = kPhase ? __drcp_rn(c) : 0.0;

  if (kPhase && threadIdx.x < nc) {
    col_c[threadIdx.x] = P::col(freqs[c0 + threadIdx.x], c);
  }
  for (int t0 = 0; t0 < T; t0 += kTileT) {
    const int nt = min(kTileT, T - t0);
    if (kPhase && threadIdx.x < nt) {
      row_t[threadIdx.x] =
          P::row(path[static_cast<size_t>(b) * T + t0 + threadIdx.x]);
    }
    // read along C
    for (int j = threadIdx.x; j < nt * nc; j += kThreads) {
      const int tl = j / nc;
      const int cl = j - tl * nc;
      const size_t src =
          (static_cast<size_t>(t0 + tl) * B + b) * C + c0 + cl;
#pragma unroll
      for (int k = 0; k < kCubes; ++k) tile[k][cl][tl] = cubes[k][src];
    }
    __syncthreads();
    // write along T
    for (int j = threadIdx.x; j < nc * nt; j += kThreads) {
      const int cl = j / nt;
      const int tl = j - cl * nt;
      const size_t dst =
          (static_cast<size_t>(b) * C + c0 + cl) * T + t0 + tl;
      if (kPhase) {
        const V p = P::phasor(row_t[tl], col_c[cl], inv_c);
#pragma unroll
        for (int k = 0; k < kCubes; ++k) {
          out[k * plane + dst] = P::mul(tile[k][cl][tl], p);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kCubes; ++k) {
          out[k * plane + dst] = tile[k][cl][tl];
        }
      }
    }
    __syncthreads();
  }
}

template <typename V>
int launch(const void* sky, const void* vis, const void* noise, void* out,
           const void* path, const void* freqs, double c, int T, int B,
           int C, cudaStream_t st) {
  const int64_t blocks = static_cast<int64_t>(B) *
                         ((C + Phase<V>::kTileC - 1) / Phase<V>::kTileC);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s = static_cast<const V*>(sky);
  const auto* v = static_cast<const V*>(vis);
  const auto* n = static_cast<const V*>(noise);
  auto* o = static_cast<V*>(out);
  const auto* p = static_cast<const double*>(path);
  const auto* f = static_cast<const double*>(freqs);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (p != nullptr) {
    phase_cubes_kernel<V, true><<<grid, kThreads, 0, st>>>(s, v, n, o, p, f,
                                                           c, T, B, C);
  } else {
    phase_cubes_kernel<V, false><<<grid, kThreads, 0, st>>>(s, v, n, o, p,
                                                            f, c, T, B, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch phase_cubes on `stream`. Device pointers: sky, vis, noise the
// contiguous (T, B, C) cubes, complex64 or (wide != 0) complex128; out the
// contiguous (3, B, C, T) result of the same type, every element written;
// path the contiguous (B, T) float64 path differences (m) and freqs the
// (C,) float64 channel frequencies (Hz), or both null for a transpose
// without phasing; c the speed of light (m/s). Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for bad sizes or a lone null).
int prisim_phase_cubes(const void* sky, const void* vis, const void* noise,
                       void* out, const void* path, const void* freqs,
                       double c, int T, int B, int C, int wide,
                       void* stream) {
  if (T < 1 || B < 1 || C < 1 || (path == nullptr) != (freqs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return wide ? launch<double2>(sky, vis, noise, out, path, freqs, c, T, B,
                                C, st)
              : launch<float2>(sky, vis, noise, out, path, freqs, c, T, B,
                               C, st);
}

}  // extern "C"
