// Kernel airy_amps: the direct snapshot's beam-weighted fluxes for a
// chromatic Airy dish, in one pass over the (S, C) table,
//   amps[s, c] = (2 J1(x) / x)^2 flux[s, c],   x = a[c] sin(theta_s),
// and 0 where the source is not above the horizon (s_z > 0 fails) or lies
// behind the beam axis. It computes what engine/observe.py::_beam_and_flux
// computes with beams/analytic.py::airy_beam and bessel_j1, and replaces no
// TPU kernel: XLA fused that chain into one pass on the TPU, where the port
// ran it as about a hundred eager torch launches, each over the whole table.
//
// Arithmetic, operation for operation in the chain's order: sin(theta) as
// _offaxis_sin takes it (sqrt(clip(l^2 + m^2, 0, 1)) about zenith; with an
// axis p, cos = clip(s.p, -1, 1) and sqrt(clip(1 - cos^2, 0, 1))), the
// |x| < 1e-6 series 1 - x^2/8, 2 J1(x)/x with J1 by the Clenshaw recurrence
// on the chain's float32 Chebyshev coefficients (|x| < 8, passed in by the
// wrapper) or the asymptotic form (|x| >= 8), the square and the flux. Each
// torch launch rounds one operation, so every operation here is rounded on
// its own: __fmul_rn / __fadd_rn / __fsub_rn (never contracted into an FMA),
// IEEE division, reciprocal and square root, the accurate sinf and cosf, no
// fast math. torch takes `8.0 / ax` and `0.636619772 / ax` as reciprocal(ax)
// times the constant (Tensor.__rtruediv__), and so does this kernel. Only
// the branch that applies is computed; a source that is not live writes
// zeros and never reads its flux. The one operation that can differ is s.p
// (torch takes it through a matrix product, in its own order), so with an
// axis off zenith the amplitudes agree to rounding, not bit for bit.
//
// What bounds it on the H100: HBM, reading the live rows' flux once and
// writing the table once (4.8 GB a north-star snapshot, 1.4 ms at
// 3.35 TB/s), with FP32 throughput close behind (about a hundred
// single-rounded operations a live entry, none fused). Layout: a block is
// 256 threads over rows x quads of channels; each thread takes four
// consecutive channels of one row with 16-byte streaming loads and stores
// (scalar ones where C is not a multiple of 4 or a pointer is not 16-byte
// aligned), so neighbouring threads touch neighbouring addresses, a warp
// covers 128 channels of one row, and x grows along the warp (the |x| < 8
// branch splits it at most once). The grid has a block for every
// 256 / (C / 4) rows: 786,432 blocks at the north star's 1024 channels,
// 49,152 at 256 channels.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCheb = 27;        // bessel_j1's degree-26 Chebyshev series

struct Cheb {
  float c[kCheb];
};

struct Axis {
  float x, y, z;
  int on;                        // 0: zenith, sin = sqrt(l^2 + m^2)
};

// A Python float constant as torch casts it to float32.
#define F32(v) static_cast<float>(v)

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// torch.clip: a NaN passes through.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// sin(angle from the axis) of a source, and whether its amplitudes are
// live: above the horizon and, with an axis, not behind it.
__device__ __forceinline__ bool offaxis_sin(const float* s, const Axis& p,
                                            float& sin_t) {
  const float sx = s[0], sy = s[1], sz = s[2];
  if (!(sz > 0.0f)) return false;
  if (!p.on) {
    sin_t = __fsqrt_rn(clip(add(mul(sx, sx), mul(sy, sy)), 0.0f, 1.0f));
    return true;
  }
  const float c =
      clip(add(add(mul(sx, p.x), mul(sy, p.y)), mul(sz, p.z)), -1.0f, 1.0f);
  if (c < 0.0f) return false;
  sin_t = __fsqrt_rn(clip(sub(1.0f, mul(c, c)), 0.0f, 1.0f));
  return true;
}

// bessel_j1 for |x| < 8: x g(x^2), g by the Clenshaw recurrence
// b1 <- t2 b1 - b2 + c from the highest coefficient down.
__device__ __forceinline__ float j1_series(float x, const Cheb& cb) {
  const float t = sub(mul(mul(x, x), 0.03125f), 1.0f);
  const float t2 = mul(2.0f, t);
  float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
  for (int i = kCheb - 1; i >= 1; --i) {
    const float b = add(sub(mul(t2, b1), b2), cb.c[i]);
    b2 = b1;
    b1 = b;
  }
  return mul(x, add(sub(mul(t, b1), b2), cb.c[0]));
}

// bessel_j1 for |x| >= 8 (where its clamp of |x| at 1e-20 is no-op).
__device__ __forceinline__ float j1_asymptotic(float x) {
  const float ax = fabsf(x);
  const float r = __frcp_rn(ax);
  const float z = mul(r, 8.0f);
  const float y2 = mul(z, z);
  const float p1 = add(1.0f, mul(y2, add(F32(0.183105e-2), mul(y2,
      add(F32(-0.3516396496e-4), mul(y2, add(F32(0.2457520174e-5),
      mul(y2, F32(-0.240337019e-6)))))))));
  const float p2 = add(F32(0.04687499995), mul(y2, add(F32(-0.2002690873e-3),
      mul(y2, add(F32(0.8449199096e-5), mul(y2, add(F32(-0.88228987e-6),
      mul(y2, F32(0.105787412e-6)))))))));
  const float xx = sub(ax, F32(2.356194491));
  const float q = sub(mul(cosf(xx), p1), mul(mul(z, sinf(xx)), p2));
  const float sign = static_cast<float>((0.0f < x) - (x < 0.0f));
  return mul(mul(__fsqrt_rn(mul(r, F32(0.636619772))), q), sign);
}

// airy_beam's power pattern at x = a sin(theta).
__device__ __forceinline__ float airy_power(float x, const Cheb& cb) {
  float pat;
  if (fabsf(x) < F32(1e-6)) {
    pat = sub(1.0f, mul(mul(x, x), 0.125f));
  } else {
    const float j1 = fabsf(x) < 8.0f ? j1_series(x, cb) : j1_asymptotic(x);
    pat = __fdiv_rn(mul(2.0f, j1), x);
  }
  return mul(pat, pat);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    airy_amps_kernel(const float* __restrict__ s,
                     const float* __restrict__ flux,
                     const float* __restrict__ a, float* __restrict__ out,
                     int S, int C, Axis p, Cheb cb) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * 4;
  if (row >= S || c0 >= C) return;
  float sin_t = 0.0f;
  const bool live = offaxis_sin(s + 3 * row, p, sin_t);
  const int64_t at = row * C + c0;
  if (kVec) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live) {
      const float4 f = __ldcs(reinterpret_cast<const float4*>(flux + at));
      const float4 av = __ldg(reinterpret_cast<const float4*>(a + c0));
      v.x = mul(airy_power(mul(av.x, sin_t), cb), f.x);
      v.y = mul(airy_power(mul(av.y, sin_t), cb), f.y);
      v.z = mul(airy_power(mul(av.z, sin_t), cb), f.z);
      v.w = mul(airy_power(mul(av.w, sin_t), cb), f.w);
    }
    __stcs(reinterpret_cast<float4*>(out + at), v);
  } else {
    const int n = C - c0 < 4 ? C - c0 : 4;
    for (int k = 0; k < n; ++k) {
      out[at + k] = live ? mul(airy_power(mul(__ldg(a + c0 + k), sin_t), cb),
                               __ldcs(flux + at + k))
                         : 0.0f;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Launch airy_amps on `stream`. Device pointers to contiguous float32
// arrays: s (S, 3) ENU direction cosines, flux (S, C), a (C,) the channels'
// k D/2, out (S, C), every element written. axis: null for zenith, else a
// host pointer to the unit axis (3 floats). cheb: a host pointer to the
// n_cheb (27) Chebyshev coefficients of bessel_j1. Returns the cudaError_t
// of the launch (cudaErrorInvalidValue for bad sizes).
int prisim_airy_amps(const void* s, const void* flux, const void* a,
                     void* out, int S, int C, const float* axis,
                     const float* cheb, int n_cheb, void* stream) {
  if (S < 1 || C < 1 || n_cheb != kCheb || cheb == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cheb cb;
  for (int i = 0; i < kCheb; ++i) cb.c[i] = cheb[i];
  Axis p{0.0f, 0.0f, 0.0f, 0};
  if (axis != nullptr) p = Axis{axis[0], axis[1], axis[2], 1};
  const int nq = (C + 3) / 4;
  const int bx = nq >= kThreads ? kThreads : (nq + 31) / 32 * 32;
  const int by = kThreads / bx;
  const dim3 block(bx, by);
  const dim3 grid((S + by - 1) / by, (nq + bx - 1) / bx);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const float*>(s);
  const auto* fp = static_cast<const float*>(flux);
  const auto* ap = static_cast<const float*>(a);
  auto* op = static_cast<float*>(out);
  if (C % 4 == 0 && aligned16(fp) && aligned16(ap) && aligned16(op)) {
    airy_amps_kernel<true><<<grid, block, 0, st>>>(sp, fp, ap, op, S, C, p,
                                                   cb);
  } else {
    airy_amps_kernel<false><<<grid, block, 0, st>>>(sp, fp, ap, op, S, C, p,
                                                    cb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
