// Kernel banded_prep: the banded engine's prep of one source chunk
// (engine/nufft_banded.py, make_banded_snapshot_fns) in one pass:
//   * the celestial two-float source vectors rotated to (E, N, U) and the
//     phase centre subtracted (observe.df_rotate3, then twofloat.df_add);
//   * the two-float u stream of every direction d, u = s_eff . b_hat_d
//     (nufft_banded._two_float_u), with the unit-source check `ok`
//     (|u_hi| <= 2 + 1e-4 over every source and direction);
//   * where the truth beam is the Airy dish's float64 pattern
//     (beams/analytic.py::airy_beam_df), the float64 payload
//     P_r[k, s] = sum_j airy(s, nu_j)^2 flux[s, j] node2coef[j, k]
//     in the (r, S_pad) layout kernel K2 takes.
// Sources s in [S, S_pad) are pads: u = pad_u, u_lo = 0, payload 0. On
// request it also writes the rotated (sh, sl) and centred (seh, sel)
// vectors, which the other payloads and the gate's direct side take.
// It replaces no TPU kernel: XLA fused this chain on the TPU (the JAX
// package's nufft_banded.py, in two-float float32), where the port ran it
// as hundreds of eager torch launches, each over a (D, S) or (S, r) table.
//
// Arithmetic. Every float32 operation is the chain's, in its order, each
// rounded on its own (twofloat.cuh: nothing is contracted into an FMA), so
// the u streams, the vectors and `ok` are the chain's bit for bit; two_prod
// takes its error term from an FMA, which is exact, as the chain's
// Veltkamp split is. The Airy pattern follows airy_beam_df's float64
// operations in order (__dadd_rn, __dmul_rn, __dsqrt_rn; no fast math) and
// evaluates only the Clenshaw series that its x selects, where the chain
// evaluates both and keeps one. The node-to-coefficient product sums its r
// terms in node order by FMA, where the chain's cuBLAS product takes its
// own order: P_r agrees to float64 rounding, and a source below the
// horizon gets a payload of exactly zero, as in the chain.
//
// What bounds it on the H100: HBM. A north-star chunk (262,144 sources,
// 384 directions, rank 32) writes the u streams (8 B a source and
// direction: 805 MB) and the payload (67 MB) and reads the node fluxes
// (67 MB) and the source vectors (6 MB) once: 0.28 ms at 3.35 TB/s. The
// float32 work (about 50 single-rounded operations a source and direction)
// and the float64 Airy series (27 or 41 Clenshaw terms a node) come close
// behind. Layout: one thread a source, 256 a block. The directions pass
// through shared memory a tile at a time, each read by all threads at once
// (a broadcast), so that a warp writes 128 consecutive bytes of each stream
// for each direction. The node-to-coefficient matrix sits in shared memory;
// each thread keeps its r sums in registers and writes its column of P_r,
// coalesced along s.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "twofloat.cuh"

namespace {

using prisim::df;

constexpr int kThreads = 256;
constexpr int kMaxRank = 32;
constexpr int kJ1 = 27;          // bessel_j1's degree-26 fit on [0, 8)
constexpr int kTail = 41;        // airy_beam_df's degree-40 fit on [8, 32]
constexpr int kDirTile = 256;

// airy_beam_df's constants: x = a[j] sin(theta) at node j, and the two
// Chebyshev series of 2 J1(x) / x.
struct Airy {
  double a[kMaxRank];
  double j1[kJ1];
  double tail[kTail];
};

// The snapshot's rotation and phase centre, device pointers to float32
// two-float (3, 3) and (3,) arrays.
struct Frame {
  const float* Mh;
  const float* Ml;
  const float* pch;
  const float* pcl;
};

// Optional (S, 3) float32 outputs; a null pointer is not written.
struct Vectors {
  float* sh;
  float* sl;
  float* seh;
  float* sel;
};

// airy_beam_df's _clenshaw: b1 <- (t2 b1 - b2) + c from the highest
// coefficient down, then (t b1 - b2) + c[0].
template <int N>
__device__ __forceinline__ double clenshaw(double t, const double* c) {
  const double t2 = __dmul_rn(2.0, t);
  double b1 = 0.0, b2 = 0.0;
#pragma unroll
  for (int i = N - 1; i >= 1; --i) {
    const double b = __dadd_rn(__dsub_rn(__dmul_rn(t2, b1), b2), c[i]);
    b2 = b1;
    b1 = b;
  }
  return __dadd_rn(__dsub_rn(__dmul_rn(t, b1), b2), c[0]);
}

// airy_beam_df's power pattern at x (the tail series from x = 8 on).
__device__ __forceinline__ double airy_power(double x, const Airy& cf) {
  double p;
  if (x >= 8.0) {
    p = clenshaw<kTail>(__dmul_rn(__dsub_rn(x, 20.0), 1.0 / 12.0), cf.tail);
  } else {
    const double t = __dsub_rn(__dmul_rn(__dmul_rn(x, x), 1.0 / 32.0), 1.0);
    p = __dmul_rn(2.0, clenshaw<kJ1>(t, cf.j1));
  }
  return __dmul_rn(p, p);
}

template <bool kPayload>
__global__ void __launch_bounds__(kThreads)
    banded_prep_kernel(const float* __restrict__ seq_h,
                       const float* __restrict__ seq_l, Frame fr,
                       const float* __restrict__ dirs_h,
                       const float* __restrict__ dirs_l, int S, int S_pad,
                       int D, float* __restrict__ u_h,
                       float* __restrict__ u_l, bool* __restrict__ ok,
                       Vectors vec, const double* __restrict__ flux,
                       const double* __restrict__ n2c, int r,
                       double* __restrict__ P_r, float ok_limit, float pad_u,
                       const __grid_constant__ Airy cf) {
  __shared__ float m[24];              // Mh (9), Ml (9), pch (3), pcl (3)
  __shared__ float dh[kDirTile * 3];
  __shared__ float dl[kDirTile * 3];
  __shared__ double nc[kPayload ? kMaxRank * kMaxRank : 1];
  const int tid = threadIdx.x;
  if (tid < 9) {
    m[tid] = fr.Mh[tid];
    m[9 + tid] = fr.Ml[tid];
  }
  if (tid < 3) {
    m[18 + tid] = fr.pch[tid];
    m[21 + tid] = fr.pcl[tid];
  }
  if (kPayload) {
    for (int i = tid; i < r * r; i += kThreads) nc[i] = n2c[i];
  }
  __syncthreads();

  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const bool real = s < S;
  const bool in = s < S_pad;
  df e[3];                             // the phase-centred vector
  if (real) {
    float h[3], l[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      h[k] = seq_h[3 * s + k];
      l[k] = seq_l[3 * s + k];
    }
    df rot[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      rot[i] = prisim::df_dot3(h, l, m + 3 * i, m + 9 + 3 * i);
      e[i] = prisim::df_add(rot[i], df{-m[18 + i], -m[21 + i]});
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (vec.sh) vec.sh[3 * s + i] = rot[i].h;
      if (vec.sl) vec.sl[3 * s + i] = rot[i].l;
      if (vec.seh) vec.seh[3 * s + i] = e[i].h;
      if (vec.sel) vec.sel[3 * s + i] = e[i].l;
    }
    if (kPayload) {
      double acc[kMaxRank];
#pragma unroll
      for (int k = 0; k < kMaxRank; ++k) acc[k] = 0.0;
      const double x0 = __dadd_rn(rot[0].h, rot[0].l);
      const double x1 = __dadd_rn(rot[1].h, rot[1].l);
      const double x2 = __dadd_rn(rot[2].h, rot[2].l);
      if (x2 > 0.0) {
        double q = __dadd_rn(__dmul_rn(x0, x0), __dmul_rn(x1, x1));
        q = q > 1.0 ? 1.0 : q;         // torch.clamp(max=1.0) keeps a NaN
        const double st = __dsqrt_rn(q);
        const double* f = flux + s * r;
#pragma unroll 1
        for (int j = 0; j < r; ++j) {
          const double v =
              __dmul_rn(airy_power(__dmul_rn(st, cf.a[j]), cf), __ldg(f + j));
#pragma unroll
          for (int k = 0; k < kMaxRank; ++k) {
            if (k < r) acc[k] = __fma_rn(v, nc[j * r + k], acc[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxRank; ++k) {
        if (k < r) P_r[static_cast<int64_t>(k) * S_pad + s] = acc[k];
      }
    }
  } else if (kPayload && in) {
    for (int k = 0; k < r; ++k) {
      P_r[static_cast<int64_t>(k) * S_pad + s] = 0.0;
    }
  }

  bool bad = false;
  for (int d0 = 0; d0 < D; d0 += kDirTile) {
    const int nd = D - d0 < kDirTile ? D - d0 : kDirTile;
    __syncthreads();
    for (int i = tid; i < 3 * nd; i += kThreads) {
      dh[i] = dirs_h[3 * d0 + i];
      dl[i] = dirs_l[3 * d0 + i];
    }
    __syncthreads();
    if (!in) continue;
    int64_t at = static_cast<int64_t>(d0) * S_pad + s;
#pragma unroll 4
    for (int d = 0; d < nd; ++d, at += S_pad) {
      float uh = pad_u, ul = 0.0f;
      if (real) {
        df t = prisim::df_mul(df{dh[3 * d], dl[3 * d]}, e[0]);
        t = prisim::df_add(t, prisim::df_mul(df{dh[3 * d + 1],
                                                dl[3 * d + 1]}, e[1]));
        t = prisim::df_add(t, prisim::df_mul(df{dh[3 * d + 2],
                                                dl[3 * d + 2]}, e[2]));
        uh = t.h;
        ul = t.l;
        bad |= !(fabsf(uh) <= ok_limit);
      }
      u_h[at] = uh;
      u_l[at] = ul;
    }
  }
  if (__syncthreads_or(bad) && tid == 0) *ok = false;
}

}  // namespace

extern "C" {

// Launch banded_prep on `stream`. Device pointers: seq_h/seq_l (S, 3)
// float32 celestial two-float source vectors; Mh/Ml (3, 3) and pch/pcl (3,)
// float32, the snapshot's rotation and phase centre; dirs_h/dirs_l (D, 3)
// float32 two-float unit directions; u_h/u_l (D, S_pad) float32, every
// element written; ok one bool, set true by the caller, written false when
// a source fails the unit check; sh/sl/seh/sel (S, 3) float32 or null.
// Payload (flux null: none): flux (S, r) and n2c (r, r) float64 on the
// device, P_r (r, S_pad) float64, every element written; on the host, a
// (r) node factors and the j1 (27) and tail (41) Chebyshev coefficients
// of airy_beam_df. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for bad sizes).
int prisim_banded_prep(const void* seq_h, const void* seq_l, const void* Mh,
                       const void* Ml, const void* pch, const void* pcl,
                       const void* dirs_h, const void* dirs_l, int S,
                       int S_pad, int D, void* u_h, void* u_l, void* ok,
                       void* sh, void* sl, void* seh, void* sel,
                       const void* flux, const void* n2c, const double* a,
                       int r, const double* j1, int n_j1, const double* tail,
                       int n_tail, void* P_r, float ok_limit, float pad_u,
                       void* stream) {
  const bool payload = flux != nullptr;
  if (S < 1 || S_pad < S || D < 1 || ok == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (payload && (n2c == nullptr || P_r == nullptr || a == nullptr ||
                  r < 1 || r > kMaxRank || j1 == nullptr || n_j1 != kJ1 ||
                  tail == nullptr || n_tail != kTail)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (static_cast<int64_t>(S_pad) + kThreads - 1) /
                         kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Airy cf{};
  if (payload) {
    for (int j = 0; j < r; ++j) cf.a[j] = a[j];
    for (int i = 0; i < kJ1; ++i) cf.j1[i] = j1[i];
    for (int i = 0; i < kTail; ++i) cf.tail[i] = tail[i];
  }
  const Frame fr{static_cast<const float*>(Mh), static_cast<const float*>(Ml),
                 static_cast<const float*>(pch),
                 static_cast<const float*>(pcl)};
  const Vectors vec{static_cast<float*>(sh), static_cast<float*>(sl),
                    static_cast<float*>(seh), static_cast<float*>(sel)};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qh = static_cast<const float*>(seq_h);
  const auto* ql = static_cast<const float*>(seq_l);
  const auto* bh = static_cast<const float*>(dirs_h);
  const auto* bl = static_cast<const float*>(dirs_l);
  auto* uh = static_cast<float*>(u_h);
  auto* ul = static_cast<float*>(u_l);
  auto* okp = static_cast<bool*>(ok);
  const auto* fp = static_cast<const double*>(flux);
  const auto* np = static_cast<const double*>(n2c);
  auto* pp = static_cast<double*>(P_r);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (payload) {
    banded_prep_kernel<true><<<grid, kThreads, 0, st>>>(
        qh, ql, fr, bh, bl, S, S_pad, D, uh, ul, okp, vec, fp, np, r, pp,
        ok_limit, pad_u, cf);
  } else {
    banded_prep_kernel<false><<<grid, kThreads, 0, st>>>(
        qh, ql, fr, bh, bl, S, S_pad, D, uh, ul, okp, vec, nullptr, nullptr,
        0, nullptr, ok_limit, pad_u, cf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
