"""Delay-space NUFFT engine: the spread, its pieces and its snapshots.

Counterpart of prisim_tpu/engine/nufft_delay.py. On a uniform channel grid
the frequency axis of V(b, nu_c) = sum_s A_s e^{-2 pi i (nu0 + c dnu)
tau_sb} is a 1-D type-3 NUFFT from the delays tau_sb to C channels, per
baseline: Kaiser-Bessel spreading of the carrier-phased amplitudes onto
an oversampled delay grid of n = beta C bins, one FFT and a diagonal
deconvolution.

* Host numpy copies of the reference: `nufft_delay_visibilities` (the
  float64 reference, ~1e-12 against the direct sum),
  `nufft_delay_visibilities_spectral`, `size_gather_window`, the KB kernel
  and its Fourier transform, the tap fits and the Chebyshev bases.
* The delay pieces on torch: `delays_two_float` (tau = (s_eff . b)/c in
  two-float), `fold_delay_bins` (m0 and z0 of tau/h in float64, the one
  computation both the sort and the spread read), `chebyshev_basis_jit`.
* The spread: the reference's sorted, scatter and gather spreads are three
  TPU formulations of one function (argsort, compensated cumsums and
  boundary gathers were chosen because XLA on a TPU has no fast scatter).
  All three names reach one kernel here, `delay_spread` in csrc/spread.cu
  (wrapper engine/cuda_spread.py; its plain version delay_spread_plain on
  CPU tensors), which sums in float64: the compensated cumsums have no
  role. `_delay_post` is the complex128 FFT, mode selection,
  deconvolution and rank combine.
* The snapshots: `simulate_snapshot_nufft_jit` (fixed Chebyshev basis, the
  driver's sorted route) and `simulate_snapshot_nufft` (host SVD).
The banded engine (nufft_banded.py) uses the KB pieces and the spectral
bases of this module.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from .observe import snapshot_nudft_inputs

__all__ = ["nufft_delay_visibilities", "nufft_delay_visibilities_spectral",
           "nufft_delay_visibilities_jax",
           "nufft_delay_visibilities_jax_gather",
           "nufft_delay_visibilities_jax_sorted",
           "nufft_delay_multirank_sorted", "fold_delay_bins",
           "kb_tap_coeffs", "size_gather_window", "spectral_project",
           "simulate_snapshot_nufft", "kb_kernel", "kb_fourier",
           "delays_two_float", "chebyshev_basis_jit", "chebyshev_projection",
           "chebyshev_node_model", "NodeModel", "simulate_snapshot_nufft_jit"]


def kb_kernel(z, K, alpha):
    """Kaiser-Bessel spreading kernel w(z) on |z| <= K/2 (z in grid
    units), zero outside."""
    arg = 1.0 - (2.0 * z / K) ** 2
    inside = arg > 0
    out = np.zeros_like(np.asarray(z, dtype=np.float64))
    out[inside] = np.i0(alpha * np.sqrt(arg[inside])) / np.i0(alpha)
    return out


def kb_fourier(k_over_n, K, alpha):
    """Continuous Fourier transform of the KB kernel at xi = k/n cycles
    per grid step: (K/I0(alpha)) sinh(sqrt(alpha^2 - (pi K xi)^2)) /
    sqrt(...), continued to sinc where the argument turns imaginary."""
    xi = np.asarray(k_over_n, dtype=np.float64)
    t = alpha ** 2 - (np.pi * K * xi) ** 2
    out = np.empty_like(t)
    pos = t > 0
    rt = np.sqrt(np.abs(t))
    out[pos] = np.sinh(rt[pos]) / rt[pos]
    out[~pos] = np.sinc(rt[~pos] / np.pi)
    return K * out / np.i0(alpha)


def nufft_delay_visibilities(tau, amps, nu0, dnu, nchan, beta=2.0,
                             K=13, alpha=None):
    """Visibility spectra via per-baseline 1-D type-3 NUFFT.

    tau  : (S, B) geometric delays in seconds (phase-center subtracted)
    amps : (S,) or (S, B) frequency-flat amplitudes
    Returns (B, C) complex128, equal to
    sum_s amps e^{-2 pi i (nu0 + c dnu) tau} to NUFFT accuracy
    (~1e-12 at beta=2, K=13)."""
    tau = np.asarray(tau, dtype=np.float64)
    S, B = tau.shape
    amps = np.asarray(amps, dtype=np.float64)
    if amps.ndim == 1:
        amps = np.broadcast_to(amps[:, None], (S, B))
    if alpha is None:
        alpha = np.pi * K * (1.0 - 0.5 / beta) - 0.01  # standard choice
    n = int(beta * nchan)
    h = 1.0 / (n * dnu)                   # grid step in seconds
    # carrier at mid-band so the FFT modes are centered: k = c - C/2
    # in [-C/2, C/2), inside the kernel's accuracy band |k| <= n/(2 beta)
    nu_mid = nu0 + (nchan // 2) * dnu
    carrier = np.exp(-2j * np.pi * nu_mid * tau)
    # grid coordinate; delays fold mod 1/dnu EXACTLY for the evaluated
    # modes (k dnu (tau + p/dnu) differs by whole cycles), so the
    # scatter's mod-n wraparound supports arbitrary delay ranges
    phi = tau / h
    m0 = np.rint(phi).astype(np.int64)   # center taps: |phi - m0| <= 1/2
    grid = np.zeros((B, n), dtype=np.complex128)
    half = K // 2
    for j in range(-half, half + 1):      # K taps, vectorized over (S,B)
        m = m0 + j
        w = kb_kernel(phi - m, K, alpha)  # (S, B)
        np.add.at(grid, (np.arange(B)[None, :], m % n),
                  amps * carrier * w)
    # FFT: G[k] = sum_m grid[m] e^{-2 pi i k m / n}, centered modes
    G = np.fft.fft(grid, axis=1)
    k = np.arange(nchan) - nchan // 2          # (C,) in [-C/2, C/2)
    Gk = G[:, k % n]
    V = Gk / kb_fourier(k / n, K, alpha)[None, :]
    return V


def nufft_delay_visibilities_spectral(tau, amps_sc, nu0, dnu, nchan,
                                      rank=12, beta=2.0, K=13,
                                      alpha=None, basis="svd"):
    """NUFFT evaluation with frequency-dependent amplitudes.

    amps_sc: (S, C) per-source spectra (e.g. beam-weighted power laws).
    Factorizes A ~ sum_r P_r(s) Q_r(c) by truncated SVD and runs one
    flat-spectrum NUFFT per rank:

        V(b, c) = sum_r Q_r(c) * NUFFT[P_r](b, c)

    Smooth spectra (power laws over a ~20% fractional band) compress to
    rank ~10 at <=1e-6, so the cost is rank * O(S K + beta C log C) per
    baseline — still ~C/(K rank) times cheaper than direct. Returns
    ((B, C) complex128, spectral truncation error estimate)."""
    amps_sc = np.asarray(amps_sc, dtype=np.float64)
    S, C = amps_sc.shape
    if C != nchan:
        raise ValueError("amps_sc second axis must be nchan")
    if basis == "chebyshev":
        # FIXED basis in ln(nu): Q = chebvander rows, P = amps @ pinv(Q)
        # — one matmul, no data-dependent SVD (jit/MXU-friendly; rank 8
        # fits full-octave power laws at ~1e-7)
        freqs = nu0 + dnu * np.arange(C)
        x = np.log(freqs / freqs[C // 2])
        x = 2.0 * (x - x.min()) / (x.max() - x.min()) - 1.0
        Q = np.polynomial.chebyshev.chebvander(x, rank - 1)   # (C, r)
        P = amps_sc @ np.linalg.pinv(Q).T                     # (S, r)
        resid = np.abs(P @ Q.T - amps_sc).max() / \
            max(np.abs(amps_sc).max(), 1e-300)
        comps = [(P[:, i], Q[:, i]) for i in range(rank)]
        trunc = float(resid)
    else:
        U, sv, Vt = np.linalg.svd(amps_sc, full_matrices=False)
        r = min(rank, sv.size)
        trunc = float(sv[r:].sum() / max(sv.sum(), 1e-300))
        comps = [(U[:, i] * sv[i], Vt[i]) for i in range(r)]
    out = 0.0
    for p_r, q_r in comps:
        Vi = nufft_delay_visibilities(tau, p_r, nu0, dnu, nchan,
                                      beta=beta, K=K, alpha=alpha)
        out = out + Vi * q_r[None, :]
    return out, trunc


def _split_host(x):
    """Host-side f64 -> (hi, lo) f32 split."""
    hi = np.float32(x)
    lo = np.float32(x - np.float64(hi))
    return hi, lo


def size_gather_window(tau, dnu, nchan, beta=2.0, K=13, margin=1.0):
    """Host-side sizing of the gather window: the max occupancy of any
    K+1-bin sliding window of the folded delay-bin histogram, over all
    baselines (the bound the gather variant's fixed window must cover —
    undersizing silently drops sources). `tau` is the concrete (S, B)
    delay array (f64); `margin` scales the result (>1 for safety when
    delays will move between calls, e.g. over a drift scan)."""
    n = int(beta * nchan)
    h = 1.0 / (n * dnu)
    m0 = np.rint(np.asarray(tau, dtype=np.float64) / h).astype(np.int64)
    m0 %= n
    worst = 0
    win = np.ones(K + 1)
    for b in range(m0.shape[1]):
        counts = np.bincount(m0[:, b], minlength=n).astype(np.float64)
        # circular K+1-bin sliding sum (edge bins see wrapped bins)
        ext = np.concatenate([counts[-(K // 2):], counts,
                              counts[:K // 2]])
        occ = np.convolve(ext, win, mode="valid")
        worst = max(worst, int(occ.max()))
    return max(1, int(np.ceil(worst * float(margin))))


def kb_tap_coeffs(K, alpha, degree=12):
    """Per-tap polynomial fits of the KB kernel: tap j's weight
    w_j(z0) = kb(z0 - j) on z0 in [-1/2, 1/2], fit by a degree-`degree`
    Chebyshev series at 64 nodes and converted to monomials. Returns
    (K, degree+1) float64, highest degree first (np.polyval order)."""
    half = K // 2
    z = np.polynomial.chebyshev.chebpts1(64) * 0.5
    out = np.empty((K, degree + 1))
    for idx, j in enumerate(range(-half, half + 1)):
        w = kb_kernel(z - j, K, alpha)
        cheb = np.polynomial.chebyshev.Chebyshev.fit(z, w, degree,
                                                     domain=[-0.5, 0.5])
        out[idx] = cheb.convert(kind=np.polynomial.Polynomial).coef[::-1]
    return out


def chebyshev_projection(freqs, rank):
    """Fixed spectral basis: (pinvQ (C, r), Q (C, r)) float32 with
    P = amps @ pinvQ. The pseudo-inverse is taken of the float32-cast
    basis, so that P @ Q.T is a true projection for the f32 Q."""
    freqs = np.asarray(freqs, dtype=np.float64)
    C = freqs.size
    x = np.log(freqs / freqs[C // 2])
    x = 2.0 * (x - x.min()) / (x.max() - x.min()) - 1.0
    Q = np.polynomial.chebyshev.chebvander(x, rank - 1)
    Qf = Q.astype(np.float32)
    return (np.linalg.pinv(Qf.astype(np.float64)).T.astype(np.float32),
            Qf)


@dataclass
class NodeModel:
    """Static pieces of the rank-r spectral node model
    (chebyshev_node_model)."""
    nu_nodes: np.ndarray
    node2coef: np.ndarray
    V: np.ndarray
    Q: np.ndarray
    expand: np.ndarray
    node2coef64: np.ndarray = None
    Q64: np.ndarray = None


def chebyshev_node_model(freqs, rank):
    """Node form of the rank-r spectral model: beam x flux is evaluated at
    the rank Chebyshev nodes of the band (in scaled ln nu) and the amps
    are the unique degree-(r-1) interpolant, so the engine never holds an
    (S, C) table.

    Returns a NodeModel with
      nu_nodes  (r,)  f64  node frequencies
      node2coef (r, r) f32  P = amps_at_nodes @ node2coef
      V         (r, r) f32  values_at_nodes = coefficients @ V.T
      Q         (C, r) f32  full-grid basis (chebyshev_projection's x)
      expand    (C, r) f32  amps_full = amps_at_nodes @ expand.T
    and the float64 node2coef64 and Q64."""
    freqs = np.asarray(freqs, dtype=np.float64)
    C = freqs.size
    x = np.log(freqs / freqs[C // 2])
    xlo, xhi = x.min(), x.max()
    xs = 2.0 * (x - xlo) / (xhi - xlo) - 1.0
    t = np.polynomial.chebyshev.chebpts1(rank)
    x_nodes = xlo + (t + 1.0) * 0.5 * (xhi - xlo)
    nu_nodes = freqs[C // 2] * np.exp(x_nodes)
    V = np.polynomial.chebyshev.chebvander(t, rank - 1)
    Vinv = np.linalg.inv(V)
    Q = np.polynomial.chebyshev.chebvander(xs, rank - 1)
    return NodeModel(
        nu_nodes=nu_nodes, node2coef=Vinv.T.astype(np.float32),
        V=V.astype(np.float32), Q=Q.astype(np.float32),
        expand=(Q @ Vinv).astype(np.float32),
        node2coef64=Vinv.T, Q64=Q)


def spectral_project(amps, pinvQ, block=128):
    """P = amps @ pinvQ in float32 with channel-blocked Kahan accumulation:
    each block of `block` channels is one matmul, and the block partials
    are Kahan-summed, as the JAX package does (a single f32 matmul's
    rounding is value-correlated across sources of one spectral family).
    amps (S, C) and pinvQ (C, r) are float32 tensors or arrays on one
    device; returns (S, r) float32."""
    amps = torch.as_tensor(amps, dtype=torch.float32)
    W = torch.as_tensor(pinvQ, dtype=torch.float32, device=amps.device)
    S, C = amps.shape
    r = W.shape[1]
    nb = -(-C // block)
    if nb * block != C:
        amps = torch.nn.functional.pad(amps, (0, nb * block - C))
        W = torch.nn.functional.pad(W, (0, 0, 0, nb * block - C))
    parts = torch.einsum("snc,ncr->nsr", amps.reshape(S, nb, block),
                         W.reshape(nb, block, r))
    tot = torch.zeros((S, r), dtype=torch.float32, device=amps.device)
    comp = torch.zeros_like(tot)
    for p in parts:
        y = p - comp
        t = tot + y
        comp = (t - tot) - y
        tot = t
    return tot


# --------------------------------------------------------------------------
# delays, bins and the in-graph basis (torch)
# --------------------------------------------------------------------------

def delays_two_float(seh, sel, bl_hi, bl_lo):
    """Two-float geometric delays tau = (s_eff . b)/c, (S, B) seconds:
    seh/sel (S, 3) and bl_hi/bl_lo (B, 3) float32 two-float tensors on one
    device. One float64 product (s_eff (S, 3)) @ (b/c (3, B)), split to
    the float32 pair; the reference chains two-float products (~60 float32
    passes over the (S, B) pairs) for the same ~1e-15 relative."""
    from .. import constants as CNST
    s64 = seh.double() + sel.double()
    b64 = (bl_hi.double() + bl_lo.double()) / CNST.c
    tau = s64 @ b64.t()
    hi = tau.float()
    return hi, (tau - hi.double()).float()


def fold_delay_bins(tau_h, tau_l, dnu, nchan, beta=2.0):
    """Delays folded onto the oversampled grid: (m0 (S, B) int32 in
    [0, n), z0 (S, B) float64 in [-1/2, 1/2], n).

    phi = tau / h in float64 (tau joined from its two floats, h =
    1/(n dnu)), m0 = rint(phi) (half to even), z0 = phi - m0. The sort and
    the spread both read these tensors: a second computation of the bins
    could round a tie into another bin. z0 is float64 where the reference
    keeps float32 (the port's spread is float64 throughout)."""
    n = int(beta * nchan)
    h = 1.0 / (n * dnu)
    phi = (tau_h.double() + tau_l.double()) / h
    m = torch.round(phi)
    z0 = phi - m
    return torch.remainder(m.long(), n).to(torch.int32), z0, n


def _sorted_spread_setup(m0, n):
    """Per-baseline sort of folded bin indices and segment boundaries.

    m0: (S, B) int32 folded bins (0..n-1). Returns (order (S, B) int64,
    starts (n+1, B)): `order` sorts each baseline's sources by bin (a
    stable sort); starts[g] is the first sorted position of bin g
    (starts[n] = S). The port's spread reads `order` only."""
    ms, order = torch.sort(m0, dim=0, stable=True)
    g = torch.arange(int(n) + 1, dtype=m0.dtype, device=m0.device)
    starts = torch.searchsorted(ms.t().contiguous(),
                                g.expand(ms.shape[1], -1).contiguous())
    return order, starts.t()


def chebyshev_basis_jit(freqs_f32, rank):
    """Fixed Chebyshev basis in ln(nu) of `freqs_f32` (a tensor) with its
    projector: (pinvQ (C, r), Q (C, r)) float32 on its device, P = amps @
    pinvQ. The reference builds it in float32 inside its traced mesh
    body (QR solve); here Q is built in float64, cast to float32, and the
    projector is the float64 pseudo-inverse of that float32 basis, as
    chebyshev_projection makes it (P @ Q.T a true projection)."""
    f = freqs_f32.double()
    x = torch.log(f / f[f.shape[0] // 2])
    x = 2.0 * (x - x.min()) / torch.clamp(x.max() - x.min(), min=1e-30) - 1.0
    cols = [torch.ones_like(x)]
    if rank > 1:
        cols.append(x)
    for _ in range(2, rank):
        cols.append(2.0 * x * cols[-1] - cols[-2])
    Qf = torch.stack(cols, dim=1).float()
    pinvQ = torch.linalg.pinv(Qf.double()).t().float()
    return pinvQ, Qf


# --------------------------------------------------------------------------
# the spread functions: one kernel behind the reference's three spreads
# --------------------------------------------------------------------------

def _alpha(K, beta, alpha):
    return float(np.pi * K * (1.0 - 0.5 / beta) - 0.01 if alpha is None
                 else alpha)


def _delay_post(grid, Qc, nchan, K, alpha, dtype=torch.complex64):
    """Grid -> visibilities: complex128 FFT over each (baseline, rank)
    grid (B, n, r), modes k = c - C/2 taken mod n, deconvolution
    1/kb_fourier(k/n), then sum_r Qc[c, r]. Returns (B, C) `dtype`."""
    n = grid.shape[1]
    G = torch.fft.fft(grid, dim=1)
    k = np.arange(nchan) - nchan // 2
    Gk = G[:, torch.as_tensor(k % n, device=grid.device)]      # (B, C, r)
    Qd = (torch.as_tensor(Qc, device=grid.device).double()
          * torch.as_tensor(1.0 / kb_fourier(k / n, K, alpha),
                            device=grid.device)[:, None])
    V = torch.einsum("bcr,cr->bc", Gk, Qd.to(Gk.dtype))
    return V.to(dtype)


def _spread(tau_h, tau_l, P, nu0, dnu, nchan, beta, K, alpha, chan0, setup):
    """The delay grid (B, n, r) complex128 of payload P (S, r) or
    (B, S, r): kernel delay_spread for CUDA tensors, its plain version for
    CPU tensors (engine/cuda_spread.py)."""
    from .cuda_spread import delay_spread_cuda
    return delay_spread_cuda(tau_h, tau_l, P, nu0, dnu, nchan, beta=beta,
                             K=K, alpha=alpha, chan0=chan0, setup=setup)


def _per_baseline(amps, S, B):
    """Amplitudes (S,) or (S, B) as the spread's payload: (S, 1) shared by
    every baseline, or (B, S, 1) per baseline."""
    amps = torch.as_tensor(amps, dtype=torch.float32)
    if amps.dim() == 1:
        return amps[:, None]
    if tuple(amps.shape) != (S, B):
        raise ValueError("amps must be (S,) or (S, B) = (%d, %d), got %s"
                         % (S, B, tuple(amps.shape)))
    return amps.t()[..., None]


def nufft_delay_visibilities_jax_sorted(tau_h, tau_l, amps, nu0, dnu,
                                        nchan, beta=2.0, K=13,
                                        alpha=None, setup=None,
                                        chan0=None):
    """The sorted spread of the reference (its TPU path), for flat
    amplitudes: tau_h/tau_l (S, B) two-float delays (seconds), amps (S,)
    or (S, B). setup: (order, starts) of _sorted_spread_setup, reused
    across calls on the same delays. chan0: the global channel offset of
    a channel shard (the carrier moves by chan0 dnu tau cycles).

    The reference's cumsum-and-boundary formulation existed because XLA
    on a TPU has no fast scatter; here it is kernel delay_spread, which
    sorts each baseline's sources by bin and sums each run of equal bins
    in float64. Returns the float64 sums unrounded, as (B, C)
    complex128, where the reference's float32 spread returns complex64."""
    alpha = _alpha(K, beta, alpha)
    S, B = tau_h.shape
    P = _per_baseline(amps, S, B).to(tau_h.device)
    grid = _spread(tau_h, tau_l, P, nu0, dnu, nchan, beta, K, alpha, chan0,
                   setup)
    return _delay_post(grid, np.ones((nchan, 1)), nchan, K, alpha,
                       dtype=torch.complex128)


def nufft_delay_visibilities_jax(tau_h, tau_l, amps, nu0, dnu, nchan,
                                 beta=2.0, K=13, alpha=None):
    """The scatter spread of the reference (XLA scatter-add): the same
    function as the sorted spread, and the same kernel. Returns (B, C)
    complex128."""
    return nufft_delay_visibilities_jax_sorted(tau_h, tau_l, amps, nu0, dnu,
                                               nchan, beta=beta, K=K,
                                               alpha=alpha)


def nufft_delay_visibilities_jax_gather(tau_h, tau_l, amps, nu0, dnu,
                                        nchan, window=None, beta=2.0,
                                        K=13, alpha=None):
    """The gather spread of the reference (a fixed window of sorted
    sources per grid bin): the same function as the sorted spread, and
    the same kernel. `window` is not needed: the kernel reads every source
    of a bin, so an undersized window drops none. A given window must be
    a positive integer, as the reference's; None (the reference sizes it
    with size_gather_window) is taken as is. Returns (B, C) complex128."""
    if window is not None and (int(window) != window or window < 1):
        raise ValueError("window must be a positive integer, got %r"
                         % (window,))
    return nufft_delay_visibilities_jax_sorted(tau_h, tau_l, amps, nu0, dnu,
                                               nchan, beta=beta, K=K,
                                               alpha=alpha)


def nufft_delay_multirank_sorted(tau_h, tau_l, P, Qc, nu0, dnu, nchan,
                                 beta=2.0, K=13, alpha=None, chan0=None):
    """Multi-rank spread: V = sum_r Qc[:, r] * NUFFT[P[:, r]], the ranks of
    one source spread together in one kernel launch (one sort per
    baseline for all ranks, as the reference hoists it).

    tau_h/tau_l (S, B) two-float delays; P (S, r) spectral coefficients;
    Qc (C, r) basis columns; chan0 as in the sorted spread. Returns (B, C)
    complex64."""
    alpha = _alpha(K, beta, alpha)
    P = torch.as_tensor(P, device=tau_h.device)
    grid = _spread(tau_h, tau_l, P, nu0, dnu, nchan, beta, K, alpha, chan0,
                   None)
    return _delay_post(grid, Qc, nchan, K, alpha)


# --------------------------------------------------------------------------
# snapshots
# --------------------------------------------------------------------------

def live_sources(P):
    """Indices of the sources whose payload row is not all zero (the
    others add nothing)."""
    return torch.nonzero((P != 0).any(dim=1)).reshape(-1)


# (source, baseline) pairs a block of baselines of a snapshot holds at most:
# the block's (S, B) delays, bins, sort and kernel layouts stay near 8 GB of
# device memory. The (S, C) beam x flux table of the sources above the
# horizon is made before the blocks and is not bounded by them.
_BLOCK_PAIRS = 1 << 26


def _nufft_snapshot(seh, sel, P, bl_hi, bl_lo, Q, nu0, dnu, nchan, beta=2.0,
                    K=13, chan0=None):
    """The visibilities (B, C) complex64 of sources seh/sel (S, 3) with
    spectral coefficients P (S, r) on baselines bl_hi/bl_lo (B, 3): the
    sources above the horizon, in blocks of baselines of at most
    _BLOCK_PAIRS pairs, each block's delays and multi-rank spread (one
    launch a block, as nufft_delay_multirank_sorted). Spans of each block:
    "delays", the spread's "spread.sort" and "spread", and "post"; the
    number of blocks is counted as spread.blocks."""
    keep = live_sources(P)
    seh, sel, P = seh[keep], sel[keep], P[keep]
    B = bl_hi.shape[0]
    step = max(1, _BLOCK_PAIRS // max(1, int(keep.numel())))
    alpha = _alpha(K, beta, None)
    tracing.count("spread.blocks", -(-B // step))
    out = []
    for b0 in range(0, B, step):
        with tracing.span("delays"):
            th, tl = delays_two_float(seh, sel, bl_hi[b0:b0 + step],
                                      bl_lo[b0:b0 + step])
        grid = _spread(th, tl, P, nu0, dnu, nchan, beta, K, alpha, chan0,
                       None)
        with tracing.span("post"):
            out.append(_delay_post(grid, Q, nchan, K, alpha))
        del th, tl, grid
    return out[0] if len(out) == 1 else torch.cat(out)


def simulate_snapshot_nufft_jit(instrument, sky, Mh, Ml, pch, pcl,
                                beam_fn, pinvQ, Q, beta=2.0, K=13,
                                spread="sorted"):
    """One accumulation through the delay-space NUFFT with the fixed
    Chebyshev basis (chebyshev_projection): rotate, then for the sources
    above the horizon beam x flux (span "beam_flux") and P =
    spectral_project(amps, pinvQ) (span "project"), then, in blocks of
    baselines, the delays and the multi-rank spread (_nufft_snapshot).
    Returns (B, C) complex64 on the instrument's device.

    spread: 'sorted' or 'scatter', accepted for the reference's signature
    and checked; it selects nothing, since both of the reference's spreads
    are the one kernel here, in one launch for all ranks."""
    if spread not in ("sorted", "scatter"):
        raise ValueError("spread must be 'sorted' or 'scatter', got %r"
                         % (spread,))
    with tracing.span("beam_flux"):
        seh, sel, amps, _ = snapshot_nudft_inputs(instrument, sky, Mh, Ml,
                                                  pch, pcl, beam_fn,
                                                  above_horizon=True)
    with tracing.span("project"):
        P = spectral_project(amps, torch.as_tensor(pinvQ,
                                                   device=amps.device))
    del amps
    return _nufft_snapshot(seh, sel, P, instrument.bl_hi, instrument.bl_lo,
                           Q, instrument.nu0, instrument.dnu,
                           instrument.nchan, beta=beta, K=K)


def simulate_snapshot_nufft(instrument, sky, Mh, Ml, pch, pcl, beam_fn,
                            rank=12, beta=2.0, K=13):
    """One accumulation through the NUFFT with a host SVD of the
    beam-weighted spectra (numpy float64): rank flat-spectrum spreads,
    each combined with its right singular vector. Returns (B, C)
    complex128 numpy, as the reference does. The sources below the
    horizon, whose rows of the spectra are zero, are left out."""
    seh, sel, amps, _ = snapshot_nudft_inputs(instrument, sky, Mh, Ml, pch,
                                              pcl, beam_fn,
                                              above_horizon=True)
    th, tl = delays_two_float(seh, sel, instrument.bl_hi, instrument.bl_lo)
    A = amps.double().cpu().numpy()
    U, sv, Vt = np.linalg.svd(A, full_matrices=False)
    r = min(rank, sv.size)
    out = 0.0
    for i in range(r):
        Vi = nufft_delay_visibilities_jax(
            th, tl, torch.as_tensor((U[:, i] * sv[i]).astype(np.float32),
                                    device=th.device),
            instrument.nu0, instrument.dnu, instrument.nchan, beta=beta, K=K)
        out = out + Vi.cpu().numpy() * Vt[i][None, :]
    return out
