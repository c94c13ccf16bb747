"""Banded delay-space NUFFT engine: plan, prep, spread, post and snapshots.

Counterpart of prisim_tpu/engine/nufft_banded.py. On a uniform channel
grid the frequency axis of V(b, nu_c) = sum_s A_sc e^{-2 pi i nu_c tau_sb}
is a 1-D type-3 NUFFT per baseline: the carrier-phased rank-r spectral
coefficients of each source are spread onto an oversampled delay grid by
K Kaiser-Bessel taps, one FFT per baseline turns the grid into channels,
and a deconvolution and the rank combine give V. With tau_sb =
|b| u_sd / c and u_sd = s_eff . b_hat_d, baselines that share a direction
d share one source stream u.

* The plan (host numpy) groups baselines by direction, collapses
  redundant and sign-flipped baselines onto unique canonical rows, and
  fixes per baseline the static range of delay rows that unit sources can
  reach: row p of baseline b holds grid bin blk_lo_b * G_blk + p.
* `_prep` computes u per direction in two-float and transposes the
  spectral payload; sources are padded to the tile with u = 3, outside
  every physical u (|u| <= 2), and zero payload. The snapshot functions
  take it, with the rotation and the truth payload before it, as one
  launch of kernel banded_prep (csrc/prep.cu, wrapper cuda_prep.py) on a
  CUDA card and as `banded_prep_plain`, that chain, on the CPU.
* The spread is kernel K2 (csrc/banded.cu, wrapper cuda_banded.py) on a
  CUDA card and `banded_spread_plain` on the CPU. Both return the rows
  (B, R_max, 2r) in float64: the TPU kernel's f32 dot, Kahan carries,
  dot_split and cross-chunk Kahan sum have no role with f64 sums. The
  snapshot functions zero one such array a snapshot, and every chunk's
  spread adds into it.
* `_post` wraps the rows mod n, FFTs them with torch.fft in complex128,
  keeps the C channels, deconvolves, combines the ranks, applies the exact
  per-baseline roll-theorem ramp and expands the redundancy.

The snapshot functions (make_banded_snapshot_fns) chunk the sources as
the reference does and carry the shared-amps gate against the direct
engine (kernel K1a on a card, the plain NUDFT on the CPU). The truth-amps
path computes the node-model coefficients in float64 and spreads them in
ONE launch as a float64 payload; the reference needs two f32 launches
(hi and lo) for the same pair.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .. import constants as CNST
from .. import healpix as hp
from .. import tracing
from .. import twofloat as tf
from ..beams.analytic import airy_beam_df
from .cuda_prep import MAX_RANK, AiryPayload, banded_prep_cuda
from .nufft_delay import (chebyshev_node_model, kb_fourier, kb_tap_coeffs,
                          spectral_project)
from .observe import (_beam_and_flux, check_kernel_knobs, df_rotate3,
                      direct_visibilities, snapshot_nudft_inputs)

__all__ = ["banded_spread_available", "make_banded_plan", "BandedPlan",
           "PlanRejected", "group_directions", "nufft_banded_visibilities",
           "simulate_snapshot_nufft_banded",
           "spatial_permutation", "spatial_order", "reorder_sources",
           "powerlaw_node_fluxes", "banded_prep_plain",
           "banded_spread_plain",
           "banded_worklist_plain", "banded_pair_count", "K2_ROWS",
           "K2_TILE",
           "make_coeff_fn", "make_coeff_fn_truth", "make_banded_snapshot_fns"]

_PAD_U = 3.0            # outside any physical u (|s_eff . b_hat| <= 2)
_VALID_U = 2.5          # u below this is a source, at or above it a pad
_UNIT_U = float(np.float32(2.0 + 1e-4))   # max |u_hi| of unit sources
# Longest per-baseline row range a plan takes (R_max); the port's arrays
# stay far below it (HERA-331: 840 rows).
_MAX_ROWS = 65535 * 32
# Kernel K2's worklist: items of K2_ROWS output rows of one baseline, and
# tiles of K2_TILE consecutive sources.
K2_ROWS = 64
K2_TILE = 128


# --------------------------------------------------------------------------
# host-side plan
# --------------------------------------------------------------------------

class PlanRejected(ValueError):
    """make_banded_plan cannot plan these baselines and grid; the driver
    runs the direct engine instead."""


def spatial_permutation(s_eq, nside=512):
    """Host permutation ordering sources by HEALPix NEST index, so that a
    tile of consecutive sources is a compact sky patch whose delay bins
    span few rows for every baseline. Any order is exact."""
    return np.argsort(_nest_pixels(s_eq, nside), kind="stable")


def _nest_pixels(s_eq, nside):
    """Host NEST pixel (S,) int64 of each direction (S, 3) float64."""
    s = np.asarray(s_eq, dtype=np.float64)
    r = np.linalg.norm(s, axis=1)
    theta = np.arccos(np.clip(s[:, 2] / r, -1.0, 1.0))
    phi = np.mod(np.arctan2(s[:, 1], s[:, 0]), 2.0 * np.pi)
    return hp.ang2pix(nside, theta, phi, nest=True)


# A bound on how far the device's z = cos(theta) and tt = phi / (pi / 2)
# of a direction may lie from numpy's: their acos, cos and atan2 round
# differently in the last few ulps (a few 1e-15).
_ANG_EPS = 1e-13
_ROUND_EPS = 1e-9       # of the floors' float64 arguments (|x| < 4 nside)


def spatial_order(s_eq_hi, s_eq_lo, nside=512):
    """spatial_permutation of the two-float directions, made on their own
    device: (perm (S,) int64 tensor there, n_host).

    The float64 steps are the host's (the join, the norm, acos of the
    clipped z, atan2 mod 2 pi, then ang2pix's floors and integer steps to
    the RING index and ring2nest), and the sort is stable, so the
    permutation is the host's wherever the pixels are. The device's acos,
    cos and atan2 may round otherwise than numpy's in the last ulps, which
    moves a direction across a pixel boundary only if it lies within that
    much of one: such a direction (n_host of them; as a rule none on a
    sky that is not a HEALPix grid at nside or coarser) takes its pixel
    from the host function, and only its row is copied there."""
    s = s_eq_hi.double() + s_eq_lo.double()
    x, y, zc = s.unbind(1)
    r = torch.sqrt(x * x + y * y + zc * zc)
    theta = torch.acos(torch.clamp(zc / r, -1.0, 1.0))
    phi = torch.remainder(torch.atan2(y, x), 2.0 * np.pi)
    pix, near = _ang2pix_nest(nside, torch.cos(theta), phi)
    idx = torch.nonzero(near).squeeze(1)
    n_host = int(idx.numel())
    if n_host:
        pix[idx] = torch.as_tensor(_nest_pixels(s[idx].cpu().numpy(), nside),
                                   device=pix.device)
    return torch.argsort(pix, stable=True), n_host


def _near_int(v, margin):
    """Whether v lies within `margin` of an integer."""
    return (v - torch.round(v)).abs() < margin


def _near_pos_int(v, margin):
    """Whether v >= 0 lies within `margin` of a positive integer (its
    floor cannot move at 0)."""
    return torch.where(v < 0.5, 1.0 - v < margin, _near_int(v, margin))


def _ang2pix_nest(nside, z, phi):
    """healpix.ang2pix(nside, acos(z), phi, nest=True) in torch, the same
    float64 operations in the same order: (pix (S,) int64, near (S,)
    bool), near where a change of z or of phi / (pi / 2) by _ANG_EPS could
    move the pixel (or a value is not finite), and pix is then not to be
    trusted."""
    za = z.abs()
    tt = torch.remainder(phi, 2.0 * np.pi) / (0.5 * np.pi)
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    eq = za <= 2.0 / 3.0
    near = ~(torch.isfinite(z) & torch.isfinite(tt))
    near |= (za - 2.0 / 3.0).abs() < _ANG_EPS

    # equatorial belt
    t1 = nside * (0.5 + tt)
    t2 = nside * (z * 0.75)
    lo, hi = t1 - t2, t1 + t2
    m = 2 * nside * _ANG_EPS + _ROUND_EPS
    near |= eq & (_near_int(lo, m) | _near_int(hi, m))
    jp, jm = torch.floor(lo).long(), torch.floor(hi).long()
    ir = nside + 1 + jp - jm
    kshift = 1 - (ir & 1)
    ip = ((jp + jm - nside + kshift + 1) // 2) % (4 * nside)
    pix_eq = ncap + (ir - 1) * 4 * nside + ip

    # polar caps
    tp = tt - torch.floor(tt)
    x3 = 3.0 * (1.0 - za)
    tmp = nside * torch.sqrt(x3)
    # |d sqrt(3 x)| <= min(1.5 |dx| / sqrt(3 x), sqrt(3 |dx|))
    dtmp = nside * torch.minimum(
        1.5 * _ANG_EPS / torch.sqrt(x3).clamp_min(1e-300),
        torch.full_like(x3, (3.0 * _ANG_EPS) ** 0.5))
    a, b = tp * tmp, (1.0 - tp) * tmp
    mab = tmp * _ANG_EPS + dtmp + _ROUND_EPS
    # a and b are >= 0, so only a positive integer is a boundary of theirs
    near_ab = _near_pos_int(a, mab) | _near_pos_int(b, mab)
    jp, jm = torch.floor(a).long(), torch.floor(b).long()
    ir = jp + jm + 1
    e = tt * ir.double()
    near |= ~eq & (_near_int(tt, _ANG_EPS) | near_ab
                   | _near_int(e, ir * _ANG_EPS + _ROUND_EPS))
    ir = ir.clamp(1, nside)
    ip = torch.floor(e).long() % (4 * ir)
    pix_pol = torch.where(z > 0, 2 * ir * (ir - 1) + ip,
                          npix - 2 * ir * (ir + 1) + ip)
    pix = torch.where(eq, pix_eq, pix_pol).clamp(0, npix - 1)
    return _ring2nest(nside, pix), near


def _isqrt(v):
    r = torch.sqrt(v.double()).long()
    r = torch.where(r * r > v, r - 1, r)
    return torch.where((r + 1) * (r + 1) <= v, r + 1, r)


def _spread_bits(v):
    """healpix._spread_bits in torch int64 (v < 2^29)."""
    for sh, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                     (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                     (1, 0x5555555555555555)):
        v = (v | (v << sh)) & mask
    return v


def _ring2nest(nside, ipix):
    """healpix.ring2nest in torch int64 (ipix in [0, 12 nside^2)): the
    host's integer steps, each case of the ring taken by torch.where."""
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    north = ipix < ncap
    south = ipix >= npix - ncap

    p = ipix
    ir_n = (1 + _isqrt(1 + 2 * p)) >> 1
    iphi_n = (p + 1) - 2 * ir_n * (ir_n - 1)
    face_n = (iphi_n - 1) // ir_n

    p = (ipix - ncap).clamp_min(0)
    ir_e = p // (4 * nside) + nside
    iphi_e = p % (4 * nside) + 1
    ire = ir_e - nside + 1
    irm = 2 * nside + 2 - ire
    ifm = (iphi_e - ire // 2 + nside - 1) // nside
    ifp = (iphi_e - irm // 2 + nside - 1) // nside
    face_e = torch.where(ifp == ifm, ifp | 4,
                         torch.where(ifp < ifm, ifp, ifm + 8))

    p = (npix - ipix).clamp_min(1)
    ir_s = (1 + _isqrt(2 * p - 1)) >> 1
    iphi_s = 4 * ir_s + 1 - (p - 2 * ir_s * (ir_s - 1))
    face_s = 8 + (iphi_s - 1) // ir_s

    def pick(n, e, s):
        return torch.where(north, n, torch.where(south, s, e))

    iring = pick(ir_n, ir_e, 4 * nside - ir_s)
    iphi = pick(iphi_n, iphi_e, iphi_s)
    nr = pick(ir_n, torch.full_like(ipix, nside), ir_s)
    kshift = torch.where(north | south, 0, (ir_e + nside) & 1)
    face = pick(face_n, face_e, face_s).clamp(0, 11)
    jrll = torch.as_tensor(hp._JRLL, device=ipix.device)[face]
    jpll = torch.as_tensor(hp._JPLL, device=ipix.device)[face]
    irt = iring - jrll * nside + 1
    ipt = 2 * iphi - jpll * nr - kshift - 1
    ipt = torch.where(ipt >= 2 * nside, ipt - 8 * nside, ipt)
    x, y = (ipt - irt) >> 1, (-ipt - irt) >> 1
    return face * nside * nside + (_spread_bits(x) | (_spread_bits(y) << 1))


def reorder_sources(sky, perm):
    """SkySources with every per-source tensor taken along axis 0; `perm`
    a host array or an int64 tensor."""
    idx = torch.as_tensor(perm if torch.is_tensor(perm)
                          else np.asarray(perm, np.int64),
                          device=sky.s_eq_hi.device)
    return replace(sky, s_eq_hi=sky.s_eq_hi[idx], s_eq_lo=sky.s_eq_lo[idx],
                   flux=sky.flux[idx])


def group_directions(bl_vectors, decimals=9):
    """Group baselines by unit direction: (dirs (D, 3) f64, d_of_b (B,)
    int32). Opposite directions are distinct groups."""
    bl = np.asarray(bl_vectors, dtype=np.float64)
    norm = np.linalg.norm(bl, axis=1)
    if np.any(norm == 0):
        raise PlanRejected("zero-length baseline")
    unit = bl / norm[:, None]
    key = np.round(unit, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    dirs = np.empty_like(uniq)
    for g in range(uniq.shape[0]):
        dirs[g] = unit[np.argmax(inv == g)]
    return dirs, inv.astype(np.int32)


def _ramp(blk_lo, G_blk, n, nchan):
    """Exact roll-theorem phase ramp (B, C) complex128 for the per-baseline
    bin offset blk_lo * G_blk at the kept FFT indices (host trig on exact
    integer arguments)."""
    k_idx = np.concatenate([np.arange(n - nchan // 2, n),
                            np.arange(0, nchan - nchan // 2)])
    off = (np.asarray(blk_lo).astype(np.int64) * G_blk) % n
    m = (k_idx[None, :] * off[:, None]) % n
    ang = 2.0 * np.pi * m / n
    return np.cos(ang) - 1j * np.sin(ang)


@dataclass
class BandedPlan:
    """Static per-(layout, band, rank) data for the banded NUFFT; the
    fields are those of the JAX package's plan."""
    nu0: float
    dnu: float
    nchan: int
    rank: int
    beta: float
    K: int
    alpha: float
    n: int                     # oversampled FFT length
    h: float                   # delay grid step (s)
    T_s: int                   # source tile (sources are padded to it)
    G_blk: int                 # block granularity (rows, mult of 8)
    G_win: int                 # per-block window rows (G_blk + taps)
    n_blk_max: int             # max blocks over baselines
    R_max: int                 # output rows per baseline
    dirs_hi: np.ndarray        # (D, 3) f32 two-float direction split
    dirs_lo: np.ndarray
    d_of_b: np.ndarray         # (B,) int32
    blk_lo: np.ndarray         # (B,) int32 first block (bin/G_blk, signed)
    n_blk: np.ndarray          # (B,) int32 blocks holding first taps
    blen_hi: np.ndarray        # (B,) f32 two-float |b|
    blen_lo: np.ndarray
    tap_w: np.ndarray          # (K, deg+1) f64 per-tap poly (polyval)
    deconv: np.ndarray         # (C,) f32 1/what(k/n)
    ramp: np.ndarray           # (B, C) c64 exact bin-offset phase ramp
    consts: dict = field(default_factory=dict)
    # redundancy collapse: the spread runs over unique canonical baseline
    # vectors; expand_idx/conj recover the full set (V(-b) = conj V(b)).
    # None => identity.
    expand_idx: np.ndarray = None   # (B_full,) int32 row of unique set
    conj: np.ndarray = None         # (B_full,) bool conjugate the row

    @property
    def nbl(self):
        return self.d_of_b.shape[0]

    @property
    def nbl_full(self):
        return (self.d_of_b.shape[0] if self.expand_idx is None
                else self.expand_idx.shape[0])

    @property
    def ndir(self):
        return self.dirs_hi.shape[0]

    @functools.cached_property
    def deconv64(self):
        """(C,) float64 deconvolution for the complex128 post."""
        k = np.arange(self.nchan) - self.nchan // 2
        return 1.0 / kb_fourier(k / self.n, self.K, self.alpha)

    @functools.cached_property
    def ramp64(self):
        """(B, C) complex128 ramp for the complex128 post."""
        return _ramp(self.blk_lo, self.G_blk, self.n, self.nchan)

    def tensor(self, name, dev, dtype=None):
        """Array `name` of the plan as a tensor on `dev`. The plan is fixed
        for a run, so each is uploaded once per plan, device and dtype."""
        cache = self.__dict__.setdefault("_on_device", {})
        key = (name, torch.device(dev), dtype)
        if key not in cache:
            cache[key] = torch.as_tensor(
                np.ascontiguousarray(getattr(self, name)), dtype=dtype,
                device=dev)
        return cache[key]


def _split(x):
    hi = np.float32(x)
    lo = np.float32(np.float64(x) - np.float64(hi))
    return hi, lo


def _friendly_fft_length(n0):
    """Smallest n >= n0 with a balanced split n = n1 * n2 (largest divisor
    n1 <= sqrt(n), n/n1 <= 8 n1). The port's torch.fft does not need it;
    it is kept so that the grid length, and with it every plan field,
    equals the reference's."""
    for cand in range(int(n0), int(n0) + 512):
        n1 = 1
        for d in range(int(np.sqrt(cand)), 0, -1):
            if cand % d == 0:
                n1 = d
                break
        if n1 > 1 and cand // n1 <= 8 * n1:
            return cand
    return int(n0)


def make_banded_plan(bl_vectors, nu0, dnu, nchan, rank, beta=2.0, K=9,
                     T_s=2048, G_blk=None, tap_degree=10,
                     collapse=True, dot_split=1):
    """Static plan for baseline vectors (meters) and a uniform frequency
    grid; every field equals the JAX package's on the same inputs.

    ``collapse`` sweeps only unique sign-canonical baseline vectors (keyed
    at round(bl, 6)); V(-b) = conj(V(b)) exactly since the amps are real.
    ``dot_split`` is kept in consts for parity with the reference; the
    port's f64 sums do not use it.

    Raises PlanRejected (a ValueError) when the longest baseline's rows
    exceed what kernel K2's grid can hold (_MAX_ROWS), or for an even K
    or a G_blk that is not a multiple of 8."""
    bl = np.asarray(bl_vectors, dtype=np.float64)
    if K % 2 == 0:
        raise PlanRejected("K must be odd (tap rows -half..+half)")
    expand_idx = conj_mask = None
    if collapse:
        key = np.round(bl, 6)
        neg = ((key[:, 0] < 0)
               | ((key[:, 0] == 0) & (key[:, 1] < 0))
               | ((key[:, 0] == 0) & (key[:, 1] == 0)
                  & (key[:, 2] < 0)))
        can = np.where(neg[:, None], -bl, bl)
        _, first, inv = np.unique(np.round(can, 6), axis=0,
                                  return_index=True, return_inverse=True)
        if first.shape[0] < bl.shape[0] or neg.any():
            expand_idx = inv.reshape(-1).astype(np.int32)
            conj_mask = neg
            bl = can[first]
    alpha = np.pi * K * (1.0 - 0.5 / beta) - 0.01
    n = _friendly_fft_length(int(np.ceil(beta * nchan)))
    h = 1.0 / (n * dnu)
    dirs, d_of_b = group_directions(bl)
    blen = np.linalg.norm(bl, axis=1)
    inv_ch = 1.0 / (CNST.c * h)
    if G_blk is None:
        G_blk = 32
    if G_blk % 8:
        raise PlanRejected("G_blk must be a multiple of 8")
    half = K // 2
    G_win = int(-(-(G_blk + K - 1) // 8) * 8)
    # static per-baseline occupied range: bins in +-(phimax + 1)
    phimax = blen * 2.0 * inv_ch
    blk_lo = np.floor((-phimax - half - 2.0) / G_blk).astype(np.int32)
    hi_own = phimax + 2.0 - half          # max first-tap (ownership) row
    n_blk = (np.floor(hi_own / G_blk).astype(np.int64)
             - blk_lo.astype(np.int64) + 1).astype(np.int32)
    n_blk_max = int(n_blk.max())
    R_max = n_blk_max * G_blk + (G_win - G_blk)
    R_max = int(-(-R_max // 8) * 8)
    if R_max > _MAX_ROWS:
        raise PlanRejected(
            "banded plan: per-baseline output rows (%d) exceed kernel K2's"
            " grid (%d rows); longest baseline %.0f m spans too many delay"
            " bins at nchan=%d" % (R_max, _MAX_ROWS, blen.max(), nchan))
    k = np.arange(nchan) - nchan // 2
    deconv = (1.0 / kb_fourier(k / n, K, alpha)).astype(np.float32)
    dh, dl = zip(*[_split(v) for v in dirs.ravel()])
    bh, blo = zip(*[_split(v) for v in blen])
    numid = nu0 + (nchan // 2) * dnu
    return BandedPlan(
        nu0=float(nu0), dnu=float(dnu), nchan=int(nchan), rank=int(rank),
        beta=float(beta), K=int(K), alpha=float(alpha), n=n, h=h,
        T_s=int(T_s), G_blk=int(G_blk), G_win=G_win,
        n_blk_max=n_blk_max, R_max=R_max,
        dirs_hi=np.asarray(dh, np.float32).reshape(dirs.shape),
        dirs_lo=np.asarray(dl, np.float32).reshape(dirs.shape),
        d_of_b=d_of_b, blk_lo=blk_lo, n_blk=n_blk,
        blen_hi=np.asarray(bh, np.float32),
        blen_lo=np.asarray(blo, np.float32),
        tap_w=kb_tap_coeffs(K, alpha, degree=tap_degree),
        deconv=deconv,
        ramp=_ramp(blk_lo, G_blk, n, nchan).astype(np.complex64),
        consts=dict(inv_ch=inv_ch, numid_c=numid / CNST.c,
                    n_blk_mean=float(np.mean(n_blk)),
                    dot_split=int(dot_split)),
        expand_idx=expand_idx, conj=conj_mask)


# --------------------------------------------------------------------------
# prep, spread, post
# --------------------------------------------------------------------------

def _two_float_u(seh, sel, dirs_hi, dirs_lo):
    """u = s_eff . b_hat_d in two-float: (D, S) pair."""
    th = tl = None
    for ax in range(3):
        ph, plo = tf.df_mul(dirs_hi[:, ax:ax + 1], dirs_lo[:, ax:ax + 1],
                            seh[None, :, ax], sel[None, :, ax])
        th, tl = (ph, plo) if th is None else tf.df_add(th, tl, ph, plo)
    return th, tl


def _payload_rows(P, S_pad):
    """The payload (S, r) as K2 takes it: (r, S_pad), zero past S."""
    S = P.shape[0]
    if S_pad != S:
        P = torch.nn.functional.pad(P, (0, 0, 0, S_pad - S))
    return P.t().contiguous()


def _prep(plan, seh, sel, P):
    """Per-direction u streams and the transposed spectral payload.

    seh/sel (S, 3) float32 two-float s_eff; P (S, r) float32 or float64,
    or None. Returns (u_h (1, D*S_pad) f32, u_l, P_r (r, S_pad) in P's
    dtype or None, ok): ok (0-d bool tensor) is False when a source vector
    is not unit, so that its bins could leave the static row range."""
    S = seh.shape[0]
    S_pad = -(-S // plan.T_s) * plan.T_s
    dev = seh.device
    uh, ul = _two_float_u(seh, sel, plan.tensor("dirs_hi", dev),
                          plan.tensor("dirs_lo", dev))
    ok = uh.abs().max() <= _UNIT_U
    if S_pad != S:
        uh = torch.nn.functional.pad(uh, (0, S_pad - S), value=_PAD_U)
        ul = torch.nn.functional.pad(ul, (0, S_pad - S))
    P_r = None if P is None else _payload_rows(P, S_pad)
    return uh.reshape(1, -1), ul.reshape(1, -1), P_r, ok


def banded_prep_plain(plan, s_eq_hi, s_eq_lo, Mh, Ml, pch, pcl, airy=None,
                      vectors=False):
    """The plain PyTorch version of kernel banded_prep (cuda_prep.py), the
    eager chain it replaces, with banded_prep_cuda's arguments and
    returns: the source vectors rotated (observe.df_rotate3) and phase
    centred in two-float, the payload of an AiryPayload `airy` (the
    truth-amps payload of make_coeff_fn_truth for airy_beam_df of its
    diameter), and _prep's u streams, payload rows and ok. Returns
    (u_h, u_l, P_r or None, ok, (sh, sl, seh, sel) with `vectors`, else
    None)."""
    sh, slo = df_rotate3(Mh, Ml, s_eq_hi, s_eq_lo)
    seh, sel = tf.df_add(sh, slo, -pch[None, :], -pcl[None, :])
    seh, sel = seh.contiguous(), sel.contiguous()
    P = None
    if airy is not None:
        P = _truth_payload(functools.partial(airy_beam_df,
                                             diameter=airy.diameter),
                           airy.nu_nodes, airy.node2coef64, sh, slo,
                           airy.flux_nodes)
    u_h, u_l, P_r, ok = _prep(plan, seh, sel, P)
    return u_h, u_l, P_r, ok, (sh, slo, seh, sel) if vectors else None


def _f32(x, dev):
    return torch.tensor(float(x), dtype=torch.float32, device=dev)


def banded_spread_plain(plan, u_h, u_l, P_r):
    """The plain PyTorch version of kernel K2: the same arithmetic, summed
    by index_add_ in float64.

    u_h/u_l (1, D*S_pad) float32 two-float u streams and P_r (r, S_pad)
    payload from _prep. Per (baseline, source): t = |b| u and the grid
    bin phi = t/(c h) in two-float, m0 = rint(phi_hi) (half to even),
    z0 = (phi_hi - m0) + phi_lo in float64, the carrier e^{-2 pi i
    nu_mid t / c} as a float64 phasor of the frac-reduced two-float cycle
    count, and the K tap weights w_j(z0) by float64 Horner on plan.tap_w.
    A valid source (u_hi < 2.5; pads sit at 3) whose first-tap row
    m0 - K//2 - blk_lo*G_blk lies in [0, n_blk*G_blk) adds
    w_j [P cos, -P sin] to row (first-tap row + j). Returns (B, R_max, 2r)
    float64 rows."""
    dev = P_r.device
    B, r, K, R = plan.nbl, plan.rank, plan.K, plan.R_max
    S = P_r.shape[1]
    uh = u_h.reshape(plan.ndir, S)
    ul = u_l.reshape(plan.ndir, S)
    dofb = torch.as_tensor(plan.d_of_b, dtype=torch.long, device=dev)
    blh = torch.as_tensor(plan.blen_hi, device=dev)[:, None]
    bll = torch.as_tensor(plan.blen_lo, device=dev)[:, None]
    ivh, ivl = (_f32(v, dev) for v in _split(plan.consts["inv_ch"]))
    nmh, nml = (_f32(v, dev) for v in _split(plan.consts["numid_c"]))
    half = K // 2
    base = torch.as_tensor(plan.blk_lo.astype(np.int64) * plan.G_blk,
                           device=dev)[:, None]
    own_hi = torch.as_tensor(plan.n_blk.astype(np.int64) * plan.G_blk,
                             device=dev)[:, None]
    row0 = (torch.arange(B, device=dev) * R)[:, None]
    P = P_r.double()
    out = torch.zeros((B * R, 2 * r), dtype=torch.float64, device=dev)
    # sources per step: the (B, s, 2r) contributions stay near 2^24 values
    src_block = max(256, (1 << 24) // max(1, B * 2 * r))
    for s0 in range(0, S, src_block):
        s1 = min(S, s0 + src_block)
        uhb, ulb = uh[dofb, s0:s1], ul[dofb, s0:s1]              # (B, s)
        th, tl = tf.df_mul(blh, bll, uhb, ulb)
        phh, phl = tf.df_mul(th, tl, ivh, ivl)
        m0 = torch.round(phh)
        z0 = (phh - m0).double() + phl.double()
        fh, fl = tf.df_frac(*tf.df_mul(th, tl, nmh, nml))
        ang = (2.0 * np.pi) * (fh.double() + fl.double())
        mown = m0.long() - half - base
        keep = (uhb < _VALID_U) & (mown >= 0) & (mown < own_hi)
        Pb = P[:, s0:s1].t()[None]                               # (1, s, r)
        X = torch.cat([Pb * torch.cos(ang)[..., None],
                       Pb * (-torch.sin(ang))[..., None]], dim=-1)
        X = X * keep[..., None]
        first = torch.where(keep, row0 + mown, torch.zeros_like(mown))
        for j, co in enumerate(np.asarray(plan.tap_w, np.float64)):
            w = torch.full_like(z0, float(co[0]))
            for c in co[1:].tolist():
                w = w * z0 + c
            out.index_add_(0, (first + j).reshape(-1),
                           (w[..., None] * X).reshape(-1, 2 * r))
    return out.reshape(B, R, 2 * r)


def banded_worklist_plain(plan, u_h, live):
    """The plain version of kernel K2's worklist: which source tiles may
    reach which items (baseline b, block rb of K2_ROWS rows).

    u_h (D*S,) float32 u streams, live (S,) the sources with a nonzero
    payload; S a multiple of K2_TILE. A tile's first-tap rows are bounded
    from [min, max] of u over its live sources (u < 2.5), in float64 as
    the kernel does: floor(|b| u_min / (c h)) - 2 - K//2 - blk_lo G_blk
    to ceil(|b| u_max / (c h)) + 2 - K//2 - blk_lo G_blk; phi is monotone
    in u, and rint and the two-float lo part move a row by less than 2.
    The tile is listed for item (b, rb) when that range meets the first-tap
    rows [R0 - K + 1, R0 + K2_ROWS - 1] that can put a tap in rows
    R0 = rb K2_ROWS .. R0 + K2_ROWS - 1, and R0 < n_blk G_blk + K - 1.
    Returns (urange (D, n_tiles, 2) float32, counts (B n_rb,) int32,
    offsets (B n_rb,) int32 exclusive scan, tiles int32: item by item, each
    item's tiles in increasing order)."""
    dev = u_h.device
    S = live.numel()
    D, B, K = plan.ndir, plan.nbl, plan.K
    n_tiles = S // K2_TILE
    n_rb = -(-plan.R_max // K2_ROWS)
    uh = u_h.reshape(D, n_tiles, K2_TILE)
    ok = live.reshape(1, n_tiles, K2_TILE).bool() & (uh < float(
        np.float32(_VALID_U)))
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    lo = torch.where(ok, uh, inf).amin(dim=2)
    hi = torch.where(ok, uh, -inf).amax(dim=2)
    dofb = plan.tensor("d_of_b", dev, torch.long)
    blen = (plan.tensor("blen_hi", dev).double()
            + plan.tensor("blen_lo", dev).double())[:, None]
    inv_ch = float(plan.consts["inv_ch"])
    off = (plan.tensor("blk_lo", dev, torch.float64) * plan.G_blk
           + K // 2)[:, None]
    row_lo = torch.floor(blen * lo[dofb].double() * inv_ch) - 2.0 - off
    row_hi = torch.ceil(blen * hi[dofb].double() * inv_ch) + 2.0 - off
    valid = (lo <= hi)[dofb]                                   # (B, n_tiles)
    R0 = torch.arange(n_rb, device=dev, dtype=torch.float64)[None, :] * K2_ROWS
    own_hi = (plan.tensor("n_blk", dev, torch.float64) * plan.G_blk)[:, None]
    item_live = R0 < own_hi + K - 1                            # (B, n_rb)
    reach = (valid[:, None, :] & item_live[:, :, None]
             & (row_hi[:, None, :] >= R0[:, :, None] - K + 1)
             & (row_lo[:, None, :] <= R0[:, :, None] + K2_ROWS - 1))
    reach = reach.reshape(B * n_rb, n_tiles)
    counts = reach.sum(dim=1).to(torch.int32)
    offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    tiles = torch.nonzero(reach)[:, 1].to(torch.int32)
    urange = torch.stack([lo, hi], dim=-1)
    return urange, counts, offsets, tiles


def banded_pair_count(plan, u_h, u_l, P_r):
    """The (baseline, source) pairs that kernel K2 spreads for these
    inputs: a valid source (u_hi < 2.5) with a nonzero payload whose
    first-tap row, binned as banded_spread_plain bins it, is owned by the
    baseline. The work K2's bound counts. Returns an int."""
    dev = P_r.device
    B, S = plan.nbl, P_r.shape[1]
    uh = u_h.reshape(plan.ndir, S)
    ul = u_l.reshape(plan.ndir, S)
    live = (P_r != 0).any(dim=0)
    dofb = plan.tensor("d_of_b", dev, torch.long)
    blh = plan.tensor("blen_hi", dev)[:, None]
    bll = plan.tensor("blen_lo", dev)[:, None]
    ivh, ivl = (_f32(v, dev) for v in _split(plan.consts["inv_ch"]))
    base = (plan.tensor("blk_lo", dev, torch.long) * plan.G_blk
            + plan.K // 2)[:, None]
    own_hi = (plan.tensor("n_blk", dev, torch.long) * plan.G_blk)[:, None]
    n = 0
    step = max(256, (1 << 26) // max(1, B))
    for s0 in range(0, S, step):
        s1 = min(S, s0 + step)
        uhb = uh[dofb, s0:s1]
        th, tl = tf.df_mul(blh, bll, uhb, ul[dofb, s0:s1])
        mown = torch.round(tf.df_mul(th, tl, ivh, ivl)[0]).long() - base
        keep = (live[None, s0:s1] & (uhb < _VALID_U) & (mown >= 0)
                & (mown < own_hi))
        n += int(keep.sum())
    return n


def _spread(plan, u_h, u_l, P_r, rows=None):
    """Kernel K2 for CUDA tensors, the plain version for CPU tensors: the
    rows added into `rows` (None: fresh zeros) and returned."""
    from .cuda_banded import banded_spread_cuda
    return banded_spread_cuda(plan, u_h, u_l, P_r, rows=rows)


def _post(plan, out, Qc):
    """Rows -> visibilities: wrap rows mod n, FFT, keep the channels,
    deconvolve, combine the ranks, apply the exact ramp, expand the
    redundancy. out (B, R_max, 2r) float64 rows; Qc (C, r) basis.
    Returns (B_full, C) complex128."""
    B = out.shape[0]
    r, n, R, C = plan.rank, plan.n, plan.R_max, plan.nchan
    m = -(-R // n)
    gw = torch.nn.functional.pad(out, (0, 0, 0, m * n - R))
    gw = gw.reshape(B, m, n, 2 * r).sum(dim=1)
    Gf = torch.fft.fft(torch.complex(gw[..., :r], gw[..., r:]), dim=1)
    half = C // 2
    Gk = torch.cat([Gf[:, n - half:, :], Gf[:, :C - half, :]], dim=1)
    dev, rdt = out.device, out.dtype
    Qd = (torch.as_tensor(Qc, device=dev).to(rdt)
          * plan.tensor("deconv64", dev, rdt)[:, None])
    V = torch.einsum("bcr,cr->bc", Gk, Qd.to(Gk.dtype))
    V = V * plan.tensor("ramp64", dev).to(V.dtype)
    if plan.expand_idx is not None:
        V = V[plan.tensor("expand_idx", dev, torch.long)]
        if plan.conj is not None and bool(np.any(plan.conj)):
            V = torch.where(plan.tensor("conj", dev)[:, None],
                            V.conj().resolve_conj(), V)
    return V


def banded_spread_available():
    """True when kernel K2 can run here: a CUDA card is visible and the K2
    library is built (building it at the first call; a failed build
    raises)."""
    if not torch.cuda.is_available():
        return False
    from .cuda_banded import _library
    return _library() is not None


def nufft_banded_visibilities(plan, seh, sel, P, Qc, interpret=False):
    """The banded NUFFT of one source set: _prep, the spread (K2 for CUDA
    tensors, its plain version for CPU tensors) and _post.

    seh/sel (S, 3) float32 two-float phase-centred source vectors; P (S, r)
    spectral coefficients (amps @ pinvQ); Qc (C, r) basis. Returns ((B, C)
    complex64, ok 0-d bool tensor); ok False: a source vector was not unit
    (its bins could leave the static rows), and the caller must fall back.
    `interpret` is checked as in observe.check_kernel_knobs: the device
    picks the kernel or its plain version."""
    check_kernel_knobs(seh.device, interpret=interpret)
    u_h, u_l, P_r, ok = _prep(plan, seh.contiguous(), sel.contiguous(), P)
    out = _spread(plan, u_h, u_l, P_r)
    return _post(plan, out, Qc).to(torch.complex64), ok


def simulate_snapshot_nufft_banded(instrument, sky, Mh, Ml, pch, pcl,
                                   beam_fn, plan, pinvQ, Q, interpret=False):
    """One accumulation through the banded engine with the full-channel
    projection (P = spectral_project(beam x flux, pinvQ)), as the
    reference's entry of the same name. Returns ((B, C) complex64, ok);
    `interpret` as in nufft_banded_visibilities."""
    check_kernel_knobs(sky.flux.device, interpret=interpret)
    seh, sel, amps, _ = snapshot_nudft_inputs(instrument, sky, Mh, Ml, pch,
                                              pcl, beam_fn)
    P = spectral_project(amps, torch.as_tensor(pinvQ, device=seh.device))
    return nufft_banded_visibilities(plan, seh, sel, P, Q)


# --------------------------------------------------------------------------
# spectral models
# --------------------------------------------------------------------------

def make_coeff_fn(freqs, rank, pinvQ, beam_fn, node_model=True):
    """coeffs(sh, fx, pch=None) -> (S, rank) float32 spectral coefficients
    of the beam-weighted fluxes: the node model (beam x flux at the rank
    Chebyshev nodes, the flux taken through its rank-r projection) or the
    full-channel projection form. pch, the snapshot's pointing dircos,
    steers a beam_fn that needs it. Carries the NodeModel (or None) as
    ``coeffs.node_model``."""
    freqs64 = np.asarray(freqs, np.float64)
    nm = chebyshev_node_model(freqs64, rank) if node_model else None
    host = ([pinvQ, freqs64.astype(np.float32)] if nm is None else
            [pinvQ, nm.V, nm.nu_nodes.astype(np.float32), nm.node2coef])
    tables = {}

    def on(dev):
        """The tables on `dev`, copied there at the first call: a copy
        from the host waits for the work queued on the device, and would
        do so in every chunk."""
        if dev not in tables:
            tables[dev] = [torch.as_tensor(x, device=dev) for x in host]
        return tables[dev]

    if not node_model:
        def coeffs(sh, fx, pch=None):
            W, f = on(sh.device)
            return spectral_project(_beam_and_flux(sh, fx, f, beam_fn,
                                                   pc=pch), W)

        coeffs.node_model = None
        return coeffs

    def coeffs(sh, fx, pch=None):
        W, V, nodes, node2coef = on(sh.device)
        fluxn = spectral_project(fx, W) @ V.t()
        ampsn = _beam_and_flux(sh, fluxn, nodes, beam_fn, pc=pch)
        return ampsn @ node2coef

    coeffs.node_model = nm
    return coeffs


def make_coeff_fn_truth(freqs, rank, beam_df_fn):
    """Node-model coefficients of the truth-amps path, in float64.

    The reference carries this chain in two-float32 (beam, flux at the
    nodes, the node -> coefficient matmul) because its f32 amps floor
    every engine at ~3.5e-6 of scale at north-star source counts; the
    card computes it in float64 instead:
      beam at the r Chebyshev nodes : beam_df_fn(sh, sl, nu_nodes), (S, r)
                                      float64 (beams.analytic.airy_beam_df)
      flux at the nodes             : host float64, (S, r), per call
      values -> coefficients        : float64 matmul with node2coef64
    Returns coeffs_df(sh, sl, flux_nodes) -> (S, r) float64; carries the
    NodeModel as .node_model."""
    nm = chebyshev_node_model(freqs, rank)
    coeffs_df = functools.partial(_truth_payload, beam_df_fn, nm.nu_nodes,
                                  nm.node2coef64)
    coeffs_df.node_model = nm
    return coeffs_df


def powerlaw_node_fluxes(spec_parms, nu_nodes):
    """The node fluxes of a power-law sky as a function of an order:
    fluxes(perm) -> (len(perm), r) float64 on perm's device, row i
    SkyModel.generate_spectrum(nu_nodes)[perm[i]], computed there in
    powerlaw_spectrum's order of operations (off + scale * (nu / ref) **
    index). Only the per-source parameters cross to the device, in
    float64, and they are gathered before the power law."""
    nodes = np.asarray(nu_nodes, np.float64)
    p = spec_parms

    def fluxes(perm):
        dev = perm.device

        def par(v):
            v = np.asarray(v, np.float64)
            return (torch.as_tensor(v, device=dev)[perm][:, None] if v.ndim
                    else float(v))

        out = torch.as_tensor(nodes, device=dev)[None, :] / par(p["freq-ref"])
        out.pow_(par(p["power-law-index"]))
        out.mul_(par(p["flux-scale"]))
        return out.add_(par(p.get("flux-offset", 0.0)))

    return fluxes


def _truth_payload(beam_df_fn, nu_nodes, node2coef64, sh, sl, flux_nodes):
    """The truth-amps payload (S, r) float64: beam_df_fn(sh, sl, nu_nodes)
    times flux_nodes, through node2coef64 (r, r)."""
    b = beam_df_fn(sh, sl, nu_nodes)
    return (b * flux_nodes) @ torch.as_tensor(node2coef64, device=b.device)


def _split64(x):
    """float64 tensor -> float32 (hi, lo) with hi + lo ~= x."""
    hi = x.float()
    return hi.contiguous(), (x - hi.double()).float().contiguous()


def make_banded_snapshot_fns(instrument, sky, beam_fn, plan, pinvQ, Q,
                             interpret=False, spatial_sort=True,
                             src_chunk=None, gate_src_block=512,
                             node_model=True, truth=None):
    """Snapshot functions of the banded engine for one sky and plan.

    The sources are reordered once by HEALPix NEST index, the order made
    on the sky's device (spatial_order, spatial_permutation's order), so
    that a tile is a compact sky patch and K2 skips most tiles for most
    row blocks: spatial_sort=False raises ValueError, and `interpret` is
    checked as in observe.check_kernel_knobs. Sources are chunked as in
    the reference: the two-float u streams take 2 x D x S_chunk floats,
    bounded at ~0.75 GiB. ``truth`` = {"beam_df": fn(sh, sl, nu_nodes) ->
    (S, r) float64, "flux_nodes": (S, r) host float64 in the ORIGINAL
    source order, or a function of the order that makes them in that
    order on its device (powerlaw_node_fluxes), and optionally
    "airy_diameter": D where fn is airy_beam_df's power pattern of a D m
    dish (the driver marks its truth form so)} selects the truth-amps
    path. Counts plan.src, the sources ordered, and plan.src_card, those
    whose order (and node fluxes, on the truth path) a CUDA device made
    with no host pass.

    A chunk's prep (rotation, u streams, payload) is one launch of kernel
    banded_prep for CUDA tensors and its plain version banded_prep_plain
    for CPU tensors. Both compute the truth payload themselves where
    truth["airy_diameter"] is given and the rank is at most
    cuda_prep.MAX_RANK; every other payload is computed from their rotated
    vectors by the torch code.

    Returns run(Mh, Ml, pch, pcl) -> ((B_full, C) complex64, ok 0-d bool
    tensor), with
      run.gate_fn(Mh, Ml, pch, pcl) -> (direct0, banded0, ok, resid,
          coherent_scale): the shared-amps gate. The same chunk inputs feed
          the banded pipeline and the direct engine. With the f32 models
          the direct side gets the true full-channel beam x flux (so the
          gate sees the model's inadequacy too); in truth mode it gets the
          float64 model amps, split hi/lo, in two direct calls, and model
          adequacy is gated separately by resid = max|model - amps| /
          max|amps| against the f32 full-channel amps. coherent_scale is
          max_c sum_s |A_sc| of the amps the direct side summed.
      run.prep_chunk(c, Mh, Ml, pch, pcl) -> (u_h, u_l, P_r, ok), the prep
          of chunk c, and run.prep_args(c, Mh, Ml, pch, pcl), its arguments,
      run.n_chunks, run.src_chunk, run.node_model and run.truth (whether
      the truth-amps path runs)."""
    dev = instrument.device
    check_kernel_knobs(dev, interpret=interpret)
    if not spatial_sort:
        raise ValueError("spatial_sort=False: the banded engine always "
                         "sorts its sources")
    S = int(sky.s_eq_hi.shape[0])
    with tracing.span("plan.sort"):
        perm, n_host = spatial_order(sky.s_eq_hi, sky.s_eq_lo)
        sky = reorder_sources(sky, perm)
    on_card = dev.type == "cuda"
    freqs_f32 = torch.as_tensor(instrument.freqs, dtype=torch.float32,
                                device=dev)
    coeffs = make_coeff_fn(instrument.freqs, plan.rank, pinvQ, beam_fn,
                           node_model=node_model)
    nm = coeffs.node_model
    coeffs_df = airy = None
    if truth is not None:
        coeffs_df = make_coeff_fn_truth(instrument.freqs, plan.rank,
                                        truth["beam_df"])
        dia = truth.get("airy_diameter")
        if dia is not None and plan.rank <= MAX_RANK:
            nmt = coeffs_df.node_model
            airy = AiryPayload(dia, nmt.nu_nodes, None, torch.as_tensor(
                np.ascontiguousarray(nmt.node2coef64), device=dev))

    if src_chunk is None:
        per_src = max(1, plan.ndir) * 8
        cap = int((768 << 20) / per_src / plan.T_s) * plan.T_s
        src_chunk = min(-(-S // plan.T_s) * plan.T_s, max(plan.T_s, cap))
    src_chunk = int(src_chunk)
    n_chunks = -(-S // src_chunk)
    S_pad = n_chunks * src_chunk
    seqh, seql, flux = sky.s_eq_hi, sky.s_eq_lo, sky.flux
    if S_pad != S:
        # zenith unit rows (|s| = 1 keeps the span check true), zero flux
        padrow = torch.zeros((S_pad - S, 3), dtype=torch.float32, device=dev)
        padrow[:, 2] = 1.0
        seqh = torch.cat([seqh, padrow])
        seql = torch.cat([seql, torch.zeros_like(padrow)])
        flux = torch.cat([flux, flux.new_zeros((S_pad - S, flux.shape[1]))])
    fn64 = None
    if truth is not None:
        with tracing.span("plan.nodes"):
            fl = truth["flux_nodes"]
            if callable(fl):
                fn64 = fl(perm)
            else:
                on_card = False
                fn64 = torch.as_tensor(np.asarray(fl, np.float64),
                                       device=dev)[perm]
            if S_pad != S:
                fn64 = torch.cat([fn64, fn64.new_zeros(
                    (S_pad - S, fn64.shape[1]))])
    tracing.count("plan.src", S)
    tracing.count("plan.src_card", S - n_host if on_card else 0)
    Qc = torch.as_tensor(nm.Q64 if nm is not None else Q,
                         dtype=torch.float64, device=dev)

    chunk_pad = -(-src_chunk // plan.T_s) * plan.T_s
    prep_fn = banded_prep_cuda if dev.type == "cuda" else banded_prep_plain

    def prep_args(c, Mh, Ml, pch, pcl):
        """The arguments of chunk c's prep: (plan, s_eq_hi, s_eq_lo, Mh,
        Ml, pch, pcl) and its AiryPayload (None: the payload follows)."""
        sl = slice(c * src_chunk, (c + 1) * src_chunk)
        kp = None if airy is None else airy._replace(flux_nodes=fn64[sl])
        return (plan, seqh[sl], seql[sl], Mh, Ml, pch, pcl), kp

    def _chunk(c, Mh, Ml, pch, pcl, vectors=False):
        """Chunk c's prep (u_h, u_l, P_r, ok) and, with `vectors`, its
        slice, rotated and phase-centred vectors and payload (sl, sh, seh,
        sel, P (S, r)), else None."""
        sl = slice(c * src_chunk, (c + 1) * src_chunk)
        tracing.count("src.processed", src_chunk)
        args, kp = prep_args(c, Mh, Ml, pch, pcl)
        u_h, u_l, P_r, ok, vecs = prep_fn(*args, airy=kp,
                                          vectors=vectors or kp is None)
        P = None
        if P_r is None:
            sh, slo = vecs[:2]
            with tracing.span("prep.payload"):
                P = (coeffs_df(sh, slo, fn64[sl]) if truth is not None
                     else coeffs(sh, flux[sl], pch))
                P_r = _payload_rows(P, chunk_pad)
        prep = (u_h, u_l, P_r, ok)
        if not vectors:
            return prep, None
        if P is None:
            P = P_r[:, :src_chunk].t().contiguous()
        return prep, (sl, vecs[0], vecs[2], vecs[3], P)

    def prep_chunk(c, Mh, Ml, pch, pcl):
        return _chunk(c, Mh, Ml, pch, pcl)[0]

    def new_rows():
        """The snapshot's float64 rows, zeroed, which every chunk's spread
        adds into."""
        return torch.zeros((plan.nbl, plan.R_max, 2 * plan.rank),
                           dtype=torch.float64, device=dev)

    def run(Mh, Ml, pch, pcl):
        rows = new_rows()
        ok = torch.ones((), dtype=torch.bool, device=dev)
        for c in range(n_chunks):
            with tracing.span("prep", chunk=c):
                u_h, u_l, P_r, okc = prep_chunk(c, Mh, Ml, pch, pcl)
            with tracing.span("k2", chunk=c):
                _spread(plan, u_h, u_l, P_r, rows=rows)
            ok = ok & okc
        with tracing.span("post"):
            return _post(plan, rows, Qc).to(torch.complex64), ok

    def gate(Mh, Ml, pch, pcl):
        C = instrument.nchan
        vd = torch.zeros((plan.nbl_full, C), dtype=torch.complex128,
                         device=dev)
        csum = torch.zeros((C,), dtype=torch.float64, device=dev)
        rows = new_rows()
        ok = True
        rmax = amax = 0.0
        for c in range(n_chunks):
            with tracing.span("gate.chunk", chunk=c):
                (u_h, u_l, P_r, okc), (sl, sh, seh, sel, P) = _chunk(
                    c, Mh, Ml, pch, pcl, vectors=True)
                _spread(plan, u_h, u_l, P_r, rows=rows)
                ok = ok and bool(okc)
                with tracing.span("gate.amps"):
                    amps = _beam_and_flux(sh, flux[sl], freqs_f32, beam_fn,
                                          pc=pch).contiguous()
                if truth is None:
                    vd += direct_visibilities(seh, sel, instrument, amps,
                                              gate_src_block)
                    csum += amps.double().abs().sum(dim=0)
                else:
                    model = P @ Qc.t()                           # (S, C)
                    for part_amps in _split64(model):
                        vd += direct_visibilities(seh, sel, instrument,
                                                  part_amps, gate_src_block)
                    rmax = max(rmax,
                               float((model - amps.double()).abs().max()))
                    amax = max(amax, float(amps.abs().max()))
                    csum += model.abs().sum(dim=0)
        vb = _post(plan, rows, Qc)
        resid = rmax / max(amax, 1e-30)
        return (vd.cpu().numpy(), vb.cpu().numpy(), ok, resid,
                float(csum.max()))

    run.gate_fn = gate
    run.prep_chunk = prep_chunk
    run.prep_args = prep_args
    run.n_chunks = n_chunks
    run.src_chunk = src_chunk
    run.node_model = nm
    run.truth = truth is not None
    return run
