"""Cosmological delay power spectrum: Jy Hz delay spectra -> K^2 (Mpc/h)^3.

Rebuild of ``class DelayPowerSpectrum`` (PRISim's prisim/
delay_spectrum.py:3260-4543). The normalization chain
(compute_power_spectrum, :3982-4066):

  P(k) = |V_lag|^2 * jacobian1 * jacobian2 * Jy2K^2
  jacobian1 = 1 / omega_bw          (beam 3D volume, Sr Hz)
  jacobian2 = rz_los^2 * drz_los / bw
  Jy2K      = wl^2 Jy / (2 k_B)

with k_parallel = dkprll_deta(z) * lags and
k_perp = 2 pi |b| / (wl * D_M(z)).

Host numpy copy of prisim_tpu/analysis/power_spectrum.py, code unchanged
(imports relative)."""

from __future__ import annotations

import numpy as np

from .. import constants as CNST
from .cosmology import (cosmo100, k_parallel, k_perp,
                        comoving_depth, jy2k, freq_to_z)

__all__ = ["beam3Dvol", "delay_power_spectrum", "subband_power_spectra",
           "baseline_orientation_bins"]


def beam3Dvol(beam, freqs, freq_wts=None, pixarea_sr=None,
              hemisphere=True):
    """3-D beam volume integral sum(beam^2) dOmega dnu in Sr Hz
    (PRISim's prisim/delay_spectrum.py:395-492). beam: (npix,) or
    (npix, nchan) power pattern on HEALPix pixels (peak-normalized);
    freq_wts: optional (nchan,) or (nwin, nchan) window weights.
    NOTE: follows the reference in squaring the beam AND the frequency
    weights (power-pattern convention)."""
    beam = np.asarray(beam, dtype=np.float64)
    freqs = np.asarray(freqs, dtype=np.float64)
    nchan = freqs.size
    if beam.ndim == 1:
        beam = beam[:, None]
    if beam.shape[1] == 1:
        beam = np.broadcast_to(beam, (beam.shape[0], nchan))
    npix = beam.shape[0]
    if pixarea_sr is None:
        from .. import healpix as hp
        nside = hp.npix2nside(npix)
        pixarea_sr = hp.nside2pixarea(nside)
    if hemisphere:
        # upper hemisphere = first half of the ring-ordered sphere
        beam = beam[:npix // 2]
    df = freqs[1] - freqs[0] if nchan > 1 else 1.0
    if freq_wts is None:
        freq_wts = np.ones((1, nchan))
    freq_wts = np.atleast_2d(np.asarray(freq_wts, dtype=np.float64))
    integrand = beam[None, :, :] ** 2 * freq_wts[:, None, :] ** 2
    vol = np.sum(integrand, axis=(1, 2)) * pixarea_sr * df
    return vol if vol.size > 1 else float(vol[0])


def delay_power_spectrum(vs_lagged, omega_bw, cosmo=cosmo100):
    """Full-band delay power spectrum of a delay-transformed
    VisibilitySet. Returns a dict with z, kprll, kperp, horizon k-limits,
    conversion factor, and '<name>' P(k) cubes (nbl, nlag, nacc) in
    K^2 (Mpc/h)^3."""
    freqs = np.asarray(vs_lagged.freqs, dtype=np.float64)
    f0 = float(freqs[freqs.size // 2])
    bw = vs_lagged.freq_resolution * freqs.size
    wl0 = CNST.c / f0
    z = float(freq_to_z(f0))
    rz = cosmo.comoving_distance(z)
    drz = comoving_depth(bw, z, cosmo)
    jac1 = 1.0 / omega_bw
    jac2 = rz ** 2 * drz / bw
    factor = jac1 * jac2 * jy2k(wl0) ** 2
    lags = np.asarray(vs_lagged.lags)
    out = dict(z=z, f0=f0, bw=bw, rz_los=rz, drz_los=drz,
               jacobian1=jac1, jacobian2=jac2, Jy2K=float(jy2k(wl0)),
               factor=factor,
               kprll=k_parallel(lags, z, cosmo),
               kperp=k_perp(vs_lagged.baseline_lengths, z, wl0, cosmo))
    from .delay import horizon_limits_for_vs
    hlim = horizon_limits_for_vs(vs_lagged)      # (nacc, nbl, 2) seconds
    out["horizon_kprll_limits"] = k_parallel(hlim, z, cosmo)
    for name in ("skyvis_lag", "vis_lag", "vis_noise_lag"):
        cube = getattr(vs_lagged, name)
        if cube is not None:
            key = {"skyvis_lag": "skyvis", "vis_lag": "vis",
                   "vis_noise_lag": "noise"}[name]
            out[key] = np.abs(np.asarray(cube)) ** 2 * factor
    return out


def subband_power_spectra(vs, sbds, beam, beam_freqs=None, cosmo=cosmo100,
                          pixarea_sr=None):
    """Per-subband power spectra from a subband_delay_transform result
    dict `sbds` (DelayPowerSpectrum.compute_power_spectrum subband branch,
    PRISim's prisim/delay_spectrum.py:4003-4046).

    beam: (npix,) or (npix, nchan) power pattern for beam3Dvol.
    Returns dict with per-subband z, kprll (nwin, nlag),
    kperp (nwin, nbl), factors (nwin,) and P(k) cubes
    (nbl, nwin, nlag, nacc)."""
    freq_center = np.asarray(sbds["freq_center"], dtype=np.float64)
    bw_eff = np.asarray(sbds["bw_eff"], dtype=np.float64)
    lags = np.asarray(sbds["lags"])
    z = freq_to_z(freq_center)
    wl = CNST.c / freq_center
    rz = np.asarray([cosmo.comoving_distance(zz) for zz in z])
    drz = comoving_depth(bw_eff, z, cosmo)
    omega_bw = beam3Dvol(beam, np.asarray(vs.freqs, dtype=np.float64),
                         freq_wts=sbds["freq_wts"],
                         pixarea_sr=pixarea_sr)
    omega_bw = np.broadcast_to(np.atleast_1d(omega_bw),
                               freq_center.shape)
    jac1 = 1.0 / omega_bw
    jac2 = rz ** 2 * drz / bw_eff
    factor = jac1 * jac2 * jy2k(wl) ** 2        # (nwin,)
    kprll = np.stack([k_parallel(lags, zz, cosmo) for zz in z])
    kperp = np.stack([k_perp(vs.baseline_lengths, zz, w, cosmo)
                      for zz, w in zip(z, wl)])
    out = dict(z=z, freq_center=freq_center, bw_eff=bw_eff,
               rz_los=rz, drz_los=drz, jacobian1=jac1, jacobian2=jac2,
               Jy2K=jy2k(wl), factor=factor, kprll=kprll, kperp=kperp,
               lags=lags)
    conv = factor.reshape(1, -1, 1, 1)
    for name in ("skyvis_lag", "vis_lag", "vis_noise_lag"):
        if name in sbds:
            key = {"skyvis_lag": "skyvis", "vis_lag": "vis",
                   "vis_noise_lag": "noise"}[name]
            out[key] = np.abs(np.asarray(sbds[name])) ** 2 * conv
    return out


def baseline_orientation_bins(baselines, n_bins=4):
    """Bin baselines by orientation angle in the ENU plane.

    The reference's processing.n_bins_blo parameter (defaultparms.yaml:
    847; parsed at run_prisim.py:225) bins baselines into
    n_bins_baseline_orientation east-of-north angle bins for
    orientation-resolved delay power spectra. Angles are folded to
    [-90, 90) deg (a baseline and its conjugate share a bin); bin i
    covers [-90 + i*180/n, -90 + (i+1)*180/n).

    Returns (bin_index (nbl,), bin_centers_deg (n_bins,))."""
    b = np.asarray(baselines, dtype=np.float64)
    ang = np.degrees(np.arctan2(b[:, 0], b[:, 1]))     # east of north
    ang = (ang + 90.0) % 180.0 - 90.0
    width = 180.0 / int(n_bins)
    idx = np.floor((ang + 90.0) / width).astype(int)
    idx = np.clip(idx, 0, int(n_bins) - 1)
    centers = -90.0 + width * (np.arange(int(n_bins)) + 0.5)
    return idx, centers
