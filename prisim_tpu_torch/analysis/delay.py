"""Delay-domain analysis: full-band and subband delay transforms, horizon
delay limits.

Counterpart of prisim_tpu/analysis/delay.py (the reference's
``class DelaySpectrum``, PRISim's prisim/delay_spectrum.py:493-3258, as
pure functions over a VisibilitySet). The full-band transform is
prisim_tpu_torch.vis.delay_transform; here:

* ``subband_delay_transform`` - per-subband windowed IFFT
  (subband_delay_transform, delay_spectrum.py:1842-2251): for each
  subband center a power-normalized window (BHW/BNW/rect raised to
  fftpow) of n = round((bw_eff/df)/frac_width) channels scaled by
  sqrt(frac_width*n) is placed on the full channel grid; visibilities are
  multiplied by bp*window on the host, zero-padded by `pad`, and IFFT'd
  with torch.fft in complex64 on `device`, scaled by (nchan+npad)*df. Lags
  have length nchan+npad (no downsampling, matching the reference).
* ``horizon_delay_limits`` / ``delay_envelope`` - the wedge boundary
  (PRISim's prisim/baseline_delay_horizon.py:7-131), host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as CNST
from .. import windows as win

__all__ = ["delay_envelope", "horizon_delay_limits",
           "subband_delay_transform", "subband_lags",
           "horizon_limits_for_vs"]


def delay_envelope(bl, dircos):
    """(N_dircos, M_bl, 2): [...,0] = |b|/c, [...,1] = (s.b)/c
    (PRISim's prisim/baseline_delay_horizon.py:7-96)."""
    bl = np.atleast_2d(np.asarray(bl, dtype=np.float64))
    dircos = np.atleast_2d(np.asarray(dircos, dtype=np.float64))
    if dircos.shape[1] == 2:
        n = np.sqrt(np.maximum(0.0, 1.0 - np.sum(dircos ** 2, axis=1)))
        dircos = np.hstack([dircos, n[:, None]])
    norm = np.sqrt(np.sum(dircos ** 2, axis=1))
    if np.any(norm > 1.0 + 1e-10):
        raise ValueError("direction cosines exceed unit magnitude")
    if np.any(dircos[:, 2] < 0.0):
        raise ValueError("direction cosines must be above the horizon")
    dmax = np.broadcast_to(
        np.sqrt(np.sum(bl ** 2, axis=1))[None, :] / CNST.c,
        (dircos.shape[0], bl.shape[0]))
    dshift = dircos[:, :bl.shape[1]] @ bl.T / CNST.c
    return np.stack([dmax, dshift], axis=-1)


def horizon_delay_limits(bl, dircos):
    """(N, M, 2): [...,0] min delay, [...,1] max delay after phase-center
    shift (PRISim's prisim/baseline_delay_horizon.py:100-131)."""
    d = delay_envelope(bl, dircos)
    return np.stack([-d[..., 0] - d[..., 1], d[..., 0] - d[..., 1]],
                    axis=-1)


def horizon_limits_for_vs(vs, phase_center=None, phase_center_coords=None):
    """Horizon delay limits (n_acc, nbl, 2) for a VisibilitySet's phase
    centers (DelaySpectrum.get_horizon_delay_limits,
    PRISim's prisim/delay_spectrum.py:2976-3033)."""
    from ..vis import to_dircos
    if phase_center is None:
        phase_center = vs.phase_center
        phase_center_coords = vs.phase_center_coords
    if phase_center is None:
        phase_center = np.asarray([[90.0, 270.0]])
        phase_center_coords = "altaz"
    dc = to_dircos(phase_center, phase_center_coords, vs.lst, vs.latitude)
    return horizon_delay_limits(np.asarray(vs.baselines), dc)


def subband_lags(nchan, df, pad=1.0):
    npad = int(nchan * pad)
    return win.spectral_axis(nchan + npad, delx=df, shift=True)


def subband_delay_transform(vs, freq_center, bw_eff, shape="bhw",
                            fftpow=1.0, pad=1.0, resample=False,
                            device="cuda"):
    """Windowed subband delay transform of all visibility cubes, the
    IFFTs on `device` ('cuda' raises without a card).

    freq_center / bw_eff: arrays (n_win,) in Hz. Returns a dict of host
    arrays: freq_center, bw_eff, freq_wts (n_win, nchan), lags (nlag,),
    and per-cube '<name>_lag' of shape (nbl, n_win, nlag, n_acc)."""
    from ..driver import resolve_device
    dev = resolve_device(device)
    freq_center = np.atleast_1d(np.asarray(freq_center, dtype=np.float64))
    bw_eff = np.broadcast_to(
        np.atleast_1d(np.asarray(bw_eff, dtype=np.float64)),
        freq_center.shape).astype(np.float64)
    channels = np.asarray(vs.freqs, dtype=np.float64)
    nchan = channels.size
    df = vs.freq_resolution
    freq_wts = np.stack(
        [win.subband_window(channels, fc, bw, shape=shape, fftpow=fftpow)
         for fc, bw in zip(freq_center, bw_eff)], axis=0)
    npad = int(nchan * pad)
    lags = subband_lags(nchan, df, pad)
    bp, _ = vs.default_bp()
    out = dict(freq_center=freq_center, bw_eff=bw_eff, freq_wts=freq_wts,
               lags=lags, shape=shape, fftpow=fftpow, pad=pad)
    scale = (nchan + npad) * df

    def _ift(x, dim):
        # complex64 (..., nchan, ...) on the host -> zero-padded IFFT along
        # dim on the device, fftshifted and scaled; stays on the device
        x = torch.as_tensor(np.ascontiguousarray(x, np.complex64),
                            device=dev)
        return torch.fft.fftshift(torch.fft.ifft(x, n=nchan + npad, dim=dim),
                                  dim=dim) * scale

    lag_dev = {}
    for name, arr in vs._vis_cubes():
        # (nbl, nchan, nacc) -> (nbl, nwin, nchan, nacc)
        x = (np.asarray(arr)[:, None, :, :] * bp[:, None, :, :]
             * freq_wts[None, :, :, None])
        lag_dev[name] = _ift(x, 2)
        out[name + "_lag"] = lag_dev[name].cpu().numpy()
    # window lag kernel (nwin, nlag): IFFT of the bp-less window
    out["lag_kernel"] = _ift(freq_wts, 1).cpu().numpy()
    # correlation length of adjacent lag bins in units of lag spacing
    # (DelaySpectrum's lag_corr_length; oversampling factor of the
    # effective subband resolution 1/bw_eff)
    out["lag_corr_length"] = ((nchan + npad) * df
                              / np.maximum(bw_eff, df))
    if resample:
        # 'resampled' products: decimate the lag axis to ~independent
        # delay bins (subband_delay_transform resampled variants,
        # PRISim's prisim/delay_spectrum.py:2252-2517)
        factor = max(1, int(np.floor(out["lag_corr_length"].min())))
        n_out = max(2, lags.size // factor)
        # band-limited decimation keeps the lag span (1/df); the new
        # grid is the spectral axis of n_out samples at spacing df
        out["lags_resampled"] = win.spectral_axis(n_out, delx=df,
                                                  shift=True)
        for name, y in lag_dev.items():
            out[name + "_lag_resampled"] = win.downsample_fourier(
                y, n_out, axis=2).cpu().numpy()
    return out
