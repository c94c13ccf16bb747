"""Spectral windows, delay-axis and delay-transform helpers.

Counterpart of prisim_tpu/windows.py. Window, subband and axis tables are
host numpy; the delay transform and the Fourier resampling run on torch
tensors (torch.fft).

The delay transform is an inverse FFT along the frequency axis scaled by
(n * df), with an fftshifted lag axis, optionally zero-padded by `pad`
and band-limited back to nchan lag bins.
"""

from __future__ import annotations

import numpy as np
import torch

_WINDOW_COEFFS = {
    # 4-term Blackman-Harris (minimum sidelobe).
    "bhw": (0.35875, 0.48829, 0.14128, 0.01168),
    # Blackman-Nuttall.
    "bnw": (0.3635819, 0.4891775, 0.1365995, 0.0106411),
}


def spectral_axis(nchan, delx=1.0, shift=True):
    """Lag axis (s) of an nchan FFT with bin width delx (Hz)."""
    lags = np.fft.fftfreq(nchan, d=delx)
    return np.fft.fftshift(lags) if shift else lags


def window_vals(n_window, shape="bhw", fftpow=1.0):
    """Raw window samples of the given shape and fftpow, peak ~1."""
    shape = shape.lower()
    if shape == "rect":
        return np.ones(n_window, dtype=np.float64)
    if shape not in _WINDOW_COEFFS:
        raise ValueError(f"unsupported window shape: {shape!r}")
    a0, a1, a2, a3 = _WINDOW_COEFFS[shape]
    # periodic (DFT-even) phase over the window span
    x = 2.0 * np.pi * np.arange(n_window) / n_window
    w = a0 - a1 * np.cos(x) + a2 * np.cos(2 * x) - a3 * np.cos(3 * x)
    if fftpow != 1.0:
        w = w ** fftpow
    return w


def window_frac_width(shape="bhw", fftpow=1.0, n=4096):
    """Noise-equivalent fractional width (sum w)^2/(N sum w^2) of a window."""
    w = window_vals(n, shape=shape, fftpow=fftpow)
    return float(np.sum(w) ** 2 / (n * np.sum(w ** 2)))


def window_n2width(shape="bhw", fftpow=1.0):
    """Alias matching the reference's DSP.window_N2width semantics
    (fractional effective width; PRISim's
    prisim/interferometry.py:7320-7324)."""
    return window_frac_width(shape=shape, fftpow=fftpow)


def subband_window(channels, freq_center, bw_eff, shape="bhw", fftpow=1.0):
    """Frequency weights for one spectral subband over the full channel axis.

    Builds a window of effective bandwidth bw_eff centered at freq_center,
    normalized so sum(w^2) = frac_width * n_window (the reference's
    sqrt(frac_width*n_window) x power-normalized scaling, PRISim's
    prisim/interferometry.py:7329-7342). Host numpy; the result is a static
    weight vector.
    """
    channels = np.asarray(channels, dtype=np.float64)
    df = channels[1] - channels[0]
    nchan = channels.size
    frac_width = window_frac_width(shape=shape, fftpow=fftpow)
    n_window = int(np.round(bw_eff / df / frac_width))
    n_window = max(1, min(n_window, nchan))
    w = window_vals(n_window, shape=shape, fftpow=fftpow)
    w = w / np.sqrt(np.sum(w ** 2))  # power normalize
    w = np.sqrt(frac_width * n_window) * w
    ic = int(np.argmin(np.abs(channels - freq_center)))
    full = np.zeros(nchan, dtype=np.float64)
    lo = ic - n_window // 2
    for j in range(n_window):
        k = lo + j
        if 0 <= k < nchan:
            full[k] = w[j]
    return full


def pfb_shape(nchan, coarse_channel_width=16, ntaps=8):
    """Analytic polyphase-filter-bank bandpass shape (peak ~1): each
    coarse channel carries the response of an ntaps-tap sinc-Hamming
    prototype filter."""
    W = int(coarse_channel_width)
    n = ntaps * W
    t = (np.arange(n) - (n - 1) / 2.0) / W
    proto = np.sinc(t) * np.hamming(n)
    f = (np.arange(W) - W / 2.0 + 0.5) / W
    ph = np.exp(-2j * np.pi * np.outer(f, np.arange(n) / W))
    resp = np.abs(ph @ proto)
    resp = resp / resp.max()
    reps = -(-nchan // W)
    return np.tile(resp, reps)[:nchan]


def pfb_theoretical_shape(path, freqs):
    """Measured ('theoretical') PFB bandpass shape from a FITS table.

    Format per the reference's pfb_method='theoretical' branch
    (PRISim's scripts/run_prisim.py:916-927): HDU 0 is a 2-D image of
    per-filter responses in dB (rows = frequency samples, columns =
    filters); HDU 1 is the 1-D frequency axis in MHz. Each column is
    peak-normalized in dB, the columns are summed in linear units, and
    the resulting window is interpolated onto the simulated channels (Hz)
    within [0.9 min, 1.1 max] of the band. Peak-normalized to 1 on
    return."""
    from .io.fitsio import read_fits
    hdus = [h for h in read_fits(path) if "data" in h]
    if len(hdus) < 2:
        raise ValueError("PFB file needs response + frequency HDUs")
    pfbdata = np.asarray(hdus[0]["data"], dtype=np.float64)
    pfbfreq = np.asarray(hdus[1]["data"], dtype=np.float64).ravel()
    pfbdata = np.atleast_2d(pfbdata)
    if pfbdata.shape[0] != pfbfreq.size and pfbdata.shape[1] == \
            pfbfreq.size:
        pfbdata = pfbdata.T
    norm = pfbdata.max(axis=0, keepdims=True)
    pfbwin = 10.0 * np.log10(np.sum(10.0 ** ((pfbdata - norm) / 10.0),
                                    axis=1))
    freqs = np.asarray(freqs, dtype=np.float64)
    ghz = freqs / 1e9
    lo, hi = 0.9 * ghz.min(), 1.1 * ghz.max()
    use = (pfbfreq >= lo * 1e3) & (pfbfreq <= hi * 1e3)
    if not use.any():
        raise ValueError("PFB table does not cover the simulated band")
    win = np.interp(ghz, pfbfreq[use] / 1e3, pfbwin[use])
    shape = 10.0 ** (win / 10.0)
    return shape / shape.max()


def ifft_delay_transform(vis, df, pad=0.0, axis=1):
    """Delay transform of a complex tensor along `axis`: IFFT scaled by
    (n_padded * df), fftshifted, zero-padded by the `pad` fraction and
    downsampled back to the input length."""
    nchan = vis.shape[axis]
    if pad > 0.0:
        npad = int(nchan * pad)
        zshape = list(vis.shape)
        zshape[axis] = npad
        vis = torch.cat([vis, vis.new_zeros(zshape)], dim=axis)
    n_tot = vis.shape[axis]
    lag = torch.fft.fftshift(torch.fft.ifft(vis, dim=axis), dim=axis) \
        * (n_tot * df)
    if pad > 0.0:
        lag = downsample_fourier(lag, nchan, axis=axis)
    return lag


def downsample_fourier(arr, n_out, axis=0):
    """Band-limited resampling of a (delay-domain) tensor to n_out
    samples along `axis` by FFT truncation."""
    n_in = arr.shape[axis]
    if n_in == n_out:
        return arr
    spec = torch.fft.fft(torch.fft.ifftshift(arr, dim=axis), dim=axis)
    keep_lo = (n_out + 1) // 2
    keep_hi = n_out - keep_lo
    spec_ds = torch.cat([spec.narrow(axis, 0, keep_lo),
                         spec.narrow(axis, n_in - keep_hi, keep_hi)],
                        dim=axis)
    out = torch.fft.fftshift(torch.fft.ifft(spec_ds, dim=axis), dim=axis)
    return out * (n_out / n_in)
