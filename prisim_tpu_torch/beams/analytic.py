"""Analytic primary beams on torch tensors: Airy dish and gaussian.

Counterpart of the Airy/gaussian part of prisim_tpu/beams/analytic.py.
All functions take
  dircos : (nsrc, 3) float32 direction cosines in local (E, N, U)
  freqs  : (nchan,) float32 frequencies in Hz
and return (nsrc, nchan) float32 field or power patterns, on the device
of `dircos`. `airy_beam_df` is the float64 truth pattern of the banded
engine's truth-amps path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as CNST

__all__ = ["bessel_j1", "airy_beam", "airy_beam_df", "airy_df_available",
           "gaussian_beam"]


def _j1_cheb_coeffs(deg=26):
    """Chebyshev coefficients of g(u) = J1(sqrt(u))/sqrt(u) on
    u in [0, 64] (t = u/32 - 1), fit in f64 against the J1 power series
    (exact to ~1e-14 on [0, 8])."""
    nodes = np.cos(np.pi * (np.arange(2 * deg + 2) + 0.5)
                   / (2 * deg + 2))                    # t in (-1, 1)
    u = 32.0 * (nodes + 1.0)
    xh = np.sqrt(u) / 2.0                              # x/2, <= 4
    # J1(x) = sum_m (-1)^m / (m! (m+1)!) (x/2)^(2m+1)
    g = np.zeros_like(u)
    term = 0.5 * np.ones_like(u)                       # m = 0: 1/(0!1!)/2
    x2 = xh * xh
    for m in range(1, 40):
        g += term
        term = -term * x2 / (m * (m + 1))
    return np.polynomial.chebyshev.chebfit(nodes, g, deg)


_J1_CHEB64 = _j1_cheb_coeffs()
_J1_CHEB = [float(np.float32(c)) for c in _J1_CHEB64]


def bessel_j1(x):
    """Bessel J1 in float32.

    |x| < 8: J1(x) = x * g(x^2) with g a degree-26 Chebyshev fit on
    [0, 64], Clenshaw-evaluated (O(0.1) coefficients, so f32 carries
    ~eps absolute error). |x| >= 8: the Abramowitz-Stegun asymptotic
    form (O(1) coefficients)."""
    ax = torch.abs(x)
    t = x * x * float(np.float32(1.0 / 32.0)) - 1.0
    t2 = 2.0 * t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for c in _J1_CHEB[:0:-1]:
        b1, b2 = t2 * b1 - b2 + c, b1
    g = t * b1 - b2 + _J1_CHEB[0]
    small = x * g
    z = 8.0 / torch.clamp(ax, min=1e-20)
    y2 = z * z
    p1 = 1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4
         + y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6))))
    p2 = 0.04687499995 + y2 * (-0.2002690873e-3 + y2 * (0.8449199096e-5
         + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6)))
    xx = ax - 2.356194491
    big = torch.sqrt(0.636619772 / torch.clamp(ax, min=1e-20)) * \
        (torch.cos(xx) * p1 - z * torch.sin(xx) * p2) * torch.sign(x)
    return torch.where(ax < 8.0, small, big)


def _offaxis_sin(dircos, pointing_dircos=None):
    """sin(angle from the beam axis) per source, and the horizon mask.

    With no pointing center the axis is zenith: sin = sqrt(l^2 + m^2);
    with a pointing center p, sin = sqrt(1 - (s.p)^2)."""
    if pointing_dircos is None:
        sin_t = torch.sqrt(torch.clip(dircos[:, 0] ** 2 + dircos[:, 1] ** 2,
                                      0.0, 1.0))
        return sin_t, dircos[:, 2] < 0.0
    p = torch.as_tensor(np.asarray(pointing_dircos, dtype=np.float32),
                        device=dircos.device).reshape(3)
    p = p / torch.linalg.norm(p)
    cosang = torch.clip(dircos @ p, -1.0, 1.0)
    sinang = torch.sqrt(torch.clip(1.0 - cosang ** 2, 0.0, 1.0))
    below = torch.logical_or(dircos[:, 2] < 0.0, cosang < 0.0)
    return sinang, below


def _j1_true(x, N=4096):
    """True J1 in float64 via the integral representation
    J1(x) = (1/pi) int_0^pi cos(theta - x sin(theta)) dtheta, midpoint
    rule (geometric convergence for analytic integrands). Host numpy,
    fit time only."""
    x = np.asarray(x, np.float64)
    th = (np.arange(N) + 0.5) * np.pi / N
    return np.mean(np.cos(th[None, :] - x[:, None]
                          * np.sin(th)[None, :]), axis=1)


_AIRY_TAIL_HI = 32.0


@functools.lru_cache(maxsize=None)
def _airy_tail_cheb(deg=40):
    """Chebyshev coefficients of h(x) = 2 J1(x)/x on x in [8, 32]
    (t = (x - 20)/12), fit in f64 against the true J1 integral; residual
    ~1e-16. Computed at first use (~0.3 s), not at import."""
    xs = np.linspace(8.0, _AIRY_TAIL_HI, 4001)
    h = 2.0 * _j1_true(xs) / xs
    t = (xs - 20.0) / 12.0
    return np.polynomial.chebyshev.chebfit(t, h, deg)


def _clenshaw(t, coeffs):
    """Clenshaw evaluation of a Chebyshev series at the float64 tensor t,
    in the recurrence order of the JAX package's _df_clenshaw."""
    t2 = 2.0 * t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for c in coeffs[:0:-1]:
        b1, b2 = t2 * b1 - b2 + float(c), b1
    return t * b1 - b2 + float(coeffs[0])


def airy_beam_df(s_hi, s_lo, freqs, diameter, power=True):
    """The truth Airy power pattern of the banded engine's truth-amps path,
    in float64.

    Counterpart of the JAX package's two-float `airy_beam_df`, which
    exists because the TPU has no float64; the card has it, so the same
    model is evaluated in float64 tensors: sin(theta) = sqrt(l^2 + m^2)
    from the two-float source vectors, x = pi D nu / c sin(theta), and
    2 J1(x)/x by Clenshaw on the [0, 8) Chebyshev fit of bessel_j1 and
    the degree-40 true-J1 fit on [8, 32] (no division, no trigonometry).

    s_hi, s_lo : (S, 3) float32 two-float ENU direction cosines
    freqs      : (r,) host float64 frequencies; pi*D*max(freqs)/c must be
                 <= 32 (callers check airy_df_available)
    Returns the (S, r) float64 power (or field) pattern, zero below the
    horizon (sign of the two-float Up component)."""
    freqs = np.asarray(freqs, np.float64)
    a = np.pi * freqs * (diameter / CNST.c)      # x = a * sin(theta)
    if a.max() > _AIRY_TAIL_HI:
        raise ValueError("airy_beam_df: pi*D*nu/c = %.1f exceeds the "
                         "[8,32] tail fit domain" % a.max())
    s = s_hi.double() + s_lo.double()
    s2 = torch.clamp(s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1], max=1.0)
    x = torch.sqrt(s2)[:, None] * torch.as_tensor(a, device=s.device)[None]
    small = 2.0 * _clenshaw(x * x * (1.0 / 32.0) - 1.0, _J1_CHEB64)
    tail = _clenshaw((x - 20.0) * (1.0 / 12.0), _airy_tail_cheb())
    p = torch.where(x >= 8.0, tail, small)
    if power:
        p = p * p
    return torch.where((s[:, 2] > 0.0)[:, None], p, torch.zeros_like(p))


def airy_df_available(freqs, diameter):
    """True when airy_beam_df's tail fit covers the band."""
    return (np.pi * float(np.max(freqs)) * diameter / CNST.c
            <= _AIRY_TAIL_HI)


def airy_beam(dircos, freqs, diameter, pointing_dircos=None, power=True):
    """Airy pattern of a uniformly illuminated dish, 2 J1(x)/x with
    x = k (D/2) sin(theta)."""
    sin_t, below = _offaxis_sin(dircos, pointing_dircos)
    k = 2.0 * np.pi * freqs / CNST.c
    arg = k[None, :] * (0.5 * diameter) * sin_t[:, None]
    small = torch.abs(arg) < 1e-6
    safe = torch.where(small, torch.ones_like(arg), arg)
    pattern = torch.where(small, 1.0 - arg * arg / 8.0,
                          2.0 * bessel_j1(safe) / safe)
    pattern = torch.where(below[:, None], torch.zeros_like(pattern), pattern)
    return pattern ** 2 if power else pattern


def gaussian_beam(dircos, freqs, diameter, pointing_dircos=None, power=True):
    """Chromatic gaussian with FWHM aperture `diameter`."""
    sin_t, below = _offaxis_sin(dircos, pointing_dircos)
    wl = CNST.c / freqs
    sigma_aprtr = diameter / (2.0 * np.sqrt(2.0 * np.log(2.0))) / wl
    sigma_dircos = 1.0 / (2.0 * np.pi * sigma_aprtr)
    pattern = torch.exp(-0.5 * (sin_t[:, None] / sigma_dircos[None, :]) ** 2)
    pattern = torch.where(below[:, None], torch.zeros_like(pattern), pattern)
    return pattern ** 2 if power else pattern
