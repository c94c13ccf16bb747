"""Analytic primary beams on torch tensors.

Counterpart of prisim_tpu/beams/analytic.py: the Airy dish and gaussian,
the finite dipole and its ground-plane factor, the VLA/GMRT PBCOR
polynomials, uniform rectangular and square apertures, the beamformer
array factor (MWA tile), arbitrary apertures of isotropic radiators and
their feed illumination. All functions take
  dircos : (nsrc, 3) float32 direction cosines in local (E, N, U)
  freqs  : (nchan,) float32 frequencies in Hz
and return (nsrc, nchan) float32 field or power patterns (complex64
(nsrc, nchan, nrand) fields for the array factors), on the device of
`dircos`. `airy_beam_df` is the float64 truth pattern of the banded
engine's truth-amps path.

Random delay and gain errors are drawn from a torch.Generator; with none
given, a fresh one seeded 0 on the tensors' device, so every call repeats
its realization (the JAX package draws from jax.random.PRNGKey(0); the
values differ draw for draw).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as CNST

__all__ = ["bessel_j1", "airy_beam", "airy_beam_df", "airy_df_available",
           "gaussian_beam", "dipole_beam", "ground_plane_pattern",
           "vla_pbcor_beam", "gmrt_beam", "uniform_rect_aperture_beam",
           "uniform_square_aperture_beam", "mwa_tile_positions",
           "array_field_pattern", "generic_aperture_field_pattern",
           "feed_illumination_of_aperture",
           "feed_aperture_combined_field_pattern"]


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


def _to(t, device):
    """Tensor `t` on `device` (None: where it is). A copy from host memory
    does not wait for the work queued on the device: a host-to-device
    copy from pageable memory is staged when it is called, so the host
    array may change or go at once."""
    if device is None:
        return t
    return t.to(device, non_blocking=t.device.type == "cpu")


def _as_f32(x, device):
    """A tensor on `device` from an array, a sequence or a tensor, in the
    dtypes the JAX package computes in: float64 becomes float32 and
    complex128 complex64."""
    t = _to(torch.as_tensor(x), device)
    if t.dtype == torch.float64:
        return t.float()
    if t.dtype == torch.complex128:
        return t.to(torch.complex64)
    return t


def _vec3(p, like):
    """A direction (3-sequence, array or tensor) as a float32 (3,) tensor
    on the device of `like`."""
    if not torch.is_tensor(p):
        p = torch.as_tensor(np.asarray(p, dtype=np.float32))
    return _to(p, like.device).to(torch.float32).reshape(3)


def _unit_axis(pointing_dircos, like):
    """The beam axis `pointing_dircos` as a unit float32 (3,) tensor on the
    device of `like`."""
    p = _vec3(pointing_dircos, like)
    return p / torch.linalg.norm(p)


def _offaxis_sin(dircos, pointing_dircos=None):
    """sin(angle from the beam axis) per source, and the horizon mask.

    With no pointing center the axis is zenith: sin = sqrt(l^2 + m^2);
    with a pointing center p, sin = sqrt(1 - (s.p)^2)."""
    if pointing_dircos is None:
        sin_t = torch.sqrt(torch.clip(dircos[:, 0] ** 2 + dircos[:, 1] ** 2,
                                      0.0, 1.0))
        return sin_t, dircos[:, 2] < 0.0
    p = _unit_axis(pointing_dircos, dircos)
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
    a = _airy_df_scale(freqs, diameter)
    s = s_hi.double() + s_lo.double()
    s2 = torch.clamp(s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1], max=1.0)
    x = torch.sqrt(s2)[:, None] * torch.as_tensor(a, device=s.device)[None]
    small = 2.0 * _clenshaw(x * x * (1.0 / 32.0) - 1.0, _J1_CHEB64)
    tail = _clenshaw((x - 20.0) * (1.0 / 12.0), _airy_tail_cheb())
    p = torch.where(x >= 8.0, tail, small)
    if power:
        p = p * p
    return torch.where((s[:, 2] > 0.0)[:, None], p, torch.zeros_like(p))


def _airy_df_scale(freqs, diameter):
    """airy_beam_df's float64 factors a = pi D nu / c (x = a sin(theta)) of
    the (r,) host frequencies; raises ValueError past the tail fit."""
    freqs = np.asarray(freqs, np.float64)
    a = np.pi * freqs * (diameter / CNST.c)
    if a.max() > _AIRY_TAIL_HI:
        raise ValueError("airy_beam_df: pi*D*nu/c = %.1f exceeds the "
                         "[8,32] tail fit domain" % a.max())
    return a


def airy_df_available(freqs, diameter):
    """True when airy_beam_df's tail fit covers the band."""
    return (np.pi * float(np.max(freqs)) * diameter / CNST.c
            <= _AIRY_TAIL_HI)


def _airy_arg_scale(freqs, diameter):
    """k D/2 per channel (k = 2 pi nu / c): airy_beam's argument is this
    times sin(theta)."""
    k = 2.0 * np.pi * freqs / CNST.c
    return k * (0.5 * diameter)


def airy_beam(dircos, freqs, diameter, pointing_dircos=None, power=True):
    """Airy pattern of a uniformly illuminated dish, 2 J1(x)/x with
    x = k (D/2) sin(theta)."""
    sin_t, below = _offaxis_sin(dircos, pointing_dircos)
    arg = _airy_arg_scale(freqs, diameter)[None, :] * sin_t[:, None]
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


def dipole_beam(dircos, freqs, length, orientation_dircos=(1.0, 0.0, 0.0),
                short_dipole=False, half_wave=False, power=True):
    """Finite-length dipole field pattern
      E = (cos(kh cos a) - cos(kh)) / sin a, normalized by (1 - cos kh),
    where a is the angle between source and dipole axis."""
    d = _vec3(orientation_dircos, dircos)
    d = d / torch.linalg.norm(d)
    cosa = torch.clip(dircos @ d, -1.0, 1.0)
    sina = torch.sqrt(torch.clip(1.0 - cosa ** 2, 1e-12, 1.0))
    shape = (dircos.shape[0], freqs.shape[0])
    if short_dipole:
        pattern = sina[:, None].expand(shape)
        return pattern ** 2 if power else pattern
    if half_wave:
        pattern = (torch.cos(0.5 * np.pi * cosa) / sina)[:, None].expand(shape)
        return pattern ** 2 if power else pattern
    k = 2.0 * np.pi * freqs / CNST.c
    kh = k * (0.5 * length)
    maxpat = 1.0 - torch.cos(kh)
    num = torch.cos(kh[None, :] * cosa[:, None]) - torch.cos(kh)[None, :]
    pattern = num / sina[:, None] / maxpat[None, :]
    # L'Hopital limit as a -> 0: kh sin(kh cos a) tan(a) -> 0
    pattern = torch.where((torch.abs(torch.abs(cosa) - 1.0) < 1e-10)[:, None],
                          torch.zeros_like(pattern), pattern)
    return pattern ** 2 if power else pattern


def ground_plane_pattern(dircos, freqs, height, modifier=None, power=False):
    """Image-dipole ground-plane factor 2 sin(k h sin(alt)), peak-normalized."""
    k = 2.0 * np.pi * freqs / CNST.c
    sinalt = torch.clip(dircos[:, 2], 0.0, 1.0)
    gp = 2.0 * torch.sin(k[None, :] * height * sinalt[:, None])
    if modifier is not None:
        val = 1.0 / torch.sqrt(torch.clip(torch.abs(dircos[:, 2]), min=1e-10))
        if "scale" in modifier:
            val = val * modifier["scale"]
        if "max" in modifier:
            val = torch.clip(val, 0.0, modifier["max"])
        gp = gp * val[:, None]
    gp = gp / (2.0 * torch.sin(k[None, :] * height))
    return gp ** 2 if power else gp


_VLA_FREQ_REF = np.array([0.0738, 0.3275, 1.465, 4.885, 8.435, 14.965,
                          22.485, 43.315])
_VLA_PARMS = np.array([
    [-0.897, 2.71, -0.242], [-0.935, 3.23, -0.378], [-1.343, 6.579, -1.186],
    [-1.372, 6.940, -1.309], [-1.306, 6.253, -1.100],
    [-1.305, 6.155, -1.030], [-1.417, 7.332, -1.352],
    [-1.321, 6.185, -0.983]])

_GMRT_FREQ_REF = np.array([0.235, 0.325, 0.610, 1.420])
_GMRT_PARMS = {
    "gmrt": np.array([[-3.366, 46.159, -29.963, 7.529],
                      [-3.397, 47.192, -30.931, 7.803],
                      [-3.486, 47.749, -35.203, 10.399],
                      [-2.27961, 21.4611, -9.7929, 1.80153]]),
    "ugmrt": np.array([[np.nan] * 4,
                       [-2.939, 33.312, -16.659, 3.006],
                       [-3.190, 38.642, -20.471, 3.964],
                       [-2.608, 27.357, -13.091, 2.365]]),
}


def _offaxis_deg(dircos):
    n = torch.clip(dircos[:, 2], -1.0, 1.0)
    return torch.rad2deg(torch.arccos(n))


def _band_index(ref_ghz, freqs, band_freq):
    """The PBCOR band nearest the first frequency: `band_freq` (Hz, a host
    number) where the caller has it, else freqs[0] (a device read)."""
    f0 = float(freqs[0]) if band_freq is None else float(band_freq)
    return int(np.argmin(np.abs(ref_ghz - f0 / 1e9)))


def _pbcor_x(dircos, freqs):
    """(angle[arcmin] * freq[GHz])^2, (nsrc, nchan)."""
    ang = _offaxis_deg(dircos)
    f_ghz = torch.as_tensor(freqs, device=dircos.device).float() / 1e9
    return (ang[:, None] * 60.0 * f_ghz[None, :]) ** 2


def vla_pbcor_beam(dircos, freqs, clip_negative=True, band_freq=None):
    """AIPS PBCOR 3-term polynomial in (angle[arcmin] * freq[GHz])^2, the
    band selected by the first frequency (`band_freq`, see _band_index)."""
    a1, a2, a3 = (float(a) for a in _VLA_PARMS[
        _band_index(_VLA_FREQ_REF, freqs, band_freq)])
    x = _pbcor_x(dircos, freqs)
    pb = 1.0 + a1 * x / 1e3 + a2 * x ** 2 / 1e7 + a3 * x ** 3 / 1e10
    if clip_negative:
        pb = torch.clip(pb, min=0.0)
    return pb


def gmrt_beam(dircos, freqs, instrument="gmrt", clip_negative=True,
              band_freq=None):
    """GMRT/uGMRT PBCOR 4-term polynomial (uGMRT has no 235 MHz band: NaN
    there, as in the reference)."""
    a1, a2, a3, a4 = (float(a) for a in _GMRT_PARMS[instrument][
        _band_index(_GMRT_FREQ_REF, freqs, band_freq)])
    x = _pbcor_x(dircos, freqs)
    pb = (1.0 + a1 * x / 1e3 + a2 * x ** 2 / 1e7 + a3 * x ** 3 / 1e10
          + a4 * x ** 4 / 1e13)
    if clip_negative:
        pb = torch.clip(pb, min=0.0)
    return pb


def _sinc(x):
    return torch.sinc(x)  # normalized sinc sin(pi x)/(pi x)


def uniform_rect_aperture_beam(dircos, freqs, sides,
                               pointing_dircos=None, power=True):
    """sinc x sinc pattern of a uniformly illuminated rectangular aperture."""
    wl = CNST.c / freqs
    if pointing_dircos is None:
        rel = dircos
    else:
        rel = dircos - _vec3(pointing_dircos, dircos).reshape(1, 3)
    arg1 = sides[0] * rel[:, 0][:, None] / wl[None, :]
    arg2 = sides[1] * rel[:, 1][:, None] / wl[None, :]
    ab = _sinc(arg1) * _sinc(arg2)
    ab = torch.where((dircos[:, 2] < 0.0)[:, None], torch.zeros_like(ab), ab)
    return ab ** 2 if power else ab


def uniform_square_aperture_beam(dircos, freqs, side, pointing_dircos=None,
                                 power=True):
    return uniform_rect_aperture_beam(dircos, freqs, (side, side),
                                      pointing_dircos=pointing_dircos,
                                      power=power)


def mwa_tile_positions():
    """4x4 grid of dipoles, 1.1 m spacing."""
    x, y = np.meshgrid(1.1 * np.linspace(-1.5, 1.5, 4),
                       1.1 * np.linspace(1.5, -1.5, 4))
    return np.stack([x.ravel(), y.ravel(), np.zeros(16)], axis=-1)


def _normal(shape, generator, device):
    """Standard normal draws from `generator` (on its own device), moved to
    `device`."""
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


def _array_factor(geom_delay, delays, gains, freqs, nelem):
    """(1/N) sum_a g_a exp(i 2 pi nu (geom_a + d_a)), summed element by
    element so that the (nsrc, nelem, nchan, nrand) phase array is never
    formed. geom_delay (nsrc, nelem); delays and gains (nelem, nchan|1,
    nrand|1). Returns (nsrc, nchan|1, nrand|1) complex64."""
    w = (2.0 * np.pi * freqs)[None, :, None]
    af = None
    for a in range(nelem):
        phase = w * (geom_delay[:, a, None, None] + delays[a][None])
        term = gains[a][None] * torch.polar(torch.ones_like(phase), phase)
        af = term if af is None else af + term
    return af / nelem


def array_field_pattern(element_pos, dircos, freqs, pointing_dircos=None,
                        delays=None, gains=None, delayerr=0.0, gainerr_db=0.0,
                        nrand=1, generator=None):
    """Beamformer array factor with optional random delay/gain errors.

    AF(s, nu) = (1/N) sum_a g_a exp(i 2 pi nu (delta_a - s.x_a / c))
    with delta_a = x_a . p / c delay compensation toward pointing p.
    Returns (nsrc, nchan, nrand) complex64."""
    dev = dircos.device
    element_pos = _as_f32(element_pos, dev).float()
    nant = element_pos.shape[0]
    if delays is None:
        if pointing_dircos is not None:
            delays = (element_pos @ _vec3(pointing_dircos, dircos)) / CNST.c
        else:
            delays = torch.zeros(nant, device=dev)
    else:
        delays = _as_f32(delays, dev).reshape(nant)
    gains = (torch.ones(nant, device=dev) if gains is None
             else _as_f32(gains, dev).reshape(nant))
    d = delays[:, None] + torch.zeros((nant, nrand), device=dev)
    g = gains[:, None] + torch.zeros((nant, nrand), device=dev)
    if delayerr > 0.0 or gainerr_db > 0.0:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if delayerr > 0.0:
            d = d + delayerr * _normal((nant, nrand), generator, dev)
        if gainerr_db > 0.0:
            g = g * 10.0 ** ((gainerr_db / 10.0)
                             * _normal((nant, nrand), generator, dev))
    geom_delay = -(dircos @ element_pos.t()) / CNST.c        # (nsrc, nant)
    return _array_factor(geom_delay, d[:, None, :], g[:, None, :], freqs,
                         nant)


def _bc_element_chan(x, nelem, nchan, what):
    """Normalize per-element/per-channel tensors to (nelem|1, nchan|1):
    scalar, (nelem,), (nchan,), (nelem, nchan), or already-3D
    (nelem, nchan, nrand) (returned unchanged)."""
    if x.ndim == 0:
        return x.reshape(1, 1)
    if x.ndim == 1:
        if x.shape[0] == nelem:
            return x.reshape(nelem, 1)
        if x.shape[0] == nchan:
            return x.reshape(1, nchan)
        if x.shape[0] == 1:
            return x.reshape(1, 1)
        raise ValueError("size of %s inconsistent with elements/channels"
                         % what)
    if x.ndim in (2, 3):
        return x
    raise ValueError("%s must be scalar, 1-D, 2-D or 3-D" % what)


def generic_aperture_field_pattern(aperture_locs, dircos, freqs,
                                   pointing_dircos=None, delays=None,
                                   gains=None, delayerr=0.0,
                                   gainerr_db=0.0, nrand=1, generator=None,
                                   power=False):
    """Field pattern of an arbitrary aperture of isotropic radiators.

    Generalizes array_field_pattern with FREQUENCY-DEPENDENT complex
    element gains and delays: scalars, (nelem,), (nchan,),
    (nelem, nchan), or (nelem, nchan, nrand).

    AF(s, nu) = (1/N) sum_a g_a(nu) exp(i 2 pi nu (d_a(nu) - s.x_a/c)),
    d_a defaulting to x_a.p/c delay compensation toward pointing p.
    Returns (nsrc, nchan, nrand) complex64, or the power pattern
    mean_nrand |AF|^2 (nsrc, nchan) when power=True."""
    dev = dircos.device
    aperture_locs = _as_f32(aperture_locs, dev).float()
    if aperture_locs.shape[1] == 2:
        aperture_locs = torch.cat(
            [aperture_locs, torch.zeros((aperture_locs.shape[0], 1),
                                        device=dev)], dim=1)
    nelem = aperture_locs.shape[0]
    nchan = freqs.shape[0]
    if delays is None:
        if pointing_dircos is not None:
            p = _vec3(pointing_dircos, dircos)
            delays = ((aperture_locs @ p) / CNST.c).reshape(nelem, 1)
        else:
            delays = torch.zeros((1, 1), device=dev)
    else:
        delays = _bc_element_chan(_as_f32(delays, dev), nelem, nchan,
                                  "delays")
    gains = torch.ones((1, 1), device=dev) if gains is None else \
        _bc_element_chan(_as_f32(gains, dev), nelem, nchan, "gains")
    if delays.ndim == 2:
        delays = delays[:, :, None]
    if gains.ndim == 2:
        gains = gains[:, :, None]
    if delayerr > 0.0 or gainerr_db > 0.0:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if delayerr > 0.0:
            delays = delays + delayerr * _normal((nelem, 1, nrand),
                                                 generator, dev)
        if gainerr_db > 0.0:
            gains = gains * 10.0 ** ((gainerr_db / 10.0)
                                     * _normal((nelem, 1, nrand),
                                               generator, dev))
    nr = max(int(nrand), delays.shape[-1], gains.shape[-1])
    # per-element tables broadcast over the elements (a (1, ...) table
    # serves every element)
    delays = delays.expand((nelem,) + delays.shape[1:])
    gains = gains.expand((nelem,) + gains.shape[1:])
    geom_delay = -(dircos @ aperture_locs.t()) / CNST.c      # (nsrc, nelem)
    af = _array_factor(geom_delay, delays, gains, freqs, nelem)
    af = af.expand(af.shape[0], nchan, nr)
    if power:
        return torch.mean(torch.abs(af) ** 2, dim=-1)
    return af


def _feed_sky_field(feedinfo, dircos, freqs, short_dipole=False,
                    half_wave=True):
    """Complex feed element field at the given directions: the shared
    shape dispatch of feed_illumination_of_aperture /
    feed_aperture_combined_field_pattern. Returns (nsrc, nchan, nrand)
    complex64."""
    shape = (feedinfo or {}).get("shape", "delta")
    nsrc = dircos.shape[0]
    nchan = freqs.shape[0]
    if shape == "delta":
        ep = torch.ones((nsrc, nchan), device=dircos.device)
    elif shape == "dipole":
        ep = dipole_beam(dircos, freqs, feedinfo["size"],
                         orientation_dircos=feedinfo.get(
                             "orientation_dircos", (1.0, 0.0, 0.0)),
                         short_dipole=short_dipole, half_wave=half_wave,
                         power=False)
    elif shape == "dish":
        ep = airy_beam(dircos, freqs, feedinfo["size"], power=False)
    elif shape == "rect":
        ep = uniform_rect_aperture_beam(dircos, freqs, feedinfo["size"],
                                        power=False)
    elif shape == "square":
        ep = uniform_square_aperture_beam(dircos, freqs,
                                          feedinfo["size"], power=False)
    else:
        raise ValueError("invalid feed shape %r" % shape)
    ep = ep[:, :, None].to(torch.complex64)
    if feedinfo.get("element_locs") is not None:
        # phased-array feed: isotropic-radiator array factor
        ep = ep * array_field_pattern(feedinfo["element_locs"], dircos,
                                      freqs)
    if feedinfo.get("groundplane") is not None and shape != "dish":
        gp = ground_plane_pattern(dircos, freqs,
                                  feedinfo["groundplane"],
                                  modifier=feedinfo.get("ground_modify"),
                                  power=False)
        ep = ep * gp[:, :, None]
    return ep


def feed_illumination_of_aperture(aperture_locs, feedinfo, freqs,
                                  short_dipole=False, half_wave=True):
    """Complex feed illumination of aperture samples.

    aperture_locs: (N, 2|3) sample positions, ENU meters. feedinfo:
    dict with position (3,), shape, size, orientation_dircos,
    element_locs (phased-array feed), groundplane. The feed's field
    pattern is evaluated along the directions from the feed to each
    sample (apertures below the feed are mirrored: the feed only points
    upwards). freqs: (nchan,) tensor (its device is the result's).

    Returns (rel_locs (N, 3) host float64, illumination (N, nchan, nrand)
    complex64)."""
    freqs = _as_f32(freqs, None)
    locs = np.asarray(aperture_locs, dtype=np.float64)
    if locs.shape[1] == 2:
        locs = np.hstack([locs, np.zeros((locs.shape[0], 1))])
    pos = np.asarray((feedinfo or {}).get("position") or (0.0, 0.0, 0.0),
                     dtype=np.float64).reshape(3)
    rel = locs - pos[None, :]
    look = -rel if rel[:, 2].mean() < 0.0 else rel
    r = np.linalg.norm(look, axis=1)
    safe = np.where(r > 0, r, 1.0)
    dirs = look / safe[:, None]
    dirs[r == 0] = (0.0, 0.0, 1.0)          # sample at the feed: zenith
    illum = _feed_sky_field(feedinfo, _as_f32(dirs, freqs.device), freqs,
                            short_dipole=short_dipole, half_wave=half_wave)
    return rel, illum


def feed_aperture_combined_field_pattern(aperture_locs, feedinfo, dircos,
                                         freqs, pointing_dircos=None,
                                         short_dipole=False,
                                         half_wave=True, power=True):
    """Combined feed x aperture pattern: the feed's own sky field pattern
    times the aperture array factor whose per-element complex gains are
    the feed's illumination of the aperture samples. Returns (nsrc,
    nchan) power (default) or (nsrc, nchan, nrand) field."""
    rel, illum = feed_illumination_of_aperture(
        aperture_locs, feedinfo, freqs, short_dipole=short_dipole,
        half_wave=half_wave)
    feed_fp = _feed_sky_field(feedinfo, dircos, freqs,
                              short_dipole=short_dipole,
                              half_wave=half_wave)
    ap = generic_aperture_field_pattern(rel, dircos, freqs,
                                        pointing_dircos=pointing_dircos,
                                        gains=illum, power=False)
    field = ap * feed_fp
    if power:
        return torch.mean(torch.abs(field) ** 2, dim=-1)
    return field
