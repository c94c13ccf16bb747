"""Host-side time/ephemeris utilities (astropy replacement).

The port's own copy of prisim_tpu/ephemeris.py (numpy and scipy only): the
port imports nothing of the JAX package.

The reference leans on astropy for Time/LST/FK5 precession
(PRISim's scripts/run_prisim.py:660-736,
PRISim's prisim/interferometry.py:6174-6180). astropy is not part of
this image, and TPU-side code must be pure anyway, so all ephemeris runs on
the host in float64 numpy and only the resulting angles/rotations feed jit.

Accuracy notes: GMST uses the IAU 1982 expression (sub-arcsecond over
decades); precession uses the IAU 1976 (Lieske) zeta/z/theta polynomials.
Both comfortably exceed the fidelity of a primary-beam-weighted simulation.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "julian_date", "gmst_deg", "lst_deg", "precession_matrix",
    "precess_radec", "jyear_to_jd",
]

JD_J2000 = 2451545.0
DAYS_PER_CENTURY = 36525.0


def julian_date(year, month, day, hour=0.0, minute=0.0, second=0.0):
    """Gregorian calendar date (UT) -> Julian Date (float64)."""
    year = np.asarray(year, dtype=np.int64)
    month = np.asarray(month, dtype=np.int64)
    a = (14 - month) // 12
    y = year + 4800 - a
    m = month + 12 * a - 3
    jdn = (np.asarray(day, dtype=np.int64) + (153 * m + 2) // 5 + 365 * y
           + y // 4 - y // 100 + y // 400 - 32045)
    frac = (np.asarray(hour, dtype=np.float64) - 12.0) / 24.0 \
        + np.asarray(minute, dtype=np.float64) / 1440.0 \
        + np.asarray(second, dtype=np.float64) / 86400.0
    return jdn.astype(np.float64) + frac


def jyear_to_jd(jyear):
    """Julian epoch (e.g. 2000.0 for J2000) -> Julian Date."""
    return JD_J2000 + (np.asarray(jyear, dtype=np.float64) - 2000.0) * 365.25


def gmst_deg(jd_ut1):
    """Greenwich Mean Sidereal Time in degrees (IAU 1982)."""
    jd_ut1 = np.asarray(jd_ut1, dtype=np.float64)
    t = (jd_ut1 - JD_J2000) / DAYS_PER_CENTURY
    gmst = (280.46061837
            + 360.98564736629 * (jd_ut1 - JD_J2000)
            + 0.000387933 * t * t
            - t * t * t / 38710000.0)
    return gmst % 360.0


def lst_deg(jd_ut1, longitude_deg):
    """Local (mean) sidereal time in degrees at given east longitude."""
    return (gmst_deg(jd_ut1) + np.asarray(longitude_deg, dtype=np.float64)) % 360.0


def precession_matrix(jd_from, jd_to):
    """IAU 1976 precession rotation matrix taking mean equatorial
    coordinates of epoch jd_from to mean coordinates of epoch jd_to."""
    T = (jd_from - JD_J2000) / DAYS_PER_CENTURY
    t = (jd_to - jd_from) / DAYS_PER_CENTURY
    arcsec = np.pi / 180.0 / 3600.0
    zeta = ((2306.2181 + 1.39656 * T - 0.000139 * T * T) * t
            + (0.30188 - 0.000344 * T) * t * t + 0.017998 * t ** 3) * arcsec
    z = ((2306.2181 + 1.39656 * T - 0.000139 * T * T) * t
         + (1.09468 + 0.000066 * T) * t * t + 0.018203 * t ** 3) * arcsec
    theta = ((2004.3109 - 0.85330 * T - 0.000217 * T * T) * t
             - (0.42665 + 0.000217 * T) * t * t - 0.041833 * t ** 3) * arcsec

    cz, sz = np.cos(zeta), np.sin(zeta)
    cZ, sZ = np.cos(z), np.sin(z)
    ct, st = np.cos(theta), np.sin(theta)
    # R = Rz(-z) Ry(theta) Rz(-zeta)
    return np.array([
        [cZ * ct * cz - sZ * sz, -cZ * ct * sz - sZ * cz, -cZ * st],
        [sZ * ct * cz + cZ * sz, -sZ * ct * sz + cZ * cz, -sZ * st],
        [st * cz, -st * sz, ct],
    ])


def _radec_to_cart(ra_deg, dec_deg):
    ra = np.radians(np.asarray(ra_deg, dtype=np.float64))
    dec = np.radians(np.asarray(dec_deg, dtype=np.float64))
    return np.stack([np.cos(dec) * np.cos(ra),
                     np.cos(dec) * np.sin(ra),
                     np.sin(dec)], axis=-1)


def _cart_to_radec(v):
    ra = np.degrees(np.arctan2(v[..., 1], v[..., 0])) % 360.0
    dec = np.degrees(np.arcsin(np.clip(v[..., 2], -1.0, 1.0)))
    return ra, dec


def precess_radec(ra_deg, dec_deg, jd_from, jd_to):
    """Precess (RA, dec) in degrees from mean epoch jd_from to jd_to.

    Replaces the FK5 equinox transform applied to catalog positions per
    snapshot in the reference (PRISim's prisim/interferometry.py:6174).
    """
    R = precession_matrix(jd_from, jd_to)
    v = _radec_to_cart(ra_deg, dec_deg) @ R.T
    return _cart_to_radec(v)
