"""Host geometry of the plain reference, in float64 numpy.

Frozen copies of the host conventions a drift-scan simulation is defined
by: the HERA hexagonal layouts, the all-pairs baselines and their
redundancy grouping, the schedule of a drift scan (LST and Julian date of
each accumulation), the sidereal time and IAU 1976 precession, and the
alt-az / hour-angle / direction-cosine ladder of phasing and projection.
The HEALPix RING pixel centres are worked out ring by ring from the
HEALPix geometry (Gorski et al. 2005). Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

C_LIGHT = 299792458.0
K_BOLTZMANN = 1.380649e-23
JANSKY = 1e-26
SIDEREAL_DEG_PER_SEC = 360.0 / 86164.0905
JD_J2000 = 2451545.0
HERA_SPACING_M = 14.6


# -- array ----------------------------------------------------------------

def hera_positions(n_total):
    """(N, 3) ENU positions in metres of the HERA hexagon of n_total
    dishes (n_total = 3 s^2 - 3 s + 1), 14.6 m apart, centred on its mean:
    the centre row of 2 s - 1 dishes, then rows i = 1 .. s - 1 above and
    below it, each 2 s - 1 - i dishes shifted by i / 2, in that order."""
    s = int(round((3 + np.sqrt(9 - 12 * (1 - n_total))) / 6.0))
    if 3 * s * s - 3 * s + 1 != n_total:
        raise ValueError("%d is not a centred hexagonal number" % n_total)
    xs, ys = [], []
    for i in range(1, s):
        x = np.arange(2 * s - 1 - i) + i * 0.5
        y = i * (np.sqrt(3.0) / 2.0)
        xs += [x, x]
        ys += [np.full(x.size, y), np.full(x.size, -y)]
    x0 = np.arange(2 * s - 1, dtype=np.float64)
    xs.append(x0)
    ys.append(np.zeros(x0.size))
    xy = np.stack([np.concatenate(xs), np.concatenate(ys)], axis=-1)
    xy = (xy - xy.mean(axis=0, keepdims=True)) * HERA_SPACING_M
    return np.concatenate([xy, np.zeros((xy.shape[0], 1))], axis=1)


def layout_positions(name):
    """Positions of a named preset; only the HERA hexagons are known."""
    if not name.startswith("HERA-"):
        raise ValueError("the reference knows the HERA-<n> layouts only, "
                         "not %r" % name)
    return hera_positions(int(name.split("-")[1]))


def _redundancy_keys(v):
    """(length, zenith angle, orientation mod 180 deg) quantised to 0.01 m
    and 3.6 arcsec, as strings."""
    bll = np.sqrt(np.sum(v ** 2, axis=1))
    blo = np.degrees(np.arctan2(v[:, 1], v[:, 0]))
    blo = np.where(blo >= 180.0, blo - 180.0, blo)
    blo = np.where(blo < 0.0, blo + 180.0, blo)
    with np.errstate(invalid="ignore"):
        blza = np.degrees(np.arccos(np.clip(
            v[:, 2] / np.where(bll > 0, bll, 1.0), -1, 1)))
    return ["{0:.2f}_{1:.3f}_{2:.3f}".format(a, 3.6e3 * b, 3.6e3 * c)
            for a, b, c in zip(bll, blza, blo)]


def baselines(positions, redundant):
    """(B, 3) baseline vectors pos[j] - pos[i] for j > i in row-major pair
    order; with `redundant`, the first of each redundancy group (b and -b
    share a group), groups in order of first appearance."""
    n = positions.shape[0]
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = jj > ii
    vec = positions[jj[keep]] - positions[ii[keep]]
    if not redundant:
        return vec
    _, first = np.unique(_redundancy_keys(vec), return_index=True)
    return vec[np.sort(first)]


# -- sky ------------------------------------------------------------------

def healpix_ring_radec(nside):
    """(RA, dec) in degrees of the RING-ordered HEALPix pixel centres."""
    npix = 12 * nside * nside
    z = np.empty(npix)
    phi = np.empty(npix)
    p = 0
    for ring in range(1, 4 * nside):
        if ring < nside:                              # north cap
            n_ring, zr = 4 * ring, 1.0 - ring * ring / (3.0 * nside * nside)
            shift = 0.5
        elif ring <= 3 * nside:                       # equatorial belt
            n_ring = 4 * nside
            zr = 4.0 / 3.0 - 2.0 * ring / (3.0 * nside)
            shift = 0.5 if (ring - nside) % 2 == 0 else 0.0
        else:                                         # south cap
            k = 4 * nside - ring
            n_ring, zr = 4 * k, -(1.0 - k * k / (3.0 * nside * nside))
            shift = 0.5
        j = np.arange(n_ring)
        z[p:p + n_ring] = zr
        phi[p:p + n_ring] = (j + shift) * (2.0 * np.pi / n_ring)
        p += n_ring
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    return np.degrees(phi % (2.0 * np.pi)), 90.0 - np.degrees(theta)


def pixel_area(nside):
    return 4.0 * np.pi / (12 * nside * nside)


def precession_matrix(jd_from, jd_to):
    """IAU 1976 (Lieske) precession from mean epoch jd_from to jd_to."""
    T = (jd_from - JD_J2000) / 36525.0
    t = (jd_to - jd_from) / 36525.0
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
    return np.array([
        [cZ * ct * cz - sZ * sz, -cZ * ct * sz - sZ * cz, -cZ * st],
        [sZ * ct * cz + cZ * sz, -sZ * ct * sz + cZ * cz, -sZ * st],
        [st * cz, -st * sz, ct]])


def unit_vectors(ra_deg, dec_deg):
    ra, dec = np.radians(ra_deg), np.radians(dec_deg)
    return np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                     np.sin(dec)], axis=-1)


def precess_radec(ra_deg, dec_deg, jd_from, jd_to):
    """(RA, dec) in degrees precessed from jd_from to jd_to."""
    v = unit_vectors(ra_deg, dec_deg) @ precession_matrix(jd_from, jd_to).T
    return (np.degrees(np.arctan2(v[:, 1], v[:, 0])) % 360.0,
            np.degrees(np.arcsin(np.clip(v[:, 2], -1.0, 1.0))))


def jyear_to_jd(jyear):
    return JD_J2000 + (float(jyear) - 2000.0) * 365.25


# -- time -----------------------------------------------------------------

def julian_date(year, month, day):
    """Julian date of 0h UT on a Gregorian date."""
    a = (14 - month) // 12
    y = year + 4800 - a
    m = month + 12 * a - 3
    jdn = day + (153 * m + 2) // 5 + 365 * y + y // 4 - y // 100 \
        + y // 400 - 32045
    return float(jdn) - 0.5


def lst_deg(jd, longitude_deg):
    """Local mean sidereal time in degrees (GMST by IAU 1982)."""
    t = (jd - JD_J2000) / 36525.0
    gmst = (280.46061837 + 360.98564736629 * (jd - JD_J2000)
            + 0.000387933 * t * t - t * t * t / 38710000.0) % 360.0
    return (gmst + longitude_deg) % 360.0


def drift_schedule(obs_date, lst_init_hours, longitude_deg, n_acc, t_acc):
    """(lst_deg (T,), jd (T,)) of a drift scan: the first instant of
    obs_date ('YYYY/MM/DD', UT) at which the LST is lst_init, then each
    accumulation at its midpoint."""
    lst0 = float(lst_init_hours) * 15.0
    y, m, d = [int(x) for x in obs_date.replace("-", "/").split("/")[:3]]
    jd0 = julian_date(y, m, d)
    jd_init = jd0 + ((lst0 - lst_deg(jd0, longitude_deg)) % 360.0) \
        / 360.98564736629
    mid = np.arange(n_acc) + 0.5
    return ((lst0 + SIDEREAL_DEG_PER_SEC * t_acc * mid) % 360.0,
            jd_init + t_acc * mid / 86400.0)


# -- local frame ----------------------------------------------------------

def altaz_to_dircos(alt_deg, az_deg):
    alt, az = np.radians(alt_deg), np.radians(az_deg)
    return np.stack([np.cos(alt) * np.sin(az), np.cos(alt) * np.cos(az),
                     np.sin(alt) * np.ones_like(az)], axis=-1)


def dircos_to_altaz(dc):
    alt = np.arcsin(np.clip(dc[..., 2], -1.0, 1.0))
    az = np.arctan2(dc[..., 0], dc[..., 1]) % (2.0 * np.pi)
    return np.degrees(alt), np.degrees(az)


def altaz_to_hadec(alt_deg, az_deg, lat_deg):
    alt, az, lat = (np.radians(x) for x in (alt_deg, az_deg, lat_deg))
    dec = np.arcsin(np.clip(np.sin(alt) * np.sin(lat)
                            + np.cos(alt) * np.cos(lat) * np.cos(az),
                            -1.0, 1.0))
    ha = np.arctan2(-np.cos(alt) * np.sin(az),
                    np.sin(alt) * np.cos(lat)
                    - np.cos(alt) * np.sin(lat) * np.cos(az)) % (2 * np.pi)
    ha = np.where(ha > np.pi, ha - 2.0 * np.pi, ha)
    return np.degrees(ha), np.degrees(dec)


def enu_rotation(lst_deg_, lat_deg):
    """(3, 3): equatorial cartesian (X to RA 0, Z to the pole) -> (E, N,
    U) at this LST and latitude."""
    th, ph = np.radians(lst_deg_), np.radians(lat_deg)
    ct, st, cp, sp = np.cos(th), np.sin(th), np.cos(ph), np.sin(ph)
    return np.array([[-st, ct, 0.0],
                     [-sp * ct, -sp * st, cp],
                     [cp * ct, cp * st, sp]])


def enu_to_xyz(enu, lat_deg):
    lat = np.radians(lat_deg)
    e, n, u = enu[..., 0], enu[..., 1], enu[..., 2]
    return np.stack([-n * np.sin(lat) + u * np.cos(lat), e,
                     n * np.cos(lat) + u * np.sin(lat)], axis=-1)


def projected_baselines(bl_enu, center_altaz, lst_deg_, lat_deg):
    """(B, 3, T) uvw of the baselines towards a fixed alt-az centre."""
    T = np.size(lst_deg_)
    dc = np.broadcast_to(altaz_to_dircos(*center_altaz), (T, 3))
    ha, dec = altaz_to_hadec(*dircos_to_altaz(dc), lat_deg)
    ha, dec = np.radians(ha), np.radians(dec)
    xyz = enu_to_xyz(bl_enu, lat_deg)
    z = np.zeros(T)
    rot = np.array([
        [np.sin(ha), np.cos(ha), z],
        [-np.sin(dec) * np.cos(ha), np.sin(dec) * np.sin(ha),
         np.cos(dec) + z],
        [np.cos(dec) * np.cos(ha), -np.cos(dec) * np.sin(ha),
         np.sin(dec) + z]])
    return np.einsum("bj,ijt->bit", xyz, rot)
