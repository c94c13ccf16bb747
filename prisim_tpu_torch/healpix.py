"""Minimal vectorized HEALPix implementation (healpy replacement).

The port's own copy of prisim_tpu/healpix.py (numpy and scipy only): the
port imports nothing of the JAX package.

The reference relies on healpy for diffuse sky maps, beam integration and
external-beam interpolation (e.g. beam3Dvol at
PRISim's prisim/delay_spectrum.py:395-463, HEALPix beam interpolation
at PRISim's scripts/run_prisim.py:1897-1908). healpy is not in this
image, so the RING/NESTED pixelizations are implemented here directly from
the HEALPix geometry (Gorski et al. 2005). All functions are host-side
float64 numpy; device code consumes only precomputed pixel centers / gather
indices / interpolation weights, keeping the jit graph pure.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "nside2npix", "npix2nside", "nside2pixarea", "nside2resol",
    "pix2ang", "ang2pix",
    "pix2vec", "ring2nest", "nest2ring", "get_interp_weights",
    "interp_map", "ud_grade",
]


def nside2npix(nside):
    return 12 * nside * nside


def npix2nside(npix):
    nside = int(np.round(np.sqrt(npix / 12)))
    if 12 * nside * nside != npix:
        raise ValueError(f"{npix} is not a valid HEALPix map size")
    return nside


def nside2pixarea(nside, degrees=False):
    area = 4.0 * np.pi / nside2npix(nside)
    if degrees:
        area *= (180.0 / np.pi) ** 2
    return area


def nside2resol(nside, arcmin=False):
    """Approximate pixel resolution: sqrt(pixel area) in radians
    (healpy convention)."""
    res = np.sqrt(nside2pixarea(nside))
    if arcmin:
        res = np.degrees(res) * 60.0
    return res


def pix2ang(nside, ipix, nest=False):
    """Pixel index -> (theta, phi) in radians (colatitude, longitude)."""
    ipix = np.asarray(ipix, dtype=np.int64)
    if nest:
        ipix = nest2ring(nside, ipix)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)

    z = np.empty(ipix.shape, dtype=np.float64)
    phi = np.empty(ipix.shape, dtype=np.float64)

    # North polar cap.
    north = ipix < ncap
    if np.any(north):
        p = ipix[north]
        ph = (p + 1) / 2.0
        i = (np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(np.int64) + 1
        j = p + 1 - 2 * i * (i - 1)
        z[north] = 1.0 - (i * i) / (3.0 * nside * nside)
        phi[north] = (j - 0.5) * np.pi / (2.0 * i)

    # Equatorial belt.
    eq = (ipix >= ncap) & (ipix < npix - ncap)
    if np.any(eq):
        p = ipix[eq] - ncap
        i = p // (4 * nside) + nside
        j = p % (4 * nside) + 1
        s = ((i - nside + 1) % 2).astype(np.float64)  # 1 = shifted ring
        z[eq] = 4.0 / 3.0 - 2.0 * i / (3.0 * nside)
        phi[eq] = (j - 1.0 + s / 2.0) * np.pi / (2.0 * nside)

    # South polar cap.
    south = ipix >= npix - ncap
    if np.any(south):
        p = npix - 1 - ipix[south]
        ph = (p + 1) / 2.0
        i = (np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(np.int64) + 1
        j = p + 1 - 2 * i * (i - 1)
        z[south] = -(1.0 - (i * i) / (3.0 * nside * nside))
        phi[south] = (4.0 * i - j + 0.5) * np.pi / (2.0 * i)

    theta = np.arccos(np.clip(z, -1.0, 1.0))
    phi = phi % (2.0 * np.pi)
    return theta, phi


def ang2pix(nside, theta, phi, nest=False):
    """(theta, phi) in radians -> RING (or NESTED) pixel index."""
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = (phi % (2.0 * np.pi)) / (0.5 * np.pi)  # in [0, 4)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)

    pix = np.empty(np.broadcast(z, tt).shape, dtype=np.int64)
    z, tt = np.broadcast_arrays(z, tt)

    eq = za <= 2.0 / 3.0
    if np.any(eq):
        t1 = nside * (0.5 + tt[eq])
        t2 = nside * (z[eq] * 0.75)
        jp = np.floor(t1 - t2).astype(np.int64)  # ascending edge index
        jm = np.floor(t1 + t2).astype(np.int64)  # descending edge index
        ir = nside + 1 + jp - jm  # ring number counted from z=2/3, in {1..2n+1}
        kshift = 1 - (ir & 1)
        ip = (jp + jm - nside + kshift + 1) // 2
        ip = ip % (4 * nside)
        pix[eq] = ncap + (ir - 1) * 4 * nside + ip

    pol = ~eq
    if np.any(pol):
        tp = tt[pol] - np.floor(tt[pol])
        tmp = nside * np.sqrt(3.0 * (1.0 - za[pol]))
        jp = np.floor(tp * tmp).astype(np.int64)
        jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
        ir = jp + jm + 1  # ring number from the pole
        ip = np.floor(tt[pol] * ir).astype(np.int64)
        ip = ip % (4 * ir)
        p_north = 2 * ir * (ir - 1) + ip
        p_south = npix - 2 * ir * (ir + 1) + ip
        pix[pol] = np.where(z[pol] > 0, p_north, p_south)

    if nest:
        pix = ring2nest(nside, pix)
    return pix


def pix2vec(nside, ipix, nest=False):
    """Pixel index -> unit vectors (N, 3)."""
    theta, phi = pix2ang(nside, ipix, nest=nest)
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)],
                    axis=-1)


# ----------------------------------------------------------------------------
# NESTED scheme via (face, x, y)
# ----------------------------------------------------------------------------

_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def _spread_bits(v):
    """Interleave zeros between bits of v (v up to 2^29)."""
    v = v.astype(np.uint64)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def _compress_bits(v):
    """Inverse of _spread_bits (keep even bits)."""
    v = v.astype(np.uint64) & np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v


def _xyf2nest(nside, x, y, f):
    return (f.astype(np.int64) * nside * nside
            + (_spread_bits(x) | (_spread_bits(y) << np.uint64(1))).astype(np.int64))


def _nest2xyf(nside, ipix):
    npface = nside * nside
    f = ipix // npface
    p = (ipix % npface).astype(np.uint64)
    x = _compress_bits(p).astype(np.int64)
    y = _compress_bits(p >> np.uint64(1)).astype(np.int64)
    return x, y, f


def _isqrt(v):
    r = np.sqrt(v.astype(np.float64)).astype(np.int64)
    r = np.where(r * r > v, r - 1, r)
    r = np.where((r + 1) * (r + 1) <= v, r + 1, r)
    return r


def _ring2xyf(nside, ipix):
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    ipix = np.asarray(ipix, dtype=np.int64)

    iring = np.empty_like(ipix)
    iphi = np.empty_like(ipix)   # 1-based within ring
    kshift = np.empty_like(ipix)
    nr = np.empty_like(ipix)
    face = np.empty_like(ipix)

    north = ipix < ncap
    eq = (ipix >= ncap) & (ipix < npix - ncap)
    south = ipix >= npix - ncap

    if np.any(north):
        p = ipix[north]
        ir = (1 + _isqrt(1 + 2 * p)) >> 1
        iring[north] = ir
        iphi[north] = (p + 1) - 2 * ir * (ir - 1)
        kshift[north] = 0
        nr[north] = ir
        face[north] = (iphi[north] - 1) // ir

    if np.any(eq):
        p = ipix[eq] - ncap
        ir = p // (4 * nside) + nside
        ip = p % (4 * nside) + 1
        iring[eq] = ir
        iphi[eq] = ip
        kshift[eq] = (ir + nside) & 1
        nr[eq] = nside
        ire = ir - nside + 1
        irm = 2 * nside + 2 - ire
        ifm = (ip - ire // 2 + nside - 1) // nside
        ifp = (ip - irm // 2 + nside - 1) // nside
        fc = np.where(ifp == ifm, ifp | 4,
                      np.where(ifp < ifm, ifp, ifm + 8))
        face[eq] = fc

    if np.any(south):
        p = npix - ipix[south]
        ir = (1 + _isqrt(2 * p - 1)) >> 1
        iring[south] = 4 * nside - ir
        iphi[south] = 4 * ir + 1 - (p - 2 * ir * (ir - 1))
        kshift[south] = 0
        nr[south] = ir
        face[south] = 8 + (iphi[south] - 1) // ir

    irt = iring - _JRLL[face] * nside + 1
    ipt = 2 * iphi - _JPLL[face] * nr - kshift - 1
    ipt = np.where(ipt >= 2 * nside, ipt - 8 * nside, ipt)
    x = (ipt - irt) >> 1
    y = (-ipt - irt) >> 1
    return x.astype(np.uint64), y.astype(np.uint64), face


def _xyf2ring(nside, x, y, f):
    x = x.astype(np.int64)
    y = y.astype(np.int64)
    f = f.astype(np.int64)
    jr = _JRLL[f] * nside - x - y - 1

    nr = np.empty_like(jr)
    n_before = np.empty_like(jr)
    kshift = np.empty_like(jr)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)

    north = jr < nside
    south = jr > 3 * nside
    eq = ~north & ~south

    nr[north] = jr[north]
    n_before[north] = 2 * nr[north] * (nr[north] - 1)
    kshift[north] = 0

    nr[eq] = nside
    n_before[eq] = ncap + (jr[eq] - nside) * 4 * nside
    kshift[eq] = (jr[eq] - nside) & 1

    nr[south] = 4 * nside - jr[south]
    n_before[south] = npix - 2 * (nr[south] + 1) * nr[south]
    kshift[south] = 0

    jp = (_JPLL[f] * nr + x - y + 1 + kshift) // 2
    jp = np.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = np.where(jp < 1, jp + 4 * nr, jp)
    return n_before + jp - 1


def ring2nest(nside, ipix):
    x, y, f = _ring2xyf(nside, np.asarray(ipix, dtype=np.int64))
    return _xyf2nest(nside, x, y, f)


def nest2ring(nside, ipix):
    x, y, f = _nest2xyf(nside, np.asarray(ipix, dtype=np.int64))
    return _xyf2ring(nside, x, y, f)


# ----------------------------------------------------------------------------
# Ring metadata + bilinear interpolation (healpy.get_interp_weights analog)
# ----------------------------------------------------------------------------

def _ring_info(nside, iring):
    """For ring index 1..4nside-1: (start pixel, ring length, z, phi shift)."""
    iring = np.asarray(iring, dtype=np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    north = iring < nside
    south = iring > 3 * nside
    eq = ~north & ~south

    length = np.where(north, 4 * iring,
                      np.where(south, 4 * (4 * nside - iring), 4 * nside))
    start = np.where(
        north, 2 * iring * (iring - 1),
        np.where(eq, ncap + (iring - nside) * 4 * nside,
                 npix - 2 * (4 * nside - iring) * (4 * nside - iring + 1)))
    z = np.where(
        north, 1.0 - (iring * iring) / (3.0 * nside * nside),
        np.where(eq, 4.0 / 3.0 - 2.0 * iring / (3.0 * nside),
                 -1.0 + ((4 * nside - iring) ** 2) / (3.0 * nside * nside)))
    # phi of first pixel center in ring
    shifted = north | south | (((iring - nside) & 1) == 0)
    shift = np.where(shifted, 0.5, 0.0)
    return start, length, z, shift


def get_interp_weights(nside, theta, phi):
    """Bilinear interpolation: 4 neighbor RING pixels + weights.

    Returns (pix[4, N], wgt[4, N]) like healpy.get_interp_weights.
    """
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    z = np.cos(theta)
    nring = 4 * nside - 1

    all_r = np.arange(1, nring + 1)
    _, _, zr, _ = _ring_info(nside, all_r)  # descending z

    # Bracket z between rings ir1 (above, smaller index) and ir2 = ir1+1.
    ir2 = np.searchsorted(-zr, -z)  # first ring with z_ring <= z
    ir1 = ir2
    ir2 = ir2 + 1
    # At the poles clamp into valid range; weight handling below covers it.
    ir1 = np.clip(ir1, 0, nring)     # 0 means "above first ring" (north pole)
    ir2 = np.clip(ir2, 1, nring + 1)  # nring+1 means south pole

    pix = np.zeros((4, z.size), dtype=np.int64)
    wgt = np.zeros((4, z.size), dtype=np.float64)

    def ring_pair(iring, ph):
        start, length, _, shift = _ring_info(nside, iring)
        dphi = 2.0 * np.pi / length
        tmp = ph / dphi - shift
        i1 = np.floor(tmp).astype(np.int64)
        w2 = tmp - i1
        i2 = (i1 + 1) % length
        i1 = i1 % length
        return start + i1, start + i2, 1.0 - w2, w2

    inside1 = (ir1 >= 1)
    inside2 = (ir2 <= nring)

    # Upper ring contribution.
    r1 = np.where(inside1, ir1, 1)
    p1a, p1b, w1a, w1b = ring_pair(r1, phi)
    # Lower ring contribution.
    r2 = np.where(inside2, ir2, nring)
    p2a, p2b, w2a, w2b = ring_pair(r2, phi)

    z1 = _ring_info(nside, r1)[2]
    z2 = _ring_info(nside, r2)[2]
    with np.errstate(invalid="ignore", divide="ignore"):
        wz = np.where(z1 != z2, (z1 - z) / (z1 - z2), 0.0)
    wz = np.clip(np.where(inside1 & inside2, wz,
                          np.where(inside1, 0.0, 1.0)), 0.0, 1.0)

    pix[0], pix[1] = p1a, p1b
    pix[2], pix[3] = p2a, p2b
    wgt[0], wgt[1] = w1a * (1 - wz), w1b * (1 - wz)
    wgt[2], wgt[3] = w2a * wz, w2b * wz
    return pix, wgt


def interp_map(m, theta, phi, nest=False):
    """Bilinear interpolation of map values at (theta, phi)."""
    m = np.asarray(m)
    nside = npix2nside(m.shape[0])
    pix, wgt = get_interp_weights(nside, theta, phi)
    if nest:
        pix = ring2nest(nside, pix)
    return np.einsum("kn,kn...->n...", wgt, m[pix])


def ud_grade(m, nside_out, nest=False):
    """Up/downgrade a map by averaging (down) or replication (up).

    Operates in NESTED ordering internally like healpy.ud_grade.
    """
    m = np.asarray(m, dtype=np.float64)
    nside_in = npix2nside(m.shape[0])
    if not nest:
        m = m[nest2ring(nside_in, np.arange(nside2npix(nside_in)))]
    if nside_out < nside_in:
        ratio = (nside_in // nside_out) ** 2
        out = m.reshape(nside2npix(nside_out), ratio, *m.shape[1:]).mean(axis=1)
    elif nside_out > nside_in:
        ratio = (nside_out // nside_in) ** 2
        out = np.repeat(m, ratio, axis=0)
    else:
        out = m
    if not nest:
        out = out[ring2nest(nside_out, np.arange(nside2npix(nside_out)))]
    return out
