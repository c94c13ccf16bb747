"""UVFITS export and import of a VisibilitySet (pure numpy).

Counterpart of prisim_tpu/io/uvfits.py, writing the same bytes apart
from the HISTORY card, which names this package. The conventions are
the reference's PRISim->UVData adapter (PRISim's
prisim/interferometry.py:9259-9618):
* visibilities are written CONJUGATED
* blt ordering is time-major: (Ntimes outer, Nbls inner)
* baseline numbers use the 2048 convention:
  2048*(ant2+1) + (ant1+1) + 65536
* uvw from projected_baselines (meters; written in seconds, the UVFITS
  convention)
* one spectral window; one polarization (XX, AIPS code -5, or YY, -6),
  or two or four with the second-feed and cross-polarization products
* antenna positions: ECEF minus telescope ECEF

Layout: random-groups primary HDU with group parameters UU, VV, WW (s),
DATE + DATE (two-part JD), BASELINE, and per-group data
(1, 1, Nfreq, Npol, 3) = (RA, DEC, FREQ, STOKES, COMPLEX[re, im, wt]);
followed by an AIPS AN binary table."""

from __future__ import annotations

import numpy as np

from .. import constants as CNST
from .. import geometry as geom
from . import fitsio as F

__all__ = ["save_uvfits", "load_uvfits", "uvdata_arrays",
           "antnums_to_blnum", "blnum_to_antnums"]


def antnums_to_blnum(i, j, attempt256=False):
    """Baseline number from 0-indexed antenna numbers (i=ant1, j=ant2)."""
    i = np.int64(i)
    j = np.int64(j)
    if attempt256 and np.max(i) < 255 and np.max(j) < 255:
        return 256 * (j + 1) + (i + 1)
    return np.int64(2048 * (j + 1) + (i + 1) + 2 ** 16)


def blnum_to_antnums(blnum):
    blnum = np.asarray(blnum, dtype=np.int64)
    if np.min(blnum) > 2 ** 16:
        i = (blnum - 2 ** 16) % 2048 - 1
        j = (blnum - 2 ** 16 - (i + 1)) // 2048 - 1
    else:
        i = blnum % 256 - 1
        j = (blnum - (i + 1)) // 256 - 1
    return np.int32(i), np.int32(j)


def _ant_ids(vs):
    """Map baseline labels (A2, A1) to integer antenna ids via layout."""
    labels = np.asarray(vs.labels, dtype=str)
    if vs.layout is not None:
        lut = {str(l): int(i) for l, i in zip(
            np.asarray(vs.layout["labels"], dtype=str),
            np.asarray(vs.layout["ids"]))}
        id_a2 = np.asarray([lut[s] for s in labels[:, 0]])
        id_a1 = np.asarray([lut[s] for s in labels[:, 1]])
    else:
        id_a2 = labels[:, 0].astype(int)
        id_a1 = labels[:, 1].astype(int)
    return id_a1, id_a2


def _phase_center_radec_deg(vs):
    """Per-snapshot phase center in RA/dec degrees (the reference's
    ladder, PRISim's prisim/interferometry.py:9442-9466)."""
    from ..vis import to_dircos
    if vs.phase_center is None:
        pc = np.tile([[90.0, 270.0]], (vs.n_acc, 1))
        coords = "altaz"
    else:
        pc = np.atleast_2d(np.asarray(vs.phase_center, dtype=np.float64))
        coords = vs.phase_center_coords
    if coords == "radec":
        return np.broadcast_to(pc[:, :2], (vs.n_acc, 2)).copy()
    dc = to_dircos(pc, coords, vs.lst, vs.latitude)
    altaz = geom.dircos2altaz(dc, xp=np)
    hadec = geom.altaz2hadec(altaz, vs.latitude, xp=np)
    ra = np.asarray(vs.lst).ravel() - hadec[:, 0]
    return np.stack([ra % 360.0, hadec[:, 1]], axis=-1)


def uvdata_arrays(vs, datatype="noiseless"):
    """Flatten a VisibilitySet into UVData-style blt arrays (the
    InterferometerData.infodict equivalent)."""
    cube = {"noiseless": vs.skyvis, "noisy": vs.vis,
            "noise": vs.vis_noise}[datatype]
    if cube is None:
        raise ValueError("datatype '%s' not present in VisibilitySet"
                         % datatype)
    nbl, nchan, nacc = cube.shape
    nblts = nbl * nacc
    # (nbl, nchan, nacc) -> (nacc, nbl, nchan), conjugated
    data = np.transpose(np.conj(np.asarray(cube)), (2, 0, 1)).reshape(
        nblts, nchan)
    if vs.projected_baselines is None:
        from ..vis import project_baselines
        vs = project_baselines(vs)
    uvw = np.transpose(np.asarray(vs.projected_baselines),
                       (2, 0, 1)).reshape(nblts, 3)
    jd = (np.asarray(vs.timestamps, dtype=np.float64)
          if vs.timestamps is not None
          else 2451545.0 + np.arange(nacc) / 86400.0)
    time_array = np.repeat(jd, nbl)
    lst_array = np.repeat(np.radians(np.asarray(vs.lst).ravel()), nbl)
    id_a1, id_a2 = _ant_ids(vs)
    ant_1_array = np.tile(id_a1, nacc)
    ant_2_array = np.tile(id_a2, nacc)
    baseline_array = antnums_to_blnum(ant_1_array, ant_2_array)
    t_acc = (np.asarray(vs.t_acc)[0] if vs.t_acc is not None else 1.0)
    radec = _phase_center_radec_deg(vs)
    center = radec[vs.n_acc // 2]
    is_phased = bool(np.allclose(radec[:, 0], radec[::-1, 0]) and
                     np.allclose(radec[:, 1], radec[::-1, 1]))
    return dict(
        data=data, uvw=uvw, time_array=time_array, lst_array=lst_array,
        ant_1_array=ant_1_array, ant_2_array=ant_2_array,
        baseline_array=baseline_array, integration_time=t_acc,
        freqs=np.asarray(vs.freqs, dtype=np.float64),
        phase_center_radec_deg=center, is_phased=is_phased,
        nbl=nbl, nchan=nchan, nacc=nacc, nblts=nblts)


def pol_cubes(vs, datatype, vs_second=None, pols=None, four_pol=False,
              vs_cross=None):
    """The uvdata_arrays of `vs`, the time-major (Nblts, Nfreq) data cube of
    each polarization, the AIPS codes along the polarization axis and
    whether the cross-polarizations were simulated; the polarization
    logic shared by save_uvfits and save_uvh5 (see save_uvfits)."""
    a = uvdata_arrays(vs, datatype)
    cubes = [a["data"]]
    if vs_second is not None:
        a2 = uvdata_arrays(vs_second, datatype)
        if a2["data"].shape != a["data"].shape:
            raise ValueError("second-pol VisibilitySet shape mismatch")
        cubes.append(a2["data"])
    cross_simulated = False
    if four_pol:
        if vs_second is None:
            raise ValueError("four_pol requires vs_second (the Y feed)")
        if vs_cross is not None:
            vs_xy, vs_yx = (vs_cross if isinstance(vs_cross,
                                                   (tuple, list))
                            else (vs_cross, vs_cross))
            for v in (vs_xy, vs_yx):
                ax = uvdata_arrays(v, datatype)
                if ax["data"].shape != a["data"].shape:
                    raise ValueError("cross-pol VisibilitySet shape "
                                     "mismatch")
                cubes.append(ax["data"])
            cross_simulated = True
        else:
            zero = np.zeros_like(cubes[0])
            cubes += [zero, zero]
        if pols is None:
            pols = (-5, -6, -7, -8)
    if pols is None:
        pols = (-5, -6)[:len(cubes)]
    if len(pols) != len(cubes):
        raise ValueError("pols must match the number of pol cubes")
    return a, cubes, pols, cross_simulated


def save_uvfits(vs, path, datatype="noiseless", vs_second=None,
                pols=None, four_pol=False, vs_cross=None):
    """Write a VisibilitySet as a UVFITS file.

    vs_second: optional second-polarization VisibilitySet (same
    layout/axes) -> NAXIS3=2 STOKES axis. pols: AIPS codes along the
    STOKES axis, contiguous descending per the UVFITS convention
    (default (-5,) = XX, or (-5, -6) = XX, YY with vs_second).
    four_pol: with vs_second, write the standard 4-pol linear STOKES
    axis (-5..-8 = XX, YY, XY, YX); without vs_cross the cross-pols
    are explicit zeros, weight-flagged. vs_cross: the simulated XY
    product (a VisibilitySet, or an (XY, YX) pair) from a
    beam.pol='full' Mueller run: cross-pols are then real data,
    unflagged."""
    a, cubes, pols, cross_simulated = pol_cubes(
        vs, datatype, vs_second, pols, four_pol, vs_cross)
    npol = len(cubes)
    nblts, nchan = a["nblts"], a["nchan"]
    freqs = a["freqs"]
    f0 = freqs[0]
    df = freqs[1] - freqs[0] if freqs.size > 1 else 1.0
    ra_deg, dec_deg = a["phase_center_radec_deg"]

    # group parameters: UU, VV, WW (seconds), DATE, DATE, BASELINE
    jd = a["time_array"]
    jd1 = np.floor(jd - 0.5) + 0.5          # integer-ish part
    jd2 = jd - jd1                           # fraction of day
    pzero4 = float(np.floor(jd1[0]))
    pars = np.stack([
        a["uvw"][:, 0] / CNST.c,
        a["uvw"][:, 1] / CNST.c,
        a["uvw"][:, 2] / CNST.c,
        jd1 - pzero4,
        jd2,
        a["baseline_array"].astype(np.float64),
    ], axis=-1)

    # data: (nblts, DEC=1, RA=1, FREQ, STOKES=npol, COMPLEX=3)
    data = np.zeros((nblts, 1, 1, nchan, npol, 3), dtype=np.float32)
    for p, cube in enumerate(cubes):
        data[..., p, 0] = cube.real.reshape(nblts, 1, 1, nchan)
        data[..., p, 1] = cube.imag.reshape(nblts, 1, 1, nchan)
    # UVFITS weight convention: >0 good, <=0 flagged. Flags are channels
    # where bandpass x weights vanish
    if vs.bp is not None or vs.bp_wts is not None:
        bp, wts = vs.default_bp()
        good = (np.asarray(bp) * np.asarray(wts)) != 0
        data[..., 2] = np.where(
            np.transpose(good, (2, 0, 1)).reshape(nblts, 1, 1, nchan, 1),
            np.float32(1.0), np.float32(-1.0))
    else:
        data[..., 2] = 1.0
    if four_pol and not cross_simulated:
        # unsimulated cross-pols: zero data, negative weight (flagged)
        data[..., 2:, 2] = -np.abs(data[..., 2:, 2])

    object_name = vs.telescope.get("id", "custom")
    cards = [
        F.card("SIMPLE", True), F.card("BITPIX", -32),
        F.card("NAXIS", 7),
        F.card("NAXIS1", 0), F.card("NAXIS2", 3),
        F.card("NAXIS3", npol),
        F.card("NAXIS4", nchan), F.card("NAXIS5", 1), F.card("NAXIS6", 1),
        F.card("NAXIS7", 1),
        F.card("EXTEND", True), F.card("GROUPS", True),
        F.card("PCOUNT", 6), F.card("GCOUNT", nblts),
        F.card("BSCALE", 1.0), F.card("BZERO", 0.0),
        F.card("OBJECT", str(object_name)),
        F.card("TELESCOP", str(object_name)),
        F.card("INSTRUME", str(object_name)),
        F.card("EPOCH", 2000.0),
        F.card("OBSRA", float(ra_deg)), F.card("OBSDEC", float(dec_deg)),
        F.card("CTYPE2", "COMPLEX"), F.card("CRVAL2", 1.0),
        F.card("CRPIX2", 1.0), F.card("CDELT2", 1.0),
        F.card("CTYPE3", "STOKES"), F.card("CRVAL3", float(pols[0])),
        F.card("CRPIX3", 1.0), F.card("CDELT3", -1.0),
        F.card("CTYPE4", "FREQ"), F.card("CRVAL4", float(f0)),
        F.card("CRPIX4", 1.0), F.card("CDELT4", float(df)),
        F.card("CTYPE5", "RA"), F.card("CRVAL5", float(ra_deg)),
        F.card("CRPIX5", 1.0), F.card("CDELT5", 1.0),
        F.card("CTYPE6", "DEC"), F.card("CRVAL6", float(dec_deg)),
        F.card("CRPIX6", 1.0), F.card("CDELT6", 1.0),
        F.card("CTYPE7", "IF"), F.card("CRVAL7", 1.0),
        F.card("CRPIX7", 1.0), F.card("CDELT7", 1.0),
        F.card("PTYPE1", "UU"), F.card("PSCAL1", 1.0),
        F.card("PZERO1", 0.0),
        F.card("PTYPE2", "VV"), F.card("PSCAL2", 1.0),
        F.card("PZERO2", 0.0),
        F.card("PTYPE3", "WW"), F.card("PSCAL3", 1.0),
        F.card("PZERO3", 0.0),
        F.card("PTYPE4", "DATE"), F.card("PSCAL4", 1.0),
        F.card("PZERO4", pzero4),
        F.card("PTYPE5", "DATE"), F.card("PSCAL5", 1.0),
        F.card("PZERO5", 0.0),
        F.card("PTYPE6", "BASELINE"), F.card("PSCAL6", 1.0),
        F.card("PZERO6", 0.0),
        F.card("INTTIM", float(a["integration_time"])),
        F.card("HISTORY", "prisim_tpu_torch"),
    ]
    with open(path, "wb") as fh:
        F.write_random_groups(fh, pars, data, cards)
        _write_aipsan_table(fh, vs)


def _antennas(vs):
    """Antenna names, numbers and ECEF positions relative to the telescope
    (the UVData antenna convention), from the layout or the labels."""
    if vs.layout is not None:
        names = np.asarray(vs.layout["labels"], dtype=str)
        nums = np.asarray(vs.layout["ids"])
        pos_enu = np.asarray(vs.layout["positions"], dtype=np.float64)
    else:
        names = np.unique(np.asarray(vs.labels, dtype=str).ravel())
        nums = np.arange(names.size)
        pos_enu = np.zeros((names.size, 3))
    tel_ecef = geom.lla2ecef(vs.latitude, vs.longitude, vs.altitude)
    pos_ecef = geom.enu2ecef(pos_enu, vs.latitude, vs.longitude,
                             vs.altitude) - tel_ecef
    return names, nums, pos_ecef, tel_ecef


def _write_aipsan_table(fh, vs):
    """AIPS AN antenna table extension."""
    names, nums, pos_ecef, tel_ecef = _antennas(vs)
    nums = nums.astype(int)
    n = names.size
    columns = [
        ("ANNAME", "8A", [s[:8] for s in names]),
        ("STABXYZ", "3D", pos_ecef),
        ("NOSTA", "1J", nums + 1),
        ("MNTSTA", "1J", np.zeros(n, dtype=int)),
        ("STAXOF", "1E", np.zeros(n)),
        ("POLTYA", "1A", ["X"] * n),
        ("POLAA", "1E", np.zeros(n)),
        ("POLCALA", "1E", np.zeros(n)),
        ("POLTYB", "1A", ["Y"] * n),
        ("POLAB", "1E", np.full(n, 90.0)),
        ("POLCALB", "1E", np.zeros(n)),
    ]
    extra = [
        F.card("ARRAYX", float(tel_ecef[0])),
        F.card("ARRAYY", float(tel_ecef[1])),
        F.card("ARRAYZ", float(tel_ecef[2])),
        F.card("FRAME", "ITRF"),
        F.card("GSTIA0", 0.0), F.card("DEGPDY", 360.985),
        F.card("FREQ", float(np.asarray(vs.freqs)[0])),
        F.card("RDATE", "2000-01-01"),
        F.card("TIMSYS", "UTC"), F.card("ARRNAM",
                                        str(vs.telescope.get("id",
                                                             "custom"))),
        F.card("NUMORB", 0), F.card("NOPCAL", 0), F.card("POLTYPE", ""),
    ]
    F.write_bintable(fh, "AIPS AN", columns, extra)


def ecef_to_enu_rotation(lat_deg, lon_deg):
    """The rotation that takes telescope-relative ECEF vectors to local
    ENU at (lat, lon): enu = ecef @ R.T."""
    lon_r, lat_r = np.radians(lon_deg), np.radians(lat_deg)
    return np.asarray([
        [-np.sin(lon_r), np.cos(lon_r), 0.0],
        [-np.sin(lat_r) * np.cos(lon_r), -np.sin(lat_r) * np.sin(lon_r),
         np.cos(lat_r)],
        [np.cos(lat_r) * np.cos(lon_r), np.cos(lat_r) * np.sin(lon_r),
         np.sin(lat_r)]])


def load_uvfits(path):
    """Read a UVFITS file (as written by save_uvfits) back into a
    VisibilitySet: random groups + AIPS AN table, the inverse of the
    reference's pyuvdata read path. skyvis holds the first polarization.

    Assumes time-major blt ordering with a constant baseline set."""
    from ..ephemeris import lst_deg
    from ..vis import VisibilitySet
    hdus = F.read_fits(path)
    gh = next(h for h in hdus if "pars" in h)
    an = next((h for h in hdus if "columns" in h
               and str(h["header"].get("EXTNAME", "")).startswith(
                   "AIPS AN")), None)
    hdr = gh["header"]
    pars = gh["pars"]
    nblts = hdr["GCOUNT"]
    nchan = hdr["NAXIS4"]
    npol = int(hdr.get("NAXIS3", 1))
    f0 = float(hdr["CRVAL4"])
    df = float(hdr["CDELT4"])
    freqs = f0 + df * np.arange(nchan)
    # first polarization only (XX by convention; multi-pol files carry
    # the STOKES axis between FREQ and COMPLEX)
    data = gh["data"].reshape(nblts, nchan, npol, 3)[:, :, 0, :]
    vis_tm = (data[..., 0] + 1j * data[..., 1])
    blnum = pars[:, 5].astype(np.int64)
    jd = hdr["PZERO4"] + pars[:, 3] + pars[:, 4]
    i1, i2 = blnum_to_antnums(blnum)
    nbl = np.unique(blnum[np.isclose(jd, jd[0])]).size
    ntimes = nblts // nbl
    vis = np.conj(vis_tm.reshape(ntimes, nbl, nchan).transpose(1, 2, 0))
    ant1 = i1[:nbl]
    ant2 = i2[:nbl]
    labels = np.stack([ant2.astype(str), ant1.astype(str)], axis=-1)
    uvw = pars[:nbl, 0:3] * CNST.c                    # s -> m
    layout = None
    lat = 0.0
    if an is not None:
        cols = an["columns"]
        # ECEF-relative station positions; latitude from ARRAYZ/ARRAYX
        ax = float(an["header"].get("ARRAYX", 0.0))
        ay = float(an["header"].get("ARRAYY", 0.0))
        az = float(an["header"].get("ARRAYZ", 0.0))
        lat = np.degrees(np.arctan2(
            az, np.hypot(ax, ay) * (1.0 - 1.0 / 298.257223563) ** 2)) \
            if (ax or ay or az) else 0.0
        lon = np.degrees(np.arctan2(ay, ax)) if (ax or ay) else 0.0
        names = np.char.decode(cols["ANNAME"].astype("S"))
        names = np.char.strip(names)
        nums = np.asarray(cols["NOSTA"], dtype=int) - 1
        enu = np.asarray(cols["STABXYZ"]) @ ecef_to_enu_rotation(lat, lon).T
        layout = dict(positions=enu, labels=names, ids=nums,
                      coords="ENU")
    # baselines from layout when available, else first-time uvw proxy
    if layout is not None:
        lut = {int(n): i for i, n in enumerate(layout["ids"])}
        bl = np.stack([layout["positions"][lut[int(a2)]]
                       - layout["positions"][lut[int(a1)]]
                       for a1, a2 in zip(ant1, ant2)])
    else:
        bl = uvw
    jd_t = jd.reshape(ntimes, nbl)[:, 0]
    # LST unknown in UVFITS; approximate from GMST of JD + longitude
    lst = lst_deg(jd_t, lon if an is not None else 0.0)
    return VisibilitySet(
        baselines=bl, labels=labels, freqs=freqs, lst=np.atleast_1d(lst),
        skyvis=vis, timestamps=jd_t,
        t_acc=np.full(ntimes, float(hdr.get("INTTIM", 1.0))),
        latitude=lat, longitude=lon if an is not None else 0.0,
        telescope={"id": str(hdr.get("TELESCOP", "custom")).strip()},
        layout=layout)
