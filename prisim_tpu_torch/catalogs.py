"""Survey catalog readers: SUMSS, NVSS, GLEAM, MWACS, DSM/GSM per-pixel
FITS tables and FITS HI cubes.

Counterpart of prisim_tpu/catalogs.py. The text readers (SUMSS, MWACS),
the flux cut and the power-law model builder are copies of its own; the
FITS readers are rewritten on the port's jax-free io.fitsio, with the
same formats and results. The port imports nothing of prisim_tpu. Each
reader returns the port's SkyModel (power-law spectra, extended-source
shapes where cataloged)."""

from __future__ import annotations

import os

import numpy as np

from . import constants as CNST
from . import healpix as hp
from .io import fitsio
from .skymodel import SkyModel

__all__ = ["read_sumss", "read_nvss", "read_gleam", "read_mwacs",
           "read_custom_ascii", "read_dsm_fits", "write_dsm_fits",
           "read_hi_cube_fits", "flux_cut"]


def _powerlaw_model(ra, dec, flux, freq_ref, spindex, src_shape=None,
                    name="catalog"):
    n = np.asarray(ra).size
    return SkyModel(
        location=np.stack([np.asarray(ra, dtype=np.float64),
                           np.asarray(dec, dtype=np.float64)], axis=-1),
        spec_kind="power-law",
        spec_parms={"flux-scale": np.asarray(flux, dtype=np.float64),
                    "freq-ref": np.broadcast_to(
                        np.asarray(freq_ref, dtype=np.float64), (n,)
                    ).copy(),
                    "power-law-index": np.asarray(spindex,
                                                  dtype=np.float64)},
        src_shape=src_shape, name=name)


def _draw_spindex(n, mean=-0.83, rms=0.0, seed=None):
    if rms <= 0:
        return np.full(n, mean)
    rng = np.random.RandomState(seed)
    return mean + rms * rng.randn(n)


def flux_cut(sm, flux_min=None, flux_max=None, cut_freq=None):
    """Flux-density cuts evaluated at cut_freq (Hz) via each source's
    power law (the fluxcut_min/max/fluxcut_reffreq logic,
    run_prisim.py:1129-1210)."""
    p = sm.spec_parms
    flux = np.asarray(p["flux-scale"], dtype=np.float64)
    fref = np.asarray(p["freq-ref"], dtype=np.float64)
    alpha = np.asarray(p["power-law-index"], dtype=np.float64)
    if cut_freq is None:
        s_at = flux
    else:
        s_at = flux * (float(cut_freq) / fref) ** alpha
    keep = np.ones(flux.size, dtype=bool)
    if flux_min is not None:
        keep &= s_at >= float(flux_min)
    if flux_max is not None:
        keep &= s_at <= float(flux_max)
    if not keep.any():
        raise IndexError("no sources satisfy the flux threshold criteria")
    return sm.subset(np.where(keep)[0])


def read_sumss(path, spindex_mean=-0.83, spindex_rms=0.0,
               spindex_seed=None, point_sources_only=True):
    """SUMSS text catalog (sumsscat.*.txt): sexagesimal RA/dec in cols
    0-5, integrated flux (mJy) in col 10, fitted/deconvolved axes in
    cols 12-16; 843 MHz (run_prisim.py:1113-1166)."""
    cat = np.loadtxt(path, usecols=(0, 1, 2, 3, 4, 5, 10, 12, 13, 14,
                                    15, 16))
    cat = np.atleast_2d(cat)
    ra = 15.0 * (cat[:, 0] + cat[:, 1] / 60.0 + cat[:, 2] / 3600.0)
    dec_dd = np.loadtxt(path, usecols=(3,), dtype=str, ndmin=1)
    sgn = np.where(np.char.startswith(dec_dd, "-"), -1.0, 1.0)
    dec = sgn * (np.abs(cat[:, 3]) + cat[:, 4] / 60.0
                 + cat[:, 5] / 3600.0)
    flux = cat[:, 6] * 1e-3                       # mJy -> Jy
    dmaj, dmin = cat[:, 10], cat[:, 11]
    if point_sources_only:
        keep = (dmaj == 0.0) & (dmin == 0.0)
        ra, dec, flux = ra[keep], dec[keep], flux[keep]
    spindex = _draw_spindex(flux.size, spindex_mean, spindex_rms,
                            spindex_seed)
    return _powerlaw_model(ra, dec, flux, 0.843e9, spindex, name="SUMSS")


def read_mwacs(path, spindex_mean=-0.83, spindex_rms=0.0,
               spindex_seed=None):
    """MWACS csv catalog (mwacs_b1_131016.csv): comma/pipe-separated
    columns with RA/dec (deg) and S_180 flux (run_prisim.py MWACS
    branch). Accepts 'ra,dec,flux[,spindex]' ordering."""
    rows = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#") or ln[0].isalpha():
                continue
            parts = ln.replace("|", ",").split(",")
            try:
                rows.append([float(x) if x.strip() else np.nan
                             for x in parts[:4]])
            except ValueError:
                continue
    data = np.asarray([r + [np.nan] * (4 - len(r)) for r in rows])
    ra, dec, flux = data[:, 0], data[:, 1], data[:, 2]
    spindex = np.where(np.isfinite(data[:, 3]), data[:, 3],
                       _draw_spindex(ra.size, spindex_mean, spindex_rms,
                                     spindex_seed))
    return _powerlaw_model(ra, dec, flux, 180e6, spindex, name="MWACS")


def read_custom_ascii(path, freq_ref=150e6, spindex_default=-0.83):
    """Custom ascii catalog: RA DEC FLUX [SPINDEX] [MAJ MIN PA]
    (the driver's 'custom' model; run_prisim.py custom branch)."""
    data = np.atleast_2d(np.genfromtxt(path, comments="#"))
    ra, dec, flux = data[:, 0], data[:, 1], data[:, 2]
    spindex = data[:, 3] if data.shape[1] > 3 else \
        np.full(ra.size, spindex_default)
    shape = data[:, 4:7] if data.shape[1] >= 7 else None
    return _powerlaw_model(ra, dec, flux, freq_ref, spindex,
                           src_shape=shape, name="custom")


def _fits_table_columns(path):
    for hdu in fitsio.read_fits(path):
        if "columns" in hdu:
            return hdu["columns"]
    raise ValueError("no binary table found in %s" % path)


def read_nvss(path, spindex_mean=-0.83, spindex_rms=0.0,
              spindex_seed=None, exclude_sumss_sky=False):
    """NVSS FITS catalog: columns RA(2000), DEC(2000), PEAK INT (Jy/beam),
    MAJOR AX, MINOR AX (deg); 1.4 GHz (PRISim's run_prisim.py NVSS
    branch). exclude_sumss_sky keeps dec > -30 only (the csm merge)."""
    cols = _fits_table_columns(path)
    ra = np.asarray(cols["RA(2000)"], dtype=np.float64)
    dec = np.asarray(cols["DEC(2000)"], dtype=np.float64)
    flux = np.asarray(cols["PEAK INT"], dtype=np.float64)
    majax = np.asarray(cols["MAJOR AX"], dtype=np.float64)
    minax = np.asarray(cols["MINOR AX"], dtype=np.float64)
    if exclude_sumss_sky:
        keep = dec > -30.0
        ra, dec, flux = ra[keep], dec[keep], flux[keep]
        majax, minax = majax[keep], minax[keep]
    spindex = _draw_spindex(flux.size, spindex_mean, spindex_rms,
                            spindex_seed)
    shape = np.stack([majax, minax, np.zeros_like(majax)], axis=-1)
    return _powerlaw_model(ra, dec, flux, 1.4e9, spindex,
                           src_shape=shape, name="NVSS")


def read_gleam(path, select_freq=150e6):
    """GLEAM FITS catalog: RAJ2000/DEJ2000, per-subband int_flux_XXX
    columns (the one nearest select_freq is the reference flux),
    a_wide/b_wide/pa_wide semi-axes (arcsec), fitted alpha."""
    cols = _fits_table_columns(path)
    ra = np.asarray(cols["RAJ2000"], dtype=np.float64)
    dec = np.asarray(cols["DEJ2000"], dtype=np.float64)
    flux_cols = sorted(
        c for c in cols
        if c.startswith("int_flux_") and "err" not in c
        and "fit" not in c and "wide" not in c)
    if flux_cols:
        freqs_mhz = np.asarray([float(c.split("_")[-1])
                                for c in flux_cols])
        i = int(np.argmin(np.abs(freqs_mhz * 1e6 - select_freq)))
        flux = np.asarray(cols[flux_cols[i]], dtype=np.float64)
        fref = freqs_mhz[i] * 1e6
    else:
        flux = np.asarray(cols["int_flux_wide"], dtype=np.float64)
        fref = 200e6
    alpha = (np.asarray(cols["alpha"], dtype=np.float64)
             if "alpha" in cols else np.full(ra.size, -0.83))
    alpha = np.where(np.isfinite(alpha), alpha, -0.83)
    shape = None
    if "a_wide" in cols:
        pa = cols["pa_wide"] if "pa_wide" in cols else np.zeros(ra.size)
        shape = np.stack([2 * np.asarray(cols["a_wide"], np.float64) / 3600.0,
                          2 * np.asarray(cols["b_wide"], np.float64) / 3600.0,
                          np.asarray(pa, np.float64)], axis=-1)
    return _powerlaw_model(ra, dec, flux, fref, alpha, src_shape=shape,
                           name="GLEAM")


def read_dsm_fits(path, nside=None, map_freq=150e6):
    """Diffuse sky model (DSM/GSM) per-pixel FITS catalog.

    A header carries PIXAREA (pixel solid angle, sr); a binary table has
    columns RA, DEC (degrees), T_<MHz> pixel temperatures (K) at map_freq
    and spindex (the temperature spectral index). Pixel flux S = T 2 k_B
    (nu/c)^2 pixarea / Jy; the flux spectral index is spindex + 2.
    `path` may be the full filename or the reference's file prefix,
    expanded to '<prefix>_<MHz:.1f>_MHz_nside_<nside>.fits'. Every pixel
    carries the pixel-resolution shape majax = minax = sqrt(pixarea).
    Returns a power-law SkyModel in Jy."""
    if not os.path.exists(path):
        if nside is None:
            raise ValueError("nside required to expand a DSM file prefix")
        path = "%s_%.1f_MHz_nside_%d.fits" % (path, map_freq / 1e6,
                                              int(nside))
    hdus = fitsio.read_fits(path)
    pixarea = next((float(h["header"]["PIXAREA"]) for h in hdus
                    if "PIXAREA" in h["header"]), None)
    cols = next((h["columns"] for h in hdus if "columns" in h), None)
    if cols is None:
        raise ValueError("no binary table in %s" % path)
    ra = np.asarray(cols["RA"], dtype=np.float64)
    dec = np.asarray(cols["DEC"], dtype=np.float64)
    tname = "T_%.0f" % (map_freq / 1e6)
    if tname not in cols:
        cand = [k for k in cols if k.startswith("T_")]
        if not cand:
            raise ValueError("no temperature column (T_<MHz>) in %s"
                             % path)
        tname = cand[0]
        map_freq = float(tname[2:]) * 1e6
    temp = np.asarray(cols[tname], dtype=np.float64)
    if pixarea is None:
        pixarea = hp.nside2pixarea(hp.npix2nside(ra.size))
    flux = temp * 2.0 * CNST.k_B * (map_freq / CNST.c) ** 2 \
        * pixarea / CNST.Jy
    spindex = np.asarray(cols["spindex"] if "spindex" in cols
                         else np.full(ra.size, -2.55),
                         dtype=np.float64) + 2.0
    resol = np.degrees(np.sqrt(pixarea))
    shape = np.stack([np.full(ra.size, resol), np.full(ra.size, resol),
                      np.zeros(ra.size)], axis=-1)
    return _powerlaw_model(ra, dec, flux, np.full(ra.size, map_freq),
                           spindex, src_shape=shape, name="DSM")


def write_dsm_fits(path, temp, spindex, map_freq=150e6):
    """Write a full-sky HEALPix map (RING order) as the per-pixel DSM FITS
    table read_dsm_fits reads: PIXAREA in the primary header, then RA,
    DEC (pixel centers, degrees), T_<MHz> (temp, K at map_freq) and
    spindex (the temperature spectral index)."""
    temp = np.asarray(temp, dtype=np.float64)
    nside = hp.npix2nside(temp.size)
    theta, phi = hp.pix2ang(nside, np.arange(temp.size))
    with open(path, "wb") as fh:
        fh.write(fitsio.format_header([
            fitsio.card("SIMPLE", True), fitsio.card("BITPIX", 8),
            fitsio.card("NAXIS", 0), fitsio.card("EXTEND", True),
            fitsio.card("PIXAREA", hp.nside2pixarea(nside))]))
        fitsio.write_bintable(fh, "DSM", [
            ("RA", "1D", np.degrees(phi)),
            ("DEC", "1D", 90.0 - np.degrees(theta)),
            ("T_%.0f" % (map_freq / 1e6), "1D", temp),
            ("spindex", "1D", np.broadcast_to(
                np.asarray(spindex, dtype=np.float64), temp.shape))])


def read_hi_cube_fits(path, center_freq, fluctuations=False):
    """HI lightcone / EoR simulation cube from FITS.

    Format per the reference's use_HI_cube/use_HI_fluctuations branch
    (PRISim's scripts/run_prisim.py:1020-1065): primary header has
    NEXTEN, FITSTYPE and PIXAREA; FITSTYPE='IMAGE' carries a FREQUENCY
    bintable (column 'Frequency [MHz]') plus a TEMPERATURE image
    (npix, nf) and a COORDINATE bintable (RA, DEC); other FITSTYPEs store
    one bintable per frequency with a 'Temperature' column and
    '<MHz> ...' EXTNAMEs. Temperatures (K) convert to pixel fluxes with
    the center-frequency Rayleigh-Jeans factor (run_prisim.py:1053, which
    uses the single band-center freq). fluctuations=True subtracts the
    per-channel mean map (use_HI_fluctuations, run_prisim.py:1046-1047).

    Returns a tabulated-spectrum SkyModel (Jy); frequency interpolation
    onto the simulated channels happens in SkyModel.generate_spectrum."""
    hdus = fitsio.read_fits(path)
    hdr0 = hdus[0]["header"]
    pixarea = float(hdr0["PIXAREA"])
    fitstype = str(hdr0.get("FITSTYPE", "IMAGE")).strip()
    by_name = {str(h["header"].get("EXTNAME", "")).strip(): h
               for h in hdus[1:]}
    coords = by_name["COORDINATE"]["columns"]
    ra = np.asarray(coords["RA"], dtype=np.float64)
    dec = np.asarray(coords["DEC"], dtype=np.float64)
    if fitstype.upper() == "IMAGE":
        fcols = by_name["FREQUENCY"]["columns"]
        fkey = [k for k in fcols if k.lower().startswith("freq")][0]
        freqs_mhz = np.asarray(fcols[fkey], dtype=np.float64)
        temp = np.asarray(by_name["TEMPERATURE"]["data"],
                          dtype=np.float64)
        if temp.shape[0] == freqs_mhz.size and \
                temp.shape[-1] != freqs_mhz.size:
            temp = temp.T                          # (npix, nf)
    else:
        items = []
        for name, h in by_name.items():
            if "columns" in h and "Temperature" in h["columns"]:
                try:
                    fmhz = float(name.split(" ")[0])
                except ValueError:
                    continue
                items.append((fmhz, np.asarray(h["columns"]["Temperature"],
                                               dtype=np.float64)))
        items.sort(key=lambda t: t[0])
        freqs_mhz = np.asarray([t[0] for t in items])
        temp = np.stack([t[1] for t in items], axis=1)
    if fluctuations:
        temp = temp - temp.mean(axis=0, keepdims=True)
    flux = temp * (2.0 * CNST.k_B * float(center_freq) ** 2
                   / CNST.c ** 2) * pixarea / CNST.Jy
    return SkyModel(location=np.stack([ra, dec], axis=-1),
                    spec_kind="spectrum", spectrum=flux,
                    freqs_model=freqs_mhz * 1e6,
                    name="HI_fluctuations" if fluctuations else "HI_cube")
