"""Native-schema FITS simulation products.

Counterpart of prisim_tpu/io/fitsnative.py, writing the same bytes;
`load_fits` strips the blank padding of the label columns, which the
reference's keeps. The
reference's ``InterferometerArray.save(fmt='fits')`` writes one FITS
file per simulation with the full instrument + product state as
IMAGE/BINTABLE extensions (PRISim's prisim/interferometry.py:8490-8720);
``__init__(init_file=...)`` reads it back. This module writes the same
extension layout and names on the port's FITS layer (`io/fitsio.py`),
with the long reference header keywords folded to 8-character FITS keys
(the reference relies on astropy's non-standard HIERARCH convention for
keys like 'freq_resolution'; a standards-conforming writer cannot).

Extensions written (reference name -> here, identical unless noted):

  PRIMARY header      latitude/longitude/altitude/telescope/... ->
                      LATITUDE, LONGITUD, ALTITUDE, TSCOPE, ELSHAPE,
                      ELSIZE, FREQRES, NACC, FLUXUNIT, PNTCOORD,
                      PHCCOORD, BLCOORD
  'baselines', 'proj_baselines', 'Tsys', 't_acc', 'bandpass',
  'bandpass_weights', 'freq_channel_noise_rms_visibility',
  'real/imag_freq_{sky,obs,noise}_visibility',
  'real/imag_lag_{sky,obs-"",noise}_visibility',
  'Effective area', 'Interferometer efficiency'
  BINTABLE 'LABELS' (A1, A2), 'LAYOUT', 'SPECTRAL INFO' (frequency[, lag]),
  'TIMESTAMPS', 'POINTING AND PHASE CENTER INFO'

``load_fits`` restores a ``VisibilitySet`` (the init_file round-trip).
"""

import numpy as np

from .fitsio import card, read_fits, write_bintable, write_image

__all__ = ["save_fits", "load_fits"]


def _cplx(vs, name):
    v = getattr(vs, name)
    return None if v is None else np.asarray(v)


def save_fits(vs, path):
    """Write the native-schema FITS product for a VisibilitySet
    (the reference's save(fmt='fits'), interferometry.py:8393)."""
    tele = vs.telescope or {}
    with open(path, "wb") as fh:
        prim = [
            card("LATITUDE", float(vs.latitude),
                 "Latitude of interferometer"),
            card("LONGITUD", float(vs.longitude),
                 "Longitude of interferometer"),
            card("ALTITUDE", float(vs.altitude),
                 "Altitude of interferometer"),
            card("BLCOORD", "localenu", "Baseline coordinate system"),
            card("FREQRES", float(vs.freq_resolution),
                 "Frequency Resolution (Hz)"),
            card("PNTCOORD", str(vs.pointing_coords),
                 "Pointing coordinate system"),
            card("PHCCOORD", str(vs.phase_center_coords),
                 "Phase center coordinate system"),
            card("NACC", int(vs.n_acc), "Number of accumulations"),
            card("FLUXUNIT", str(vs.flux_unit),
                 "Unit of flux density"),
        ]
        if tele.get("id"):
            prim.append(card("TSCOPE", str(tele["id"]),
                             "Telescope Name"))
        if tele.get("shape"):
            prim.append(card("ELSHAPE", str(tele["shape"]),
                             "Antenna element shape"))
        if tele.get("size") is not None:
            prim.append(card("ELSIZE", float(tele["size"]),
                             "Antenna element size"))
        write_image(fh, data=None, primary=True, extra_cards=prim)

        write_image(fh, np.asarray(vs.baselines, np.float64),
                    extname="baselines")
        if vs.projected_baselines is not None:
            write_image(fh, np.asarray(vs.projected_baselines,
                                       np.float64),
                        extname="proj_baselines")
        labels = np.asarray(vs.labels)
        maxlen = max(1, int(max(len(str(a)) for a in labels.ravel())))
        write_bintable(fh, "LABELS", [
            ("A2", "%dA" % maxlen, [str(a) for a in labels[:, 0]]),
            ("A1", "%dA" % maxlen, [str(a) for a in labels[:, 1]]),
        ])
        if vs.layout:
            lab = [str(x) for x in vs.layout["labels"]]
            lmax = max(1, max(len(s) for s in lab))
            write_bintable(fh, "LAYOUT", [
                ("labels", "%dA" % lmax, lab),
                ("ids", "1J", np.asarray(vs.layout.get(
                    "ids", np.arange(len(lab))), np.int32)),
                ("positions", "3D", np.asarray(vs.layout["positions"],
                                               np.float64)),
            ])
        write_image(fh, np.asarray([float(vs.A_eff)]),
                    extname="Effective area")
        write_image(fh, np.asarray([float(vs.eff_Q)]),
                    extname="Interferometer efficiency")

        spec = [("frequency", "1D", np.asarray(vs.freqs, np.float64))]
        if vs.lags is not None:
            spec.append(("lag", "1D", np.asarray(vs.lags, np.float64)))
        write_bintable(fh, "SPECTRAL INFO", spec)

        if vs.t_acc is not None:
            write_image(fh, np.asarray(vs.t_acc, np.float64),
                        extname="t_acc")
        if vs.timestamps is not None:
            write_bintable(fh, "TIMESTAMPS", [
                ("timestamps", "1D",
                 np.asarray(vs.timestamps, np.float64))])

        pointing = []
        pointing.append(("LST", "1D", np.asarray(vs.lst, np.float64)))
        for nm, arr in (("pointing", vs.pointing_center),
                        ("phase_center", vs.phase_center)):
            if arr is not None:
                a = np.asarray(arr, np.float64)
                pointing.append(("%s_longitude" % nm, "1D", a[:, 0]))
                pointing.append(("%s_latitude" % nm, "1D", a[:, 1]))
        write_bintable(fh, "POINTING AND PHASE CENTER INFO", pointing)

        if vs.Tsys is not None:
            write_image(fh, np.asarray(vs.Tsys, np.float32),
                        extname="Tsys")
        if vs.bp is not None:
            write_image(fh, np.asarray(vs.bp, np.float32),
                        extname="bandpass")
        if vs.bp_wts is not None:
            write_image(fh, np.asarray(vs.bp_wts, np.float32),
                        extname="bandpass_weights")
        if vs.vis_rms is not None:
            write_image(fh, np.asarray(vs.vis_rms, np.float32),
                        extname="freq_channel_noise_rms_visibility")

        for name, ext in (("vis", "freq_obs_visibility"),
                          ("skyvis", "freq_sky_visibility"),
                          ("vis_noise", "freq_noise_visibility")):
            v = _cplx(vs, name)
            if v is not None:
                write_image(fh, np.ascontiguousarray(v.real,
                                                     np.float32),
                            extname="real_" + ext)
                write_image(fh, np.ascontiguousarray(v.imag,
                                                     np.float32),
                            extname="imag_" + ext)
        for name, ext in (("vis_lag", "lag_visibility"),
                          ("skyvis_lag", "lag_sky_visibility"),
                          ("vis_noise_lag", "lag_noise_visibility")):
            v = _cplx(vs, name)
            if v is not None:
                write_image(fh, np.ascontiguousarray(v.real,
                                                     np.float32),
                            extname="real_" + ext)
                write_image(fh, np.ascontiguousarray(v.imag,
                                                     np.float32),
                            extname="imag_" + ext)


def _strings(column):
    """A character column as str, without the blanks that pad each entry
    to the column width (insignificant in FITS; prisim_tpu's load_fits
    keeps them, so a label shorter than the longest reads back padded)."""
    return np.asarray([(s.decode() if isinstance(s, bytes) else str(s))
                       .rstrip() for s in column])


def load_fits(path):
    """Read a save_fits product back into a VisibilitySet
    (the reference's __init__(init_file=...) round-trip,
    interferometry.py:5140)."""
    from ..vis import VisibilitySet
    hdus = read_fits(path)
    prim = hdus[0]["header"]
    ext = {}
    for h in hdus[1:]:
        ext[str(h["header"].get("EXTNAME", "")).strip()] = h

    def img(name):
        h = ext.get(name)
        return None if h is None else np.asarray(h["data"])

    def cplx(stem):
        re, im = img("real_" + stem), img("imag_" + stem)
        return None if re is None else re + 1j * im

    spec = ext["SPECTRAL INFO"]["columns"]
    pnt = ext["POINTING AND PHASE CENTER INFO"]["columns"]
    lab = ext["LABELS"]["columns"]
    labels = np.stack([_strings(lab["A2"]), _strings(lab["A1"])], axis=1)

    def pcols(nm):
        lon = pnt.get("%s_longitude" % nm)
        if lon is None:
            return None
        return np.stack([np.asarray(lon).ravel(),
                         np.asarray(pnt["%s_latitude" % nm]).ravel()],
                        axis=1)

    layout = None
    if "LAYOUT" in ext:
        ld = ext["LAYOUT"]["columns"]
        layout = dict(
            labels=_strings(ld["labels"]),
            ids=np.asarray(ld["ids"]).ravel(),
            positions=np.asarray(ld["positions"], np.float64),
            coords="ENU")
    ts = ext.get("TIMESTAMPS")
    tele = {}
    if "TSCOPE" in prim:
        tele["id"] = str(prim["TSCOPE"]).strip()
    if "ELSHAPE" in prim:
        tele["shape"] = str(prim["ELSHAPE"]).strip()
    if "ELSIZE" in prim:
        tele["size"] = float(prim["ELSIZE"])
    aeff = img("Effective area")
    effq = img("Interferometer efficiency")
    lags = (np.asarray(spec["lag"]).ravel()
            if "lag" in spec else None)
    return VisibilitySet(
        baselines=img("baselines"),
        labels=labels,
        freqs=np.asarray(spec["frequency"]).ravel(),
        lst=np.asarray(pnt["LST"]).ravel(),
        skyvis=cplx("freq_sky_visibility"),
        vis=cplx("freq_obs_visibility"),
        vis_noise=cplx("freq_noise_visibility"),
        vis_rms=img("freq_channel_noise_rms_visibility"),
        timestamps=(None if ts is None else
                    np.asarray(ts["columns"]["timestamps"]).ravel()),
        t_acc=img("t_acc"),
        bp=img("bandpass"), bp_wts=img("bandpass_weights"),
        Tsys=img("Tsys"),
        A_eff=float(aeff[0]) if aeff is not None else 154.0,
        eff_Q=float(effq[0]) if effq is not None else 1.0,
        latitude=float(prim.get("LATITUDE", 0.0)),
        longitude=float(prim.get("LONGITUD", 0.0)),
        altitude=float(prim.get("ALTITUDE", 0.0)),
        pointing_center=pcols("pointing"),
        pointing_coords=str(prim.get("PNTCOORD", "altaz")).strip(),
        phase_center=pcols("phase_center"),
        phase_center_coords=str(prim.get("PHCCOORD", "altaz")).strip(),
        projected_baselines=img("proj_baselines"),
        telescope=tele, layout=layout,
        flux_unit=str(prim.get("FLUXUNIT", "Jy")).strip(),
        lags=lags,
        skyvis_lag=cplx("lag_sky_visibility"),
        vis_lag=cplx("lag_visibility"),
        vis_noise_lag=cplx("lag_noise_visibility"))
