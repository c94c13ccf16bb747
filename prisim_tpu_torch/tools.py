"""Post-simulation tooling: the analysis entry points of the reference's
scripts/ CLI surface.

Counterpart of part of prisim_tpu/tools.py: ``delay_ps`` (delay power
spectra with optional delay CLEAN), ``closure_npz`` (closure phases to the
HERA NPZ layout) and ``xcpdps`` (closure-phase delay cross power spectra),
with the reader they share, ``_load_any``. The other subcommands and the
CLI are not ported yet (ROADMAP queue 1, item 18).

``delay_ps`` runs its delay transforms, beam and CLEAN on an explicit
device ('cuda' raises without a card). ``delay_ps`` and ``xcpdps`` write
their products with io.dicth5 (h5py); with outfile=None they write
nothing and return the product dict, and a path given where h5py is
missing raises ImportError before any compute.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["delay_ps", "closure_npz", "xcpdps"]


def _load_any(path):
    """Load a sim from native HDF5, UVH5, the native FITS product, or an
    NPZ (a chunked run's part file, else an NPZ export) (the reference's
    replicate accepts both its HDF5 and pyuvdata-readable UVFITS,
    replicatesim_util.py:39-59)."""
    path = str(path)
    if path.endswith((".uvh5", ".uvhdf5")):
        from .io.uvh5 import load_uvh5
        return load_uvh5(path)
    if path.endswith(".fits") and not path.endswith(".uvfits"):
        from .io import load_fits
        return load_fits(path)
    if path.endswith(".npz"):
        from .io import load_npz
        from .io.parts import is_part_npz, load_part_npz
        return load_part_npz(path) if is_part_npz(path) else load_npz(path)
    from .io import load_hdf5
    return load_hdf5(path)


def _writable(outfile):
    """Raise ImportError, before any compute, when `outfile` is a path
    and h5py (which io.dicth5 writes with) is missing."""
    if outfile is not None:
        from .io.hdf5 import h5py
        if h5py is None:
            raise ImportError("writing %s needs h5py; pass outfile=None to "
                              "get the product dict only" % outfile)


def delay_ps(infile, outfile, pad=1.0, nside_beam=32, clean=False,
             gain=0.1, maxiter=200, threshold=5e-3,
             subband_centers=None, subband_bw=None, shape="bhw",
             device="cuda", timings=None):
    """Delay-transform a sim, optionally delay-CLEAN it, and return (and,
    with an `outfile` path, write to HDF5) the cosmological delay power
    spectrum products (the DelaySpectrum -> DelayPowerSpectrum pipeline,
    PRISim's prisim/delay_spectrum.py:493/:3260). The transforms, the beam
    and CLEAN run on `device`. With subband_centers/subband_bw (Hz) the
    windowed subband transform and per-subband power spectra (:1842/:4003)
    go under 'subband'. `timings`, a dict, receives the seconds of each
    phase (load, delay transform, beam volume, CLEAN, power spectrum,
    subbands, save)."""
    from .analysis.clean import delay_clean_vs
    from .analysis.power_spectrum import beam3Dvol, delay_power_spectrum
    from .beams.dispatch import primary_beam
    from .diagnostics import phase_timer
    from .driver import resolve_device
    from . import healpix as hp_
    from .vis import delay_transform
    dev = resolve_device(device)
    _writable(outfile)

    def phase(name):
        return phase_timer(name, sink=timings, verbose=False)

    with phase("load"):
        vs = _load_any(infile)
    with phase("delay transform"):
        vst = delay_transform(vs, pad=pad, device=dev)
    with phase("beam volume"):
        # beam volume from the stored telescope description on a HEALPix
        # grid; the band is picked from the first channel, as the driver
        # picks it
        npix = hp_.nside2npix(nside_beam)
        theta, phi = hp_.pix2ang(nside_beam, np.arange(npix))
        up = theta <= np.pi / 2
        dc = np.stack([np.sin(theta) * np.cos(phi),
                       np.sin(theta) * np.sin(phi),
                       np.cos(theta)], axis=-1)
        tel = dict(vs.telescope or {"id": "hera"})
        pb = np.zeros((npix, vs.nchan))
        f32 = np.asarray(vs.freqs, np.float32)    # native order (FITS)
        pb[up] = primary_beam(
            torch.as_tensor(dc[up], dtype=torch.float32, device=dev),
            torch.as_tensor(f32, device=dev), tel,
            band_freq=float(vs.freqs[0])).cpu().numpy()
        omega_bw = beam3Dvol(pb, np.asarray(vs.freqs), hemisphere=True)
    with phase("power spectrum"):
        dps = delay_power_spectrum(vst, omega_bw=omega_bw)
    if clean:
        with phase("CLEAN"):
            cl = delay_clean_vs(vs, pad=pad, gain=gain, maxiter=maxiter,
                                threshold=threshold, device=dev)
            for k in ("cc_skyvis_lag", "res_skyvis_lag"):
                if k in cl:
                    dps[k.replace("_lag", "_ps")] = \
                        np.abs(cl[k]) ** 2 * dps["factor"]
    dps["omega_bw"] = omega_bw
    if subband_centers is not None:
        from .analysis.delay import subband_delay_transform
        from .analysis.power_spectrum import subband_power_spectra
        with phase("subbands"):
            if subband_bw is None:
                subband_bw = [0.25 * vs.freq_resolution * vs.nchan]
            sbds = subband_delay_transform(vs, subband_centers, subband_bw,
                                           shape=shape, pad=pad, device=dev)
            sbps = subband_power_spectra(vs, sbds, pb,
                                         pixarea_sr=hp_.nside2pixarea(
                                             nside_beam))
            dps["subband"] = sbps
    if outfile is not None:
        from .io.dicth5 import save_dict_hdf5
        with phase("save"):
            save_dict_hdf5(dps, outfile)
    return dps


def closure_npz(infile, outfile, datatype="vis", unique=True):
    """Export closure phases of a sim to the HERA NPZ layout
    (write_PRISim_bispectrum_phase_to_npz.py +
    scriptUtils/write_PRISim_bispectrum_phase_to_npz_util.py). The sim is
    read by _load_any, so a native FITS product serves on a machine
    without h5py."""
    from .analysis.bispectrum import closure_npz_from_vs
    vs = _load_any(infile)
    cpd = closure_npz_from_vs(vs, path=outfile, datatype=datatype)
    return cpd


def xcpdps(infile, outfile, freq_center=None, bw_eff=None, pad=1.0,
           shape="bhw", fftpow=1.0, lstbinsize=None, ndaybins=2,
           num_kbins=None, kbintype="log", seed=0, errinfo=False,
           rescale_vis=None, rescale_triad=None, cohax=None,
           incohax=None, collapse_axes=None, avgcov=False,
           lst_shifts=None):
    """Closure-phase delay cross power spectrum from a HERA-layout NPZ:
    the reference's ClosurePhase -> smooth_in_tbins ->
    subsample_differencing -> ClosurePhaseDelaySpectrum.FT ->
    compute_power_spectrum -> save chain
    (PRISim's prisim/bispectrum_phase.py:1497/1727/2023/2349/2888/471) as
    one command; with outfile=None nothing is written. With a single
    observed day (e.g. a sim NPZ from closure_npz) the cross spectrum
    degenerates to the auto spectrum of the day mean."""
    from .analysis.bispectrum import (load_closure_npz, cpds_ft,
                                      cross_power_spectrum, kbin_average,
                                      save_xcpdps)
    _writable(outfile)
    cpd = load_closure_npz(infile)
    if lstbinsize:
        cpd = cpd.smooth_in_tbins(lstbinsize=lstbinsize)
    freqs = np.asarray(cpd.freqs, dtype=np.float64)
    df = freqs[1] - freqs[0] if freqs.size > 1 else 1.0
    bw = freqs.size * df
    if freq_center is None:
        freq_center = [float(freqs[freqs.size // 2])]
    if bw_eff is None:
        bw_eff = [0.5 * bw] * len(np.atleast_1d(freq_center))
    freq_center = np.atleast_1d(np.asarray(freq_center, np.float64))
    bw_eff = np.broadcast_to(
        np.atleast_1d(np.asarray(bw_eff, np.float64)), freq_center.shape)
    if cohax is not None or incohax is not None:
        # full cohax/incohax covariance machinery over the
        # (lst, day, triad)-resolved delay spectra (the reference's
        # compute_power_spectrum, bispectrum_phase.py:2888-3604); axis
        # ids 1=lst, 2=days, 3=triads
        from .analysis.bispectrum import xcpdps_full
        if cpd.days.size >= 2 and 2 <= ndaybins <= cpd.days.size:
            sub = cpd.subsample_differencing(ndaybins=ndaybins,
                                             seed=seed)
            eic = np.moveaxis(sub["eicp_mean"], 0, 1)  # (nlst,nb,ntr,nc)
            wts = np.moveaxis((sub["wts_mean"] > 0).astype(float), 0, 1)
        else:
            eic = cpd.eicp
            wts = (cpd.wts > 0).astype(float)
        ftf = cpds_ft(eic, wts, freqs, freq_center, bw_eff, shape=shape,
                      fftpow=fftpow, pad=pad)
        ps = xcpdps_full(
            ftf,
            cohax=tuple(cohax or ()), incohax=tuple(incohax or ()),
            collapse_axes=tuple(collapse_axes or ()), avgcov=avgcov,
            lst_shifts=None if lst_shifts is None
            else np.asarray(lst_shifts, int))
        ps["mode"] = "xcpdps_full"
        ps["triads"] = np.asarray(cpd.triads, dtype="U")
        ps["lst"] = cpd.lst
        ps["diagoffsets"] = {str(k): np.asarray(v)
                             for k, v in ps["diagoffsets"].items()}
        ps["diagweights"] = {str(k): np.asarray(v)
                             for k, v in ps["diagweights"].items()}
        ps["axesmap"] = {str(k): np.asarray(v)
                         for k, v in ps["axesmap"].items()}
        if outfile is not None:
            save_xcpdps(ps, outfile)
        return ps
    if cpd.days.size >= 2 and 2 <= ndaybins <= cpd.days.size:
        sub = cpd.subsample_differencing(ndaybins=ndaybins, seed=seed)
        e1, e2 = sub["eicp_mean"][0], sub["eicp_mean"][1]
        w1 = (sub["wts_mean"][0] > 0).astype(float)
        w2 = (sub["wts_mean"][1] > 0).astype(float)
        mode = "cross"
    else:
        if cpd.days.size >= 2:
            print("[prisim_tpu_torch] ndaybins=%d outside [2, ndays=%d]; "
                  "falling back to auto spectrum of the day mean"
                  % (ndaybins, cpd.days.size))
        wsum = cpd.wts.sum(axis=1)
        esum = (cpd.eicp * cpd.wts).sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            e1 = e2 = np.where(wsum > 0, esum / np.maximum(wsum, 1e-30),
                               0.0)
        w1 = w2 = (wsum > 0).astype(float)
        mode = "auto"
    ft1 = cpds_ft(e1, w1, freqs, freq_center, bw_eff, shape=shape,
                  fftpow=fftpow, pad=pad)
    ft2 = (ft1 if e2 is e1 else
           cpds_ft(e2, w2, freqs, freq_center, bw_eff, shape=shape,
                   fftpow=fftpow, pad=pad))
    ps = cross_power_spectrum(ft1, ft2)
    ps["mode"] = mode
    ps["triads"] = np.asarray(cpd.triads, dtype="U")
    ps["lst"] = cpd.lst
    if num_kbins:
        kb = kbin_average(ps["kprll"], np.abs(ps["P"]),
                          num_kbins=num_kbins, kbintype=kbintype)
        ps.update({"kbin_edges": kb["kbin_edges"],
                   "kbin_centers": kb["kbin_centers"],
                   "P_kbin": kb["P_kbin"]})
    if errinfo and cpd.days.size >= 2:
        from .analysis.bispectrum import power_spectrum_uncertainty
        nb = min(max(ndaybins, 2), cpd.days.size)
        err = power_spectrum_uncertainty(cpd, freq_center, bw_eff,
                                         shape=shape, fftpow=fftpow,
                                         pad=pad, ndaybins=nb, seed=seed)
        ps["errinfo"] = err
    if rescale_vis is not None:
        from .analysis.bispectrum import rescale_power_spectrum
        from .analysis.closure import triad_baseline_indices
        sim = _load_any(rescale_vis)
        if rescale_triad is None:
            rescale_triad = list(np.asarray(cpd.triads, dtype=str)[0])
        kwargs = {}
        if sim.layout is not None:
            kwargs = dict(baselines=np.asarray(sim.baselines),
                          ant_positions=np.asarray(
                              sim.layout["positions"]),
                          ant_labels=np.asarray(sim.layout["labels"],
                                                dtype=str))
        idx, cj = triad_baseline_indices(np.asarray(sim.labels, str),
                                         [rescale_triad], **kwargs)
        cube = np.asarray(sim.vis if sim.vis is not None else sim.skyvis)
        v3 = cube[idx[0]]                        # (3, nchan, nacc)
        v3 = np.where(cj[0][:, None, None], np.conj(v3), v3)
        vis_triad = np.transpose(v3, (2, 0, 1))  # (nacc, 3, nchan)
        ps = rescale_power_spectrum(ps, ft1["freq_wts"], vis_triad,
                                    np.asarray(sim.lst).ravel() / 15.0)
    if outfile is not None:
        save_xcpdps(ps, outfile)
    return ps
