"""Simulation driver: parameters -> drift scan on one device or a device
mesh -> products.

Counterpart of prisim_tpu/driver.py:

  load_parms -> layout (+ perturbations) -> baselines -> frequency grid
  -> observation schedule (drift|track|file) -> sky model (+ precession,
  roi_radius) -> beam -> drift scan -> Tsys/noise -> gains -> phasing ->
  projection -> optional delay transform -> products (HDF5, NPZ, native
  FITS, UVFITS, UVH5, figures) + metadata.

The drift scan runs one of two engines (processing.engine): the direct
NUDFT (kernel K1a on a CUDA card, its plain version on the CPU) or the
delay-space NUFFT, behind a gate against the direct engine that demotes
the run to the direct engine when it fails. The NUFFT's spread is
processing.nufft_spread: banded (kernel K2; 'auto' is banded) or sorted
(kernel delay_spread; 'scatter' is the same route), each with its plain
version on the CPU. 'auto' picks the banded engine on a card and the
direct engine on the CPU. Gradient runs (processing.gradient_mode,
kernel K1b) and skies with source shapes (extended sources, kernel K1c:
the catalog and DSM FITS skies, a 7-column custom catalog) always run the
direct engine, as the reference does.

Beams: every telescope id and element shape of beams/dispatch.py, a
phased array (antenna.phased_array, the phasedarray section) steered per
accumulation through both engines, and external HEALPix beams
(beam.use_external with a FITS file, or HDF5 where h5py imports), which
always run the direct engine without gradients. processing.n_sky_sectors
> 1 runs one simulation per azimuthal sky sector (a per-snapshot
amplitude mask) and returns their list. beam.pol: XY (or dual) runs the X
and Y feeds as two simulations, beam.pol: full the XX, YY and XY Mueller
weights of crossed dipoles (beams/jones.py) as three, each through the
same engines (the XY weight is sign-indefinite), and writes the combined
2-pol and 4-pol UVFITS (and UVH5, where save_formats.uvh5 asks for it).

run_simulation_chunked splits a run along channels or accumulations
(pp.n_chunks, pp.key) into part files (simdata/_part_<i>.npz, skipped when
present: resume), merges them and writes the products. diagnosis.
jax_profile writes a torch.profiler trace around the run,
diagnosis.resource_monitor samples CPU, RSS and device memory to JSONL.

Multi-device runs (prisim_tpu/driver.py:1214-1345, :1567-1597): with more
than one device (device="cuda" is every visible card; `devices` lists them
explicitly, and may repeat one) and pp.key not 'none', a plain direct run
takes the bl/chan/src mesh of parallel/mesh.py, shaped by pp.key or
pp.mesh_axes, and the banded engine a 'bl' mesh behind its own gate; the
sorted spread takes pp.key's mesh as the direct engine does.

The device is explicit: run_simulation(..., device="cuda") raises when no
card is present and never carries on on the CPU.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import os
import time

import numpy as np
import torch

from . import __version__
from . import healpix as hp
from . import tracing
from .baselines import baseline_generator, build_baselines, uniq_baselines
from .gains import GainInfo, apply_gains
from .layouts import ArrayLayout, parse_layout_file, preset_layout
from .skymodel import (SkyModel, healpix_diffuse_model,
                       random_point_source_model, tanh_eor_spectrum,
                       temperature_to_jy_per_pixel)
from . import catalogs as CATS
from . import geometry as geom
from . import windows as win
from .beams.analytic import airy_beam_df, airy_df_available, \
    mwa_tile_positions
from .beams.dispatch import airy_dish, primary_beam
from .beams.external import ExternalBeam
from .beams.jones import mueller_unpol_weights
from .config import dump_parms, load_parms
from .engine import cuda_finalize
from .engine.noise import generate_noise, thermal_noise_rms
from .engine.nufft_banded import PlanRejected, make_banded_plan, \
    make_banded_snapshot_fns, powerlaw_node_fluxes
from .engine.nufft_delay import chebyshev_node_model, \
    chebyshev_projection, simulate_snapshot_nufft_jit
from .engine.observe import Instrument, Observation, SkySources, \
    check_kernel_knobs, df_rotate3, direct_visibilities, schedule_tensors, simulate_drift, \
    simulate_snapshot, snapshot_nudft_inputs
from .vis import VisibilitySet, delay_transform, phase_centering, \
    phase_path, project_baselines, with_phase_center

__all__ = ["run_simulation", "run_simulation_chunked",
           "prepare_simulation", "resolve_device", "resolve_devices",
           "banded_engine",
           "build_layout", "build_frequencies", "build_schedule",
           "build_sky", "build_observed_sky", "build_tsys",
           "precess_sky_to_obs_epoch", "main"]

SIDEREAL_DEG_PER_SEC = 360.0 / 86164.0905


def resolve_device(device):
    """torch.device for `device`; 'cuda' without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=%r was requested but no CUDA card is "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU" % str(device))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be 'cuda' or 'cpu', got %r"
                         % str(device))
    return dev


def resolve_devices(device, devices=None):
    """The devices of a run, the port's counterpart of jax.devices():
    `devices` when given (a list, which may repeat a device), else every
    visible card for 'cuda' without an index, else [resolve_device(device)].
    """
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices is empty")
    else:
        dev = resolve_device(device)
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" and dev.index is None else [dev])
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def build_layout(parms):
    """Array layout from parms['array'] (getBaselineInfo layout branch,
    PRISim's prisim/interferometry.py:1465-1851), including seeded
    position perturbations (:1686-1694)."""
    ap = parms["array"]
    if ap.get("layout_positions") is not None:
        # inline ENU positions (meters): programmatic configs and
        # layouts whose data files the reference leaves unbundled
        pos = np.asarray(ap["layout_positions"], dtype=np.float64)
        if pos.ndim != 2 or pos.shape[1] not in (2, 3):
            raise ValueError("array.layout_positions must be (N, 2|3)")
        if pos.shape[1] == 2:
            pos = np.concatenate([pos, np.zeros((pos.shape[0], 1))], 1)
        labels = ap.get("layout_labels")
        labels = (np.asarray([str(l) for l in labels])
                  if labels is not None else
                  np.asarray([str(i) for i in range(pos.shape[0])]))
        layout = ArrayLayout(pos, labels)
    elif ap.get("file"):
        pp = ap.get("parser") or {}
        layout = parse_layout_file(ap["file"],
                                   comment=pp.get("comment") or "#",
                                   skip_rows=pp.get("data_start") or 0)
    else:
        layout = preset_layout(ap["layout"], minR=ap.get("minR"),
                               maxR=ap.get("maxR"),
                               element_size=parms["antenna"].get("size"))
    rms_t = ap.get("rms_tgtplane") or 0.0
    rms_e = ap.get("rms_elevation") or 0.0
    if rms_t > 0 or rms_e > 0:
        rng = np.random.RandomState(ap.get("seed"))
        pos = np.array(layout.positions, dtype=np.float64)
        pos[:, :2] += rms_t * rng.randn(pos.shape[0], 2)
        pos[:, 2] += rms_e * rng.randn(pos.shape[0])
        layout = ArrayLayout(pos, layout.labels)
    prefix = parms["telescope"].get("label_prefix") or ""
    if prefix:
        layout = ArrayLayout(layout.positions,
                             np.asarray([prefix + str(l)
                                         for l in layout.labels]))
    return layout


def build_frequencies(parms):
    bp = parms["bandpass"]
    nchan = int(bp["nchan"])
    df = float(bp["freq_resolution"])
    f_center = float(bp["freq"])
    return f_center + df * (np.arange(nchan) - nchan / 2)


def _jd_init_from_obs_date(parms, lst_init_deg, longitude):
    """Julian date at the start of the observation: the first instant on
    obsparm.obs_date (UT, 'YYYY/MM/DD') at which the local sidereal time
    equals lst_init (the reference's julian_date_from_LAST flow,
    run_prisim.py:661-667)."""
    from . import ephemeris as eph
    date = str(parms["obsparm"].get("obs_date") or "2015/11/23")
    y, m, d = [int(x) for x in date.replace("-", "/").split("/")[:3]]
    jd0 = eph.julian_date(y, m, d)                       # midnight UT
    dlst = (lst_init_deg - eph.lst_deg(jd0, longitude)) % 360.0
    return jd0 + dlst / 360.98564736629          # sidereal rate deg/day


def build_schedule(parms, latitude, longitude=None):
    """Observation schedule (run_prisim.py:576-740): drift (fixed altaz
    or ha/dec pointing) or track (fixed ra/dec). jd_init falls back to
    obsparm.obs_date + lst_init via the ephemeris (run_prisim.py:
    661-667) when pointing.jd_init is not given."""
    op = parms["obsparm"]
    pt = parms["pointing"]
    if longitude is None:
        longitude = float(parms["telescope"].get("longitude") or 0.0)
    n_acc = int(op["n_acc"]) if op.get("t_obs") is None else \
        int(np.ceil(float(op["t_obs"]) / float(op["t_acc"])))
    t_acc = float(op["t_acc"])
    lst_init = float(pt.get("lst_init") or 0.0) * 15.0 \
        if abs(float(pt.get("lst_init") or 0.0)) <= 24.0 \
        else float(pt["lst_init"])
    jd_init = pt.get("jd_init")
    if jd_init is None:
        jd_init = _jd_init_from_obs_date(parms, lst_init, longitude)
    lst = (lst_init + SIDEREAL_DEG_PER_SEC * t_acc *
           (np.arange(n_acc) + 0.5)) % 360.0
    jd = jd_init + t_acc * (np.arange(n_acc) + 0.5) / 86400.0
    if pt.get("file"):
        # pointing file: text columns (lst_deg, alt, az), one row per
        # accumulation (run_prisim.py pointing-file branch :576-660)
        data = np.atleast_2d(np.genfromtxt(pt["file"], comments="#"))
        lst = data[:, 0]
        n_acc = lst.size
        jd = jd_init + t_acc * (np.arange(n_acc) + 0.5) / 86400.0
        obs = Observation(lst_deg=lst, jd=jd,
                          t_acc=np.full(n_acc, t_acc),
                          pointing_altaz=data[:, 1:3], mode="file")
        return _apply_snapshot_selection(obs, parms)
    mode = op.get("obs_mode", "drift")
    if mode == "drift":
        di = pt.get("drift_init") or {}
        if di.get("alt") is not None and di.get("az") is not None:
            altaz = np.tile([[float(di["alt"]), float(di["az"])]],
                            (n_acc, 1))
        else:
            ha = float(di.get("ha") or 0.0)
            dec = float(di.get("dec") if di.get("dec") is not None
                        else latitude)
            hadec = np.tile([[ha, dec]], (n_acc, 1))
            altaz = geom.hadec2altaz(hadec, latitude, xp=np)
    elif mode == "track":
        ti = pt.get("track_init") or {}
        ra = float(ti.get("ra") or 0.0)
        dec = float(ti.get("dec") if ti.get("dec") is not None
                    else latitude)
        ha = lst - ra
        hadec = np.stack([ha, np.full(n_acc, dec)], axis=-1)
        altaz = geom.hadec2altaz(hadec, latitude, xp=np)
    else:
        raise ValueError("obs_mode must be 'drift' or 'track'")
    obs = Observation(lst_deg=lst, jd=jd, t_acc=np.full(n_acc, t_acc),
                      pointing_altaz=altaz, mode=mode)
    return _apply_snapshot_selection(obs, parms)


def _apply_snapshot_selection(obs, parms):
    """snapshot.pick / snapshot.range / snapshot.avg_drifts
    (run_prisim.py snapshot section; defaultparms.yaml 'snapshot')."""
    sn = parms.get("snapshot") or {}
    idx = None
    if sn.get("pick") is not None:
        idx = np.atleast_1d(np.asarray(sn["pick"], dtype=int))
    elif sn.get("range") is not None:
        lo, hi = sn["range"]
        idx = np.arange(int(lo), int(hi))
    if idx is not None:
        obs = Observation(lst_deg=obs.lst_deg[idx], jd=obs.jd[idx],
                          t_acc=obs.t_acc[idx],
                          pointing_altaz=obs.pointing_altaz[idx],
                          mode=obs.mode)
    if sn.get("beam_switch") and obs.mode == "file":
        # drift-and-shift (dns) beam-switch selection
        # (run_prisim.py:604-660): keep the snapshots at which the
        # pointing moves by more than snapshot.shift_threshold degrees
        # (great-circle; reference default 1.0), and give each kept
        # snapshot the LST midpoint and accumulated duration of its
        # whole drift segment (lst_edges_left/right there)
        thr = float(sn.get("shift_threshold") or 1.0)
        alt, az = obs.pointing_altaz[:, 0], obs.pointing_altaz[:, 1]
        dang = np.asarray(geom.sphdist(az[1:], alt[1:], az[:-1],
                                       alt[:-1], xp=np))
        keep = np.r_[True, dang > thr]
        idx2 = np.where(keep)[0]
        lst_u = np.unwrap(obs.lst_deg, period=360.0)
        edges = np.r_[lst_u, lst_u[-1] + (lst_u[-1] - lst_u[-2]
                                          if lst_u.size > 1 else 0.0)]
        left = lst_u[idx2]
        right = np.r_[edges[idx2[1:]], edges[-1]]
        t_seg = (right - left) / SIDEREAL_DEG_PER_SEC
        obs = Observation(lst_deg=(0.5 * (left + right)) % 360.0,
                          jd=obs.jd[idx2], t_acc=t_seg,
                          pointing_altaz=obs.pointing_altaz[idx2],
                          mode=obs.mode)
    if sn.get("avg_drifts"):
        # collapse all drift snapshots to their mean epoch with the
        # total accumulation time (snapshot.avg_drifts semantics)
        obs = Observation(
            lst_deg=np.asarray([obs.lst_deg.mean()]),
            jd=np.asarray([obs.jd.mean()]),
            t_acc=np.asarray([obs.t_acc.sum()]),
            pointing_altaz=obs.pointing_altaz.mean(axis=0,
                                                   keepdims=True),
            mode=obs.mode)
    return obs


def build_sky(parms, freqs):
    """Sky model from parms['skyparm']/parms['catalog'] (prisim_tpu/
    driver.py:200-431). Ported models: 'random' (synthetic catalog),
    'custom' (ascii catalog: RA DEC FLUX [SPINDEX] [MAJAX MINAX PA]), the
    survey catalogs 'sumss', 'nvss', 'gleam', 'mwacs' and their merges
    'csm' (SUMSS + NVSS) and 'asm' (csm + the DSM map), 'hi_monopole',
    'noise', 'skymod_hdf5' (native SkyModel HDF5), 'hi_cube' from FITS
    simulation cubes or npz, and 'usm'/'hpx'/'dsm'/'gsm' HEALPix maps from
    .npy/.npz or per-pixel DSM FITS tables."""
    sp = parms["skyparm"]
    cat = parms["catalog"]
    model = (sp.get("model") or "custom").lower()
    if model == "random":
        sm = random_point_source_model(
            int(sp.get("nsrc") or 100),
            flux_min=float(sp.get("flux_min") or 1.0),
            flux_max=float(sp.get("flux_max") or 100.0),
            spindex_mean=float(sp.get("spindex") or -0.83),
            spindex_rms=float(sp.get("spindex_rms") or 0.0),
            seed=int(sp.get("seed") or 0))
    elif model == "custom":
        path = cat.get("custom_file")
        if not path:
            raise ValueError("catalog.custom_file required for "
                             "skyparm.model='custom'")
        data = np.atleast_2d(np.genfromtxt(path, comments="#"))
        ra, dec, flux = data[:, 0], data[:, 1], data[:, 2]
        spindex = data[:, 3] if data.shape[1] > 3 else \
            np.full(ra.size, float(sp.get("spindex") or -0.83))
        src_shape = data[:, 4:7] if data.shape[1] >= 7 else None
        ref = float(sp.get("custom_reffreq") or 0.15) * 1e9
        sm = SkyModel(location=np.stack([ra, dec], axis=-1),
                      spec_kind="power-law",
                      spec_parms={"flux-scale": flux,
                                  "freq-ref": np.full(ra.size, ref),
                                  "power-law-index": spindex},
                      src_shape=src_shape)
        fmin = sp.get("flux_min")
        if fmin is not None:
            sm = sm.subset(np.where(flux >= float(fmin))[0])
    elif model in ("csm", "asm"):
        # csm: SUMSS below dec -30 and NVSS above; asm: the same point
        # sources merged with the DSM diffuse map
        parts = []
        if model == "asm":
            path = cat.get("DSM_file_prefix") or cat.get("spectrum_file")
            if not path:
                raise ValueError("asm needs catalog.DSM_file_prefix "
                                 "(per-pixel DSM FITS table)")
            parts.append(CATS.read_dsm_fits(
                path, nside=int(sp.get("nside") or 64),
                map_freq=float(sp.get("custom_reffreq") or 0.15) * 1e9))
        if cat.get("SUMSS_file"):
            parts.append(CATS.read_sumss(
                cat["SUMSS_file"],
                spindex_rms=float(sp.get("spindex_rms") or 0.0),
                spindex_seed=sp.get("spindex_seed")))
        if cat.get("NVSS_file"):
            parts.append(CATS.read_nvss(
                cat["NVSS_file"], exclude_sumss_sky=bool(
                    cat.get("SUMSS_file")),
                spindex_rms=float(sp.get("spindex_rms") or 0.0),
                spindex_seed=sp.get("spindex_seed")))
        if not parts or (model == "csm" and not any(
                cat.get(k) for k in ("SUMSS_file", "NVSS_file"))):
            raise ValueError("%s needs catalog.SUMSS_file and/or "
                             "catalog.NVSS_file" % model)
        # the flux cut applies to the point-source catalogs only: every
        # DSM pixel is kept
        ndiff = 1 if model == "asm" else 0
        if sp.get("flux_min") is not None and len(parts) > ndiff:
            ps = CATS.flux_cut(SkyModel.concat(parts[ndiff:]),
                               flux_min=sp["flux_min"],
                               flux_max=sp.get("flux_max"),
                               cut_freq=_fluxcut_freq(sp))
            parts = parts[:ndiff] + [ps]
        sm = SkyModel.concat(parts)
    elif model in ("sumss", "nvss", "gleam", "mwacs"):
        reader = {"sumss": CATS.read_sumss, "nvss": CATS.read_nvss,
                  "gleam": CATS.read_gleam, "mwacs": CATS.read_mwacs}
        path = cat.get(model.upper() + "_file") or cat.get("custom_file")
        if not path:
            raise ValueError("catalog.%s_file required for "
                             "skyparm.model=%r" % (model.upper(), model))
        kw = {}
        if model in ("sumss", "nvss", "mwacs"):
            kw = dict(spindex_mean=float(sp.get("spindex") or -0.83),
                      spindex_rms=float(sp.get("spindex_rms") or 0.0),
                      spindex_seed=sp.get("spindex_seed"))
        elif model == "gleam":
            kw = dict(select_freq=float(np.median(freqs)))
        sm = reader[model](path, **kw)
        if sp.get("flux_min") is not None or sp.get("flux_max") is not None:
            sm = CATS.flux_cut(sm, flux_min=sp.get("flux_min"),
                               flux_max=sp.get("flux_max"),
                               cut_freq=_fluxcut_freq(sp))
    elif model in ("hi_monopole", "monopole"):
        # global-EoR tanh monopole on a uniform HEALPix sky
        nside = int(sp.get("nside") or 32)
        npix = hp.nside2npix(nside)
        theta, phi = hp.pix2ang(nside, np.arange(npix))
        gp = sp.get("global_EoR_parms") or [0.027, 150e6, 1.0]
        temp = np.broadcast_to(
            tanh_eor_spectrum(freqs, gp[0], gp[1], gp[2], 0.0),
            (npix, freqs.size)).copy()           # K (brightness temp)
        spectrum = temperature_to_jy_per_pixel(temp, freqs, nside) \
            if (sp.get("flux_unit", "K")).lower() == "k" \
            else temp * hp.nside2pixarea(nside)
        sm = SkyModel(
            location=np.stack([np.degrees(phi),
                               90.0 - np.degrees(theta)], axis=-1),
            spec_kind="spectrum", spectrum=spectrum,
            freqs_model=np.asarray(freqs, dtype=np.float64),
            name="HI_monopole")
    elif model == "noise":
        # noise-only simulation: one zero-flux source keeps shapes static
        sm = SkyModel(location=np.asarray([[0.0, -90.0]]),
                      spec_kind="power-law",
                      spec_parms={"flux-scale": np.asarray([0.0]),
                                  "freq-ref": np.asarray([150e6]),
                                  "power-law-index": np.asarray([0.0])},
                      name="noise")
    elif model in ("skymod_hdf5", "hdf5"):
        sm = SkyModel.load_hdf5(cat["skymod_file"])
    elif model in ("hi_cube", "hi_fluctuations", "lidz", "21cmfast"):
        # HI lightcone cube: FITS simulation cubes (Lidz/21cmFAST,
        # run_prisim.py:1020-1065) or npz with 'maps' (npix, nf) HEALPix
        # brightness maps + 'freqs'
        path = cat.get("spectrum_file") or cat.get("skymod_file")
        if not path:
            raise ValueError("catalog.spectrum_file required for HI cube")
        if str(path).endswith((".fits", ".FITS")):
            sm = CATS.read_hi_cube_fits(
                path, center_freq=float(parms["bandpass"]["freq"]),
                fluctuations=(model == "hi_fluctuations"))
        else:
            with np.load(path) as d:
                maps = d["maps"]
                fmdl = d["freqs"]
            if model == "hi_fluctuations":
                maps = maps - maps.mean(axis=0, keepdims=True)
            sm = healpix_diffuse_model(maps, freqs_model=fmdl)
    elif model in ("usm", "hpx", "dsm", "gsm", "gsm2008", "gsm2016"):
        nside = int(sp.get("nside") or 64)
        if model == "usm":
            temp = np.ones(hp.nside2npix(nside))
        else:
            path = cat.get("DSM_file_prefix") or cat.get("spectrum_file")
            if not path:
                raise ValueError("skyparm.model=%r needs a HEALPix map "
                                 "(.npy, .npz with 'maps' and 'freqs', or a "
                                 "DSM FITS table) in catalog.spectrum_file "
                                 "or catalog.DSM_file_prefix" % model)
            if str(path).endswith((".fits", ".FITS")) or \
                    not os.path.exists(str(path)):
                # per-pixel FITS table, or the reference's file prefix
                # (expanded inside the reader)
                temp = CATS.read_dsm_fits(
                    path, nside=nside,
                    map_freq=float(sp.get("custom_reffreq") or 0.15) * 1e9)
            else:
                temp = np.load(path)
            if hasattr(temp, "files"):
                if "maps" in temp.files and "freqs" in temp.files:
                    temp = healpix_diffuse_model(
                        temp["maps"], freqs_model=temp["freqs"])
                else:
                    temp = temp[temp.files[0]]
        if isinstance(temp, SkyModel):
            sm = temp
        else:
            sm = healpix_diffuse_model(
                temp,
                freqs_model=np.asarray([float(sp.get("custom_reffreq")
                                              or 0.15) * 1e9]),
                spindex=float(sp.get("spindex") or -2.55))
    else:
        raise ValueError("unsupported skyparm.model %r" % model)
    return sm


def _fluxcut_freq(sp):
    return (float(sp["fluxcut_reffreq"]) if sp.get("fluxcut_reffreq")
            else None)


def precess_sky_to_obs_epoch(sky, parms, obs):
    """Precess catalog coordinates from skyparm.epoch (a Julian year,
    e.g. '2000') to the observing epoch — the reference precesses the
    sky model to the obs epoch once (run_prisim.py:1690-1692) and
    transforms FK5->AltAz per snapshot (interferometry.py:6174-6180).
    J2000->2015 is ~0.2 deg, far outside the 1e-6 visibility budget."""
    from . import ephemeris as eph
    ep = parms["skyparm"].get("epoch")
    if ep is None:
        return sky
    jd_from = float(eph.jyear_to_jd(float(ep)))
    jd_to = float(np.mean(np.asarray(obs.jd, dtype=np.float64)))
    if abs(jd_to - jd_from) < 1.0:                # same epoch: no-op
        return sky
    ra, dec = eph.precess_radec(sky.location[:, 0], sky.location[:, 1],
                                jd_from, jd_to)
    return dataclasses.replace(
        sky, location=np.stack([ra, dec], axis=-1),
        epoch_jyear=2000.0 + (jd_to - eph.JD_J2000) / 365.25)


def build_observed_sky(parms, freqs, obs):
    """The sky of a run: build_sky, precessed to the observing epoch and,
    with skyparm.roi_radius, cut to the sources within that many degrees
    of the (mean-LST) pointing center."""
    lat = float(parms["telescope"]["latitude"])
    sky = precess_sky_to_obs_epoch(build_sky(parms, freqs), parms, obs)
    roi = parms["skyparm"].get("roi_radius")
    if roi is not None:
        pc_altaz = obs.pointing_altaz.mean(axis=0)
        hadec = geom.altaz2hadec(pc_altaz.reshape(1, 2), lat, xp=np)
        pc_ra = (np.mean(obs.lst_deg) - hadec[0, 0]) % 360.0
        d = geom.sphdist(sky.location[:, 0], sky.location[:, 1],
                         pc_ra, hadec[0, 1], xp=np)
        sky = sky.subset(np.where(d <= float(roi))[0])
        if sky.nsrc == 0:
            raise ValueError(
                "skyparm.roi_radius=%.1f deg leaves no sources in the "
                "field of view" % float(roi))
    return sky


def _src_block_from_memuse(parms, nbl, nchan, nsrc):
    """processing.memuse (GB) -> source-streaming block size via the
    reference's DFT-matrix memory model (run_prisim.py:1737-1743:
    nsrc*nchan*nbl*8 B), scaled by skyparm.fsky (fraction of the model
    above the horizon at any instant, defaultparms.yaml:643-656)."""
    proc = parms["processing"]
    memuse = proc.get("memuse")
    if memuse is None:
        return None
    bytes_per_src = nbl * nchan * 8.0          # complex64 phase matrix
    fsky = parms["skyparm"].get("fsky")
    eff_nsrc = nsrc * (float(fsky) if fsky else 1.0)
    blk = int(float(memuse) * 2 ** 30 / bytes_per_src)
    return int(np.clip(blk, 16, max(16, eff_nsrc)))


def build_tsys(parms, freqs, nbl, n_acc):
    """System temperature (nbl, nchan, nacc): flat telescope.Tsys or
    Trx + Tant_ref (f/f_ref)^spindex (the Tsysinfo model,
    PRISim's prisim/interferometry.py:5993-6086)."""
    tp = parms["telescope"]
    if tp.get("Tsys") is not None:
        tsys = np.full((nbl, freqs.size, n_acc), float(tp["Tsys"]))
    else:
        tant = (float(tp.get("Tant_ref") or 0.0) *
                (freqs / float(tp.get("Tant_freqref") or 150e6))
                ** float(tp.get("Tant_spindex") or 0.0))
        tsys = np.broadcast_to(
            (float(tp.get("Trx") or 0.0) + tant)[None, :, None],
            (nbl, freqs.size, n_acc)).copy()
    return tsys


def _blgroups_dict(bls):
    """Redundancy bookkeeping for the saved product (the reference's
    blgroups/reversemap, interferometry.py:1640-1658): unique-exemplar
    label pair -> member all-pairs label strings."""
    if bls.group_of is None:
        return None
    all_lab = np.asarray(bls.all_labels, dtype=str)
    uniq_lab = np.asarray(bls.labels, dtype=str)
    names = ["%s_%s" % (a, b) for a, b in all_lab.tolist()]
    # each group's members in ascending order, from one stable sort
    order = np.argsort(bls.group_of, kind="stable")
    edges = np.searchsorted(bls.group_of[order], np.arange(bls.nbl + 1))
    return {"%s_%s" % (uniq_lab[u, 0], uniq_lab[u, 1]):
            [names[m] for m in order[edges[u]:edges[u + 1]]]
            for u in range(bls.nbl)}


def _bandpass_weights(parms, nbl, freqs, n_acc):
    """Channel flagging -> bp; window shape -> bp_wts (run_prisim.py:908-981
    flags; processing.bpass_shape).

    For frequency-chunked runs the reference builds the bandpass once
    over the FULL band before chunking (run_prisim.py:898-981): flag
    indices, edge flags, and window shapes are global-band quantities.
    When pp._chunk metadata is present, compute on the full grid and
    slice this chunk's channels."""
    chunk = (parms.get("pp") or {}).get("_chunk")
    if chunk and int(chunk.get("axis", -1)) == 1:
        nchan_total = int(chunk["nchan_total"])
        chan0 = int(chunk["chan0"])
        df = float(parms["bandpass"]["freq_resolution"])
        freqs_full = (freqs[0] - df * chan0) + df * np.arange(nchan_total)
        bp, wts = _bandpass_weights_full(parms, nbl, freqs_full, n_acc)
        sl = slice(chan0, chan0 + freqs.size)
        return (np.ascontiguousarray(bp[:, sl, :]),
                np.ascontiguousarray(wts[:, sl, :]))
    return _bandpass_weights_full(parms, nbl, freqs, n_acc)


def _bandpass_weights_full(parms, nbl, freqs, n_acc):
    nchan = freqs.size
    bp = np.ones((nbl, nchan, n_acc))
    pfb = (parms.get("bandpass") or {}).get("pfb_method")
    ccw = int(parms["processing"].get("coarse_channel_width") or 16)
    shape1d = None
    if pfb == "theoretical" and parms["bandpass"].get("pfb_file"):
        # measured PFB response from a FITS table (run_prisim.py:
        # 916-927): hdu0 = per-filter response grid (dB), hdu1 =
        # frequency axis (MHz); summed in linear units and interpolated
        # onto the channels
        shape1d = win.pfb_theoretical_shape(parms["bandpass"]["pfb_file"],
                                            freqs)
    elif pfb is not None:
        # analytic PFB scalloping (stand-in for the empirical MWA
        # table, DSP.PFB_empirical at run_prisim.py:914)
        shape1d = win.pfb_shape(nchan, ccw)
    if shape1d is not None and not parms["processing"].get("bp_correct",
                                                           True):
        bp *= shape1d[None, :, None]
    abf = parms["processing"].get("ant_bpass_file")
    if abf:
        # antenna bandpass table: npz with 'faxis' (Hz) and complex
        # 'band'; |band| interpolated onto the channels and peak-
        # normalized (run_prisim.py:934-944)
        with np.load(abf) as d:
            faxis = np.asarray(d["faxis"], dtype=np.float64)
            band = np.abs(np.asarray(d["band"]))
        band = band / band.max()
        ant_bp = np.interp(freqs, faxis, band)
        bp *= ant_bp[None, :, None]
    fl = parms.get("flags") or {}
    n_edge = [int(x) for x in (fl.get("n_edge_flag") or [0, 0])]
    if fl.get("flag_repeat_edge_channels") and shape1d is not None \
            and (n_edge[0] or n_edge[1]):
        # flag around every coarse-channel edge of the PFB shape instead
        # of the band edges (run_prisim.py:928-940, 964-966)
        e0 = int(np.argmin(shape1d))
        edges = (e0 + np.arange(nchan // ccw) * ccw) % nchan
        edges = np.unique(np.hstack([edges, [edges.min() - ccw,
                                             edges.max() + ccw]]))
        for e in edges:
            bp[:, max(0, e - n_edge[0]):
               max(0, min(nchan, e + n_edge[1])), :] = 0.0
    else:
        if n_edge[0]:
            bp[:, :n_edge[0], :] = 0.0
        if n_edge[1]:
            bp[:, nchan - n_edge[1]:, :] = 0.0
    flag_chan = np.asarray(fl.get("flag_chan") if fl.get("flag_chan")
                           is not None else [-1]).ravel().astype(int)
    if fl.get("bp_flag_repeat"):
        # within-coarse-channel offsets repeated across every coarse
        # channel (run_prisim.py:971-974)
        flag_chan = flag_chan[flag_chan >= 0] % ccw
        reps = np.arange(0, nchan, ccw)
        flag_chan = np.unique((flag_chan[None, :] +
                               reps[:, None]).ravel())
    flag_chan = flag_chan[(flag_chan >= 0) & (flag_chan < nchan)]
    if flag_chan.size:
        bp[:, flag_chan, :] = 0.0
    shape = (parms["processing"].get("bpass_shape") or "rect").lower()
    if shape == "rect":
        wts = np.ones((nbl, nchan, n_acc))
    else:
        w = win.window_vals(nchan, shape=shape)
        wts = np.broadcast_to(w[None, :, None],
                              (nbl, nchan, n_acc)).copy()
    return bp, wts


def _telescope(parms):
    """The telescope dict the beams read (id, element shape, size and
    orientation)."""
    tp = parms["telescope"]
    telescope = {
        "id": tp.get("id", "custom"),
        "shape": parms["antenna"].get("shape", "dish"),
        "size": parms["antenna"].get("size", 14.0),
        "ocoords": parms["antenna"].get("ocoords", "altaz"),
        "orientation": parms["antenna"].get("orientation", [90.0, 270.0]),
        "groundplane": parms["antenna"].get("ground_plane"),
    }
    ori = np.asarray(telescope["orientation"], dtype=np.float64)
    if telescope["ocoords"] == "altaz":
        telescope["orientation_dircos"] = tuple(
            geom.altaz2dircos(ori.reshape(1, 2), xp=np)[0])
    return telescope


def _resolve_engine(parms, device):
    """'direct' or 'nufft': processing.engine, with 'auto' resolved as
    the reference resolves it on its accelerator (the banded NUFFT engine
    on a CUDA card, the direct engine on the CPU)."""
    engine = (parms["processing"].get("engine") or "auto").lower()
    if engine == "auto":
        return "nufft" if device.type == "cuda" else "direct"
    if engine not in ("direct", "nufft"):
        raise ValueError("processing.engine must be auto, direct or nufft")
    return engine


# processing.nufft_spread values of the sorted route (kernel delay_spread)
_SORTED = ("sorted", "scatter")


def _nufft_spread(parms):
    return str(parms["processing"].get("nufft_spread") or "auto").lower()


def check_supported(parms, device, n_devices=1):
    """Raise, before any compute, for a value the port does not know and for
    a pp.mesh_axes that does not fit the run's `n_devices`."""
    proc = parms["processing"]
    engine = _resolve_engine(parms, device)
    if engine == "nufft" and not proc.get("gradient_mode"):
        if _nufft_spread(parms) not in ("auto", "banded") + _SORTED:
            raise ValueError("processing.nufft_spread must be auto, banded, "
                             "sorted or scatter")
    if proc.get("use_pallas") is False:
        check_kernel_knobs(device, use_pallas=False)
    pp = parms.get("pp") or {}
    axes = pp.get("mesh_axes")
    if axes:
        n_axes = 3 if (pp.get("key") or "freq").lower() == "src" else 2
        if len(axes) != n_axes or int(np.prod(axes)) != n_devices:
            raise ValueError("pp.mesh_axes %s needs %d axes whose product is "
                             "the run's %d devices" % (list(axes), n_axes,
                                                        n_devices))
    bm = parms.get("beam") or {}
    pol = str(bm.get("pol") or "X").upper()
    if pol not in ("X", "Y", "XY", "DUAL", "FULL"):
        raise ValueError("beam.pol must be X, Y, XY, or full")
    from .io.hdf5 import h5py
    if (bm.get("use_external") and bm.get("file") and h5py is None
            and not _fits_beam(bm["file"])):
        raise ImportError("beam.file %r is read as HDF5, which needs h5py; "
                          "give the beam as a FITS file" % bm["file"])
    sf = parms["save_formats"]
    if (sf.get("fmt") or "HDF5").lower() == "hdf5" and h5py is None:
        raise ImportError("save_formats.fmt: HDF5 needs h5py; set "
                          "save_formats.fmt: none to write NPZ only")
    if sf.get("uvh5") and h5py is None:
        raise ImportError("save_formats.uvh5 needs h5py; write UVFITS "
                          "(save_formats.uvfits) instead")


def _fits_beam(path):
    """Whether an external beam file is read as FITS (else HDF5)."""
    return str(path).endswith((".fits", ".uvbeam"))


def _pointing_info(parms, telescope, obs):
    """The beamformer of a phased array (antenna.phased_array): element
    positions from phasedarray.file, else the MWA tile, into
    telescope['element_locs'], and the pointing_info dict (snapshot 0's
    pointing, delayerr, gainerr, nrand); None for other arrays."""
    if not parms["antenna"].get("phased_array"):
        return None
    pa = parms.get("phasedarray") or {}
    if pa.get("file"):
        elem = parse_layout_file(pa["file"], skip_rows=0)
        telescope["element_locs"] = np.asarray(elem.positions)
    else:
        telescope["element_locs"] = mwa_tile_positions()
    pc0 = geom.altaz2dircos(obs.pointing_altaz[:1], xp=np)[0]
    return {"pointing_center_dircos": tuple(pc0),
            "delayerr": float(pa.get("delayerr") or 0.0),
            "gainerr": float(pa.get("gainerr") or 0.0),
            "nrand": int(pa.get("nrand") or 1)}


def _sector_mask(dircos, k, n_sectors):
    """Per-snapshot azimuthal sky-sector membership, (S,) in dircos's
    dtype: sector k of n is az in [-w/2 + k w, -w/2 + (k+1) w) and its
    antipodal wedge, w = 180/n deg, both of which fold to
    floor(((az + w/2) mod 180) / w) == k. Evaluated on the snapshot's
    current direction cosines, so membership follows the drift."""
    az = torch.rad2deg(torch.atan2(dircos[..., 0], dircos[..., 1]))
    w = 180.0 / n_sectors
    m = torch.remainder(az + 0.5 * w, 180.0)
    return (torch.floor(m / w) == k).to(dircos.dtype)


def _make_beam_fn(parms, telescope, freqs, pointing_info=None):
    """beam_fn(dircos, freqs, pc=None) -> (S, C) power pattern on dircos's
    device, masked to the run's sky sector (parms['_sector']) if it has
    one. With a phased array (`pointing_info`) it carries needs_pointing,
    and the engines pass each snapshot's pointing dircos as `pc`. In a
    full-pol component run (parms['_mueller_component'] XX, YY or XY) the
    beam is that unpolarized-sky Mueller weight of the beam.feeds crossed
    dipoles (beams/jones.py; XY is sign-indefinite).

    Where the beam is a plain chromatic Airy dish (the conditions of the
    reference, prisim_tpu/driver.py:983-1015: no sector, no steering, no
    external beam, no ground plane, no Mueller component), it carries
    beam_fn.airy = (diameter, axis) (beams.dispatch.airy_dish), by which
    observe._beam_and_flux weights CUDA tensors with the airy_amps kernel,
    and, where the telescope's own dish (the X feed's) points at zenith,
    beam_fn.df_eval(s_hi, s_lo, nu) -> (S, len(nu)) float64, the truth
    pattern of the banded engine's truth-amps path, with beam_fn.df_airy,
    its dish diameter, by which the banded prep computes that pattern in
    its kernel."""
    bm = parms.get("beam") or {}
    achromatic = bm.get("chromatic") is False
    sel_freq = float(bm.get("select_freq") or 150e6)
    pol = str(bm.get("pol") or "X").upper()
    sector = parms.get("_sector")
    band_freq = sel_freq if achromatic else float(freqs[0])

    def beam_fn(dircos, f, pc=None):
        pinfo = pointing_info
        if pc is not None and pointing_info is not None:
            pinfo = dict(pointing_info, pointing_center_dircos=pc)
        if achromatic:
            f1 = torch.tensor([sel_freq], dtype=torch.float32,
                              device=dircos.device)
            pb = primary_beam(dircos, f1, telescope, pointing_info=pinfo,
                              pol=pol, band_freq=band_freq).expand(
                                  dircos.shape[0], f.shape[0])
        else:
            pb = primary_beam(dircos, f, telescope, pointing_info=pinfo,
                              pol=pol, band_freq=band_freq)
        if sector is not None:
            pb = pb * _sector_mask(dircos, *sector)[:, None]
        return pb

    beam_fn.needs_pointing = pointing_info is not None
    mueller = parms.get("_mueller_component")
    if mueller is not None:
        comp = str(mueller).upper()
        if comp not in ("XX", "YY", "XY"):
            raise ValueError("_mueller_component must be XX, YY or XY")
        fd = dict(bm.get("feeds") or {})
        mkw = dict(
            length=float(fd.get("length") or 1.3),
            ground_height=(None if fd.get("height") is None
                           else float(fd["height"])),
            x_orientation_deg=float(fd.get("x_orientation_deg") or 0.0),
            y_orientation_deg=float(
                90.0 if fd.get("y_orientation_deg") is None
                else fd["y_orientation_deg"]),
            short_dipole=bool(fd.get("short_dipole")),
            half_wave=bool(fd.get("half_wave", True)))

        def beam_fn(dircos, f, pc=None):  # noqa: F811
            pb = mueller_unpol_weights(dircos, f, **mkw)[comp]
            if sector is not None:
                pb = pb * _sector_mask(dircos, *sector)[:, None]
            return pb

        beam_fn.needs_pointing = False
        return beam_fn
    if (sector is None and pointing_info is None and not achromatic
            and not bm.get("use_external")
            and not telescope.get("groundplane")):
        dish = airy_dish(telescope, pol)
        if dish is not None:
            beam_fn.airy = dish
        # the truth form is zenith-only; as in the reference, the dish and
        # its axis are the telescope's own, whatever the pol
        truth = airy_dish(telescope)
        if truth is not None:
            dia, odc = truth
            zenith = odc is None or (abs(odc[0]) < 1e-12
                                     and abs(odc[1]) < 1e-12 and odc[2] > 0)
            if zenith and airy_df_available(freqs, dia):
                beam_fn.df_eval = functools.partial(airy_beam_df,
                                                    diameter=dia)
                beam_fn.df_airy = dia
    return beam_fn


@dataclasses.dataclass
class Simulation:
    """Everything a drift scan needs, built from parms on one device."""
    layout: ArrayLayout
    bls: object                  # baselines.BaselineSet
    freqs: np.ndarray
    obs: Observation
    telescope: dict
    inst: Instrument
    skymodel: SkyModel           # host sky (the truth path's node fluxes)
    sky: SkySources
    beam_fn: object
    src_block: int


def prepare_simulation(parms, device, verbose=False, sky=None):
    """Host builders + device upload: layout, baselines, schedule, sky
    (build_observed_sky, or the given host `sky`), instrument and beam.
    `parms` is a resolved parameter dict (load_parms). With `verbose`,
    prints the sizes and the phase line "inputs built and on <device>"."""
    with tracing.span("inputs",
                      line=verbose and "inputs built and on %s" % device):
        tp = parms["telescope"]
        lat = float(tp["latitude"])
        layout = build_layout(parms)
        blp = parms.get("baseline") or {}
        bls = build_baselines(layout,
                              redundant=bool(parms["array"].get("redundant",
                                                                True)),
                              min_length=blp.get("min"),
                              max_length=blp.get("max"),
                              direction_deg=blp.get("direction"))
        freqs = build_frequencies(parms)
        obs = build_schedule(parms, lat)
        if sky is None:
            with tracing.span("inputs.sky"):
                sky = build_observed_sky(parms, freqs, obs)
        telescope = _telescope(parms)
        pointing_info = _pointing_info(parms, telescope, obs)
        with tracing.span("inputs.upload"):
            inst = Instrument.build(
                bls.vectors, freqs, device, latitude=lat,
                longitude=float(tp.get("longitude") or 0.0),
                altitude=float(tp.get("altitude") or 0.0),
                A_eff=float(tp.get("A_eff") or 154.0),
                eff_Q=float(tp.get("eff_Q") or 1.0), telescope=telescope)
            sks = SkySources.from_skymodel(sky, freqs, device)
        src_block = int(parms["processing"].get("src_block") or 512)
        mem_block = _src_block_from_memuse(parms, bls.nbl, freqs.size,
                                           sky.nsrc)
        if mem_block is not None:
            src_block = min(src_block, mem_block)
        if verbose:
            print("[prisim_tpu_torch] %d bl x %d chan x %d acc, %d sources "
                  "on %s" % (bls.nbl, freqs.size, obs.n_acc, sky.nsrc,
                             device))
        return Simulation(layout, bls, freqs, obs, telescope, inst, sky, sks,
                          _make_beam_fn(parms, telescope, freqs,
                                        pointing_info),
                          src_block)


class _EngineDemotion(Exception):
    """Internal: re-run with processing.engine: direct once the failed
    attempt's frame, and with it its device buffers, has unwound (the
    loop of the reference's run_simulation)."""

    def __init__(self, parms):
        super().__init__("engine demotion")
        self.parms = parms


def _demote(parms, reason):
    """Print why the NUFFT engine is refused; the demotion to raise.
    Every demotion goes to the direct engine, where the reference sends a
    rejected banded plan or a non-unit source to its sorted spread first
    (and on its accelerator then on to the direct engine). Counts
    driver.demotions in a zero-length span "demotion" with the reason."""
    with tracing.span("demotion", reason=reason):
        tracing.count("driver.demotions", 1)
    print("[prisim_tpu_torch] %s; falling back to the direct engine"
          % reason)
    p2 = dict(parms)
    p2["processing"] = dict(parms["processing"], engine="direct")
    return _EngineDemotion(p2)


def run_simulation(parms, outdir=None, verbose=True, save=True,
                   _sky_override=None, device="cuda", devices=None):
    """Run a full simulation from a parameter source (path, YAML string
    or dict) on `device` ('cuda': every visible card, 'cuda:k': that card,
    or 'cpu'), or on the list `devices` (resolve_devices; it may repeat a
    device, as ["cpu"] * 8 does). With more than one device and pp.key not
    'none', a plain run takes a device mesh (parallel/mesh.py): the direct
    engine on the ("bl", "chan") mesh of pp.key freq (1, n) or bl (n, 1),
    or the ("bl", "chan", "src") mesh of src (1, 1, n), pp.mesh_axes
    overriding the shape (the sorted NUFFT spread too); the banded engine
    on a (n, 1) 'bl' mesh whatever the key. Gradient runs, shaped skies and
    external beams run on the first device.

    processing.engine 'auto' runs the banded NUFFT engine (kernel K2,
    gated against the direct engine) on a CUDA card and the direct engine
    on the CPU; engine nufft with nufft_spread sorted (or scatter) runs the
    sorted spread (kernel delay_spread), gated against the direct engine's
    snapshot 0; a gradient run, a sky with source shapes or an external
    beam runs the direct engine whatever the engine, and a gradient run's
    VisibilitySet carries gradients["baseline"] (3, nbl, nchan, n_acc).
    Returns (VisibilitySet, output_dir or None); with
    processing.n_sky_sectors > 1, (list of one VisibilitySet per sector,
    None for a sector no source enters, outdir); with beam.pol XY (or
    dual), ([vs_x, vs_y], the X run's output_dir); with beam.pol full,
    ([vs_xx, vs_yy, vs_xy], the XX run's output_dir). Sectors split
    first: each sector's run is a pol run, as in the reference.

    The run is the span "simulation" of prisim_tpu_torch.tracing (a
    sub-run of a sector, pol or chunked run nests under its caller's),
    with the attributes device, engine (the one taken), nbl, nchan, n_acc
    and nsrc."""
    if not isinstance(parms, dict) or "telescope" not in parms:
        parms = load_parms(parms)
    devs = resolve_devices(device, devices)
    dev = devs[0]
    with _diagnosis(parms, dev), \
            tracing.span("simulation", timed=verbose, device=str(dev)):
        cur = parms
        while True:
            try:
                return _run_simulation_inner(cur, outdir, verbose, save, devs,
                                             _sky_override)
            except _EngineDemotion as dem:
                cur = dem.parms
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()


@contextlib.contextmanager
def _diagnosis(parms, dev):
    """The diagnosis section around a run (prisim_tpu/driver.py:647-665):
    jax_profile names a directory that receives a torch.profiler trace of
    the run (CPU activity, and CUDA activity on a card; view it in
    chrome://tracing or Perfetto), resource_monitor samples CPU, RSS and
    device memory to <rootdir>/resource_monitor.jsonl every
    refresh_interval seconds (psutil, imported before any compute).
    jax_profile also turns the span recorder on for the run and writes its
    spans and counters beside the trace (spans_<pid>_<ns>.json: the
    records of prisim_tpu_torch.tracing, each with `kernel_ms`, the device
    time of what it launched, and the profiler's trace_start_ns)."""
    diag = parms.get("diagnosis") or {}
    with contextlib.ExitStack() as stack:
        if diag.get("resource_monitor"):
            from .diagnostics import ResourceMonitor
            root = parms["dirstruct"].get("rootdir") or "./"
            os.makedirs(root, exist_ok=True)
            stack.enter_context(ResourceMonitor(
                os.path.join(root, "resource_monitor.jsonl"),
                interval=float(diag.get("refresh_interval") or 1.0),
                device=dev))
        profile_dir = diag.get("jax_profile")
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(profile_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = profile(activities=acts)
            # registered first, so they run after the profiler has stopped
            stack.callback(_write_spans, prof, profile_dir)
            stack.callback(lambda: prof.export_chrome_trace(os.path.join(
                profile_dir, "trace_%d_%d.json" % (os.getpid(),
                                                   time.time_ns()))))
            stack.enter_context(tracing.on())
            stack.enter_context(prof)
        yield


def _write_spans(prof, profile_dir):
    """The run's spans beside its torch.profiler trace."""
    records = tracing.take()
    kernel_ms = tracing.kernel_ms_by_span(prof, records)
    for rec in records:
        rec["kernel_ms"] = kernel_ms.get(rec["id"], 0.0)
    with open(os.path.join(profile_dir, "spans_%d_%d.json"
                           % (os.getpid(), time.time_ns())), "w") as f:
        json.dump(dict(trace_start_ns=prof.profiler.kineto_results
                       .trace_start_ns(), spans=records), f, default=str)


def _run_sectors(parms, outdir, verbose, save, devs, n_sectors):
    """processing.n_sky_sectors > 1: one simulation per azimuthal sky
    sector (prisim_tpu/driver.py:751-802). The sector's wedge is applied
    inside the beam as an amplitude mask on each snapshot's current source
    azimuths; a host prefilter drops the sources that never enter the
    sector during the scan (2-degree guard margin; the mask decides).
    Returns (list of VisibilitySet or None, outdir)."""
    lat = float(parms["telescope"]["latitude"])
    obs = build_schedule(parms, lat)
    sky = build_observed_sky(parms, build_frequencies(parms), obs)
    w = 180.0 / n_sectors
    lst = np.asarray(obs.lst_deg, dtype=np.float64)
    ha = (lst[:, None] - sky.location[None, :, 0])      # (T, S) deg
    dec = np.radians(sky.location[:, 1])[None, :]
    lat_r = np.radians(lat)
    har = np.radians(ha)
    sin_alt = (np.sin(lat_r) * np.sin(dec)
               + np.cos(lat_r) * np.cos(dec) * np.cos(har))
    # azimuth from north, eastward (matches dircos e/n convention)
    az = np.degrees(np.arctan2(
        -np.cos(dec) * np.sin(har),
        np.sin(dec) * np.cos(lat_r)
        - np.cos(dec) * np.sin(lat_r) * np.cos(har)))
    above = sin_alt > np.sin(np.radians(-2.0))
    fold = np.mod(az + 0.5 * w, 180.0)
    outs = []
    for k in range(n_sectors):
        # margin-expanded wedge membership at any snapshot
        lo_k, hi_k = k * w - 2.0, (k + 1) * w + 2.0
        inw = (fold >= lo_k) & (fold < hi_k)
        if lo_k < 0.0:
            inw |= fold >= lo_k + 180.0
        if hi_k > 180.0:
            inw |= fold < hi_k - 180.0
        keep = np.where(np.any(inw & above, axis=0))[0]
        if verbose:
            print("[prisim_tpu_torch] sky sector %d of %d: %d of %d sources"
                  % (k, n_sectors, keep.size, sky.nsrc))
        if keep.size == 0:
            outs.append(None)
            continue
        p2 = copy.deepcopy(parms)
        p2["processing"]["n_sky_sectors"] = 1
        p2["_sector"] = (k, n_sectors)
        if p2["dirstruct"].get("simid"):
            p2["dirstruct"]["simid"] += "_sector%d" % k
        outs.append(run_simulation(
            p2, outdir=None if outdir is None else outdir + "_sector%d" % k,
            verbose=verbose, save=save, devices=devs,
            _sky_override=sky.subset(keep))[0])
    return outs, outdir


def _run_pols(parms, outdir, verbose, save, devs, sky_override, full):
    """beam.pol XY/dual (prisim_tpu/driver.py:855-889) or, with `full`,
    beam.pol full (:890-922): one simulation per component, each saving its
    own products, plus the combined UVFITS exports under the first
    component's directory (and UVH5 where save_formats.uvh5 asks for it;
    the reference writes UVH5 always, so a run without h5py could not
    save). XY: the X and Y feeds (Y is X rotated 90 deg in azimuth),
    exported as 2-pol and as 4-pol with flagged zero cross-pols. full: XX,
    YY and the XY = YX leakage product of crossed-dipole Jones vectors
    (beams/jones.py), each a pol-X run with its Mueller weight as the
    beam, exported as 4-pol with real cross-pols. Returns (list of
    VisibilitySet, the first component's outdir or None)."""
    comps = ([("_" + c.lower(), "X", c) for c in ("XX", "YY", "XY")] if full
             else [("_pol" + p, p, None) for p in ("X", "Y")])
    outs = []
    for suffix, pol, mueller in comps:
        p2 = copy.deepcopy(parms)
        p2["beam"]["pol"] = pol
        if mueller is not None:
            p2["_mueller_component"] = mueller
        if p2["dirstruct"].get("simid"):
            p2["dirstruct"]["simid"] += suffix
        outs.append(run_simulation(
            p2, outdir=None if outdir is None else outdir + suffix,
            verbose=verbose, save=save, devices=devs,
            _sky_override=sky_override))
    vss, dir0 = [vs for vs, _ in outs], outs[0][1]
    if save and dir0 is not None:
        from .io.uvfits import save_uvfits
        from .io.uvh5 import save_uvh5
        stem = os.path.join(dir0, "simdata", "simvis_")
        second = dict(vs_second=vss[1])
        products = ([(stem + "fullpol", dict(second, four_pol=True,
                                             vs_cross=vss[2]))] if full
                    else [(stem + "dualpol", second),
                          (stem + "4pol", dict(second, four_pol=True))])
        uvh5 = bool(parms["save_formats"].get("uvh5"))
        for base, kw in products:
            save_uvfits(vss[0], base + ".uvfits", **kw)
            if uvh5:
                save_uvh5(vss[0], base + ".uvh5", **kw)
        if verbose:
            print("[prisim_tpu_torch] %s exports -> %s" % (
                "full-pol" if full else "dual-pol", " + ".join(
                    "%s.{%s}" % (base, "uvfits,uvh5" if uvh5 else "uvfits")
                    for base, _ in products)))
    return vss, dir0


def _run_simulation_inner(parms, outdir, verbose, save, devs, sky_override):
    dev = devs[0]
    check_supported(parms, dev, len(devs))
    n_sectors = int(parms["processing"].get("n_sky_sectors") or 1)
    if sky_override is None and n_sectors > 1:
        return _run_sectors(parms, outdir, verbose, save, devs, n_sectors)
    pol = str((parms.get("beam") or {}).get("pol") or "X").upper()
    if pol in ("XY", "DUAL", "FULL"):
        return _run_pols(parms, outdir, verbose, save, devs, sky_override,
                         full=pol == "FULL")
    sim = prepare_simulation(parms, dev, verbose=verbose, sky=sky_override)
    run = tracing.current("simulation")
    run.set(nbl=sim.bls.nbl, nchan=int(sim.freqs.size), n_acc=sim.obs.n_acc,
            nsrc=sim.skymodel.nsrc)
    with tracing.span("visibilities", line=verbose and
                      "visibilities computed + transferred"):
        engine, mesh = _route(parms, sim, devs)
        run.set(engine="direct" if engine == "external" else engine)
        gradients = None
        if engine == "external":
            vis_tbc = _simulate_external(parms, sim, verbose)
        elif engine == "sorted":
            vis_tbc = _simulate_sorted(parms, sim, verbose, mesh)
        elif engine == "banded":
            vis_tbc = _simulate_banded(parms, sim, verbose, mesh)
        else:
            vis_tbc, gradients = _simulate_direct(parms, sim, verbose, mesh)
        if vis_tbc.is_cuda:
            # the engine's queued launches end inside this span
            torch.cuda.synchronize(vis_tbc.device)
    return _finalize_simulation(parms, sim, vis_tbc, outdir, verbose, save,
                                dev, gradients=gradients)


def _route(parms, sim, devs):
    """(engine, mesh) of a simulation on `devs`, the one place that picks
    them: the engine "direct", "banded", "sorted" or "external", and the
    device mesh of run_simulation's docstring or None. Says why when an
    external beam, a gradient run or a sky with source shapes overrides
    processing.engine."""
    grad = bool(parms["processing"].get("gradient_mode"))
    engine = _resolve_engine(parms, devs[0])
    bm = parms.get("beam") or {}
    if bm.get("use_external") and bm.get("file"):
        if engine == "nufft" or grad:
            print("[prisim_tpu_torch] beam.use_external: the external-beam "
                  "route runs the direct engine, without gradients")
        return "external", None
    if grad or sim.sky.src_shape_sigma is not None:
        if engine == "nufft":
            print("[prisim_tpu_torch] %s, which the NUFFT engine does not "
                  "compute; running the direct engine"
                  % ("processing.gradient_mode asks for baseline gradients"
                     if grad else "the sky has source shapes (extended "
                     "sources)"))
        return "direct", None
    if engine == "nufft":
        engine = "sorted" if _nufft_spread(parms) in _SORTED else "banded"
    pp = parms.get("pp") or {}
    key = (pp.get("key") or "freq").lower()
    n = len(devs)
    if n < 2 or key == "none":
        return engine, None
    from .parallel.mesh import make_mesh
    axes = pp.get("mesh_axes")
    # banded rides 'bl' whatever the key (each shard FFTs the full band)
    shape = ((n, 1) if engine == "banded" else tuple(axes) if axes
             else (1, 1, n) if key == "src" else (1, n) if key == "freq"
             else (n, 1))
    return engine, make_mesh(shape, ("bl", "chan", "src")[:len(shape)], devs)


_ON = ("auto", "true", "1", "yes", "on")


def _nufft_rank(parms, freqs):
    """The NUFFT's spectral rank: processing.nufft_rank, else 16 for a
    fractional bandwidth <= 0.4 and 32 above, capped at half the channels
    (prisim_tpu/driver.py:1139-1160)."""
    frac_bw = (freqs[-1] - freqs[0]) / freqs[freqs.size // 2]
    rank = int(parms["processing"].get("nufft_rank")
               or (16 if frac_bw <= 0.4 else 32))
    return min(rank, max(2, freqs.size // 2), freqs.size)


def _banded_settings(parms, sim):
    """(rank, node_model, truth, plan_kw) of the banded NUFFT engine for
    `sim`, as the reference's driver picks them (prisim_tpu/driver.py:
    1139-1410): _nufft_rank's rank; the node model; truth amps ({"beam_df",
    "flux_nodes", "airy_diameter"}) where the beam has a truth form
    (beam_fn.df_eval, and beam_fn.df_airy or None), with
    dot_split 4 in the plan keywords. Prints the reference's warnings."""
    proc = parms["processing"]
    freqs = sim.freqs
    rank = _nufft_rank(parms, freqs)
    node_model = bool(proc.get("nufft_node_model", True))
    truth_req = str(proc.get("nufft_truth_amps", "auto")).lower()
    truth_on = (node_model and truth_req in _ON
                and hasattr(sim.beam_fn, "df_eval"))
    if truth_req in _ON and truth_req != "auto" and not truth_on:
        print("[prisim_tpu_torch] nufft_truth_amps requested but "
              "unavailable (needs the node model and a truth beam form); "
              "using the f32 path")
    if node_model and not proc.get("nufft_crosscheck", True):
        print("[prisim_tpu_torch] warning: nufft_node_model is on with "
              "nufft_crosscheck disabled - non-smooth source spectra may "
              "lose accuracy ungated (set nufft_node_model: false for the "
              "projection form)")
    plan_kw = {k: v for k, v in dict(
        beta=proc.get("nufft_beta"),
        dot_split=proc.get("nufft_dot_split")).items() if v}
    truth = None
    if truth_on:
        plan_kw.setdefault("dot_split", 4)
        nm = chebyshev_node_model(freqs, rank)
        sky = sim.skymodel
        if sky.spec_kind == "power-law":
            nodes = powerlaw_node_fluxes(sky.spec_parms, nm.nu_nodes)
        else:
            with tracing.span("plan.nodes"):
                nodes = sky.generate_spectrum(nm.nu_nodes)
        truth = {"beam_df": sim.beam_fn.df_eval, "flux_nodes": nodes,
                 "airy_diameter": getattr(sim.beam_fn, "df_airy", None)}
    return rank, node_model, truth, plan_kw


def banded_engine(parms, sim, collapse=True, settings=None):
    """(plan, snapshot functions) of the banded NUFFT engine for `sim`,
    built as the driver builds them, with the `settings` of
    _banded_settings (computed when not given); `collapse` as in
    make_banded_plan. Raises PlanRejected when the plan is rejected."""
    with tracing.span("plan"):
        rank, node_model, truth, plan_kw = (
            settings if settings is not None
            else _banded_settings(parms, sim))
        with tracing.span("plan.grid"):
            plan = make_banded_plan(np.asarray(sim.bls.vectors),
                                    sim.inst.nu0, sim.inst.dnu,
                                    sim.freqs.size, rank=rank,
                                    collapse=collapse, **plan_kw)
            pinvQ, Q = chebyshev_projection(sim.freqs, rank)
        with tracing.span("plan.fns"):
            return plan, make_banded_snapshot_fns(
                sim.inst, sim.sky, sim.beam_fn, plan, pinvQ, Q,
                gate_src_block=sim.src_block, node_model=node_model,
                truth=truth)


def _dump_gate(sim, sched, fast0, direct0, rank, csA0, **extra):
    """Write a gate's inputs and readings to the .npz file named by the
    environment variable below, when it is set (the two gates' shared
    keys, and `extra`)."""
    dump = os.environ.get("PRISIM_DEBUG_XCHECK_DUMP")
    if dump:
        Mh0, Ml0, pch0, pcl0 = (a[0].cpu().numpy() for a in sched)
        np.savez(dump, fast0=fast0, direct0=direct0, Mh0=Mh0, Ml0=Ml0,
                 pch0=pch0, pcl0=pcl0, freqs=sim.freqs,
                 bl=np.asarray(sim.bls.vectors), rank=rank, csA0=csA0,
                 **extra)


def _banded_gate(parms, sim, plan, snap, sched, verbose, label=""):
    """The shared-amps gate of the banded engine on snapshot 0
    (processing.nufft_crosscheck, on by default): raises _EngineDemotion
    when it fails. `label` ("mesh " on the mesh) goes into its lines."""
    proc = parms["processing"]
    if not proc.get("nufft_crosscheck", True):
        return
    with tracing.span("gate", line=verbose and
                      "banded %sshared-amps gate" % label):
        tol = float(proc.get("nufft_crosscheck_tol") or 2e-6)
        rtol = float(proc.get("nufft_resid_tol") or 1e-4)
        direct0, banded0, ok0, resid0, cs0 = snap.gate_fn(
            *(a[0] for a in sched))
        _dump_gate(sim, sched, banded0, direct0, plan.rank, cs0,
                   resid0=resid0, ok0=ok0, truth_on=snap.truth)
        dmax = float(np.abs(banded0 - direct0).max())
        vmax = float(np.abs(direct0).max())
        # relative to the coherent flux scale max_c sum_s |A_sc| (>= max|V|),
        # which an f32 engine's absolute error scales with; both forms print
        rel = dmax / max(vmax, cs0, 1e-30)
        norms = ("max|dV|/max_c sum_s|A| = %.2e, max|dV|/max|V| = %.2e"
                 % (dmax / max(cs0, 1e-30), dmax / max(vmax, 1e-30)))
        resid_bad = snap.truth and resid0 > rtol
        if not ok0 or rel > tol or resid_bad:
            raise _demote(parms, "banded NUFFT %sshared-amps cross-check "
                          "FAILED (%s; rel=%.2e > %.0e, ok=%s%s)"
                          % (label, norms, rel, tol, ok0,
                             ", model resid=%.2e > %.0e" % (resid0, rtol)
                             if resid_bad else ""))
        if verbose:
            print("[prisim_tpu_torch] banded/direct %sshared-amps cross-check "
                  "ok (%s%s)" % (label, norms, ", truth amps, model resid=%.2e"
                                 % resid0 if snap.truth else ""))


def _simulate_banded(parms, sim, verbose, mesh=None):
    """All accumulations through the banded NUFFT engine, behind its
    shared-amps gate on snapshot 0 (prisim_tpu/driver.py:1214-1318,
    :1346-1500); on a 'bl' `mesh` the gate takes a collapse=False plan
    (the shards' geometry) and simulate_drift_banded_sharded the
    snapshots. A rejected plan, a failed gate or a failed unit-source
    check demotes the run. Returns (T, B, C) complex64."""
    settings = None
    if mesh is not None:
        key = ((parms.get("pp") or {}).get("key") or "").lower()
        if verbose and key != "bl":
            print("[prisim_tpu_torch] banded NUFFT on %d devices: mesh rides "
                  "the 'bl' axis (full band per shard)" % mesh.devices.size)
        settings = _banded_settings(parms, sim)
    try:
        plan, snap = banded_engine(parms, sim, collapse=mesh is None,
                                   settings=settings)
    except PlanRejected as exc:
        raise _demote(parms, "banded NUFFT plan rejected (%s)" % exc)
    amps = ", truth amps" if snap.truth else ""
    if verbose and mesh is None:
        print("[prisim_tpu_torch] banded NUFFT: %d bl -> %d swept rows, "
              "%d directions, rank %d, R_max %d, n_blk max %d, %d source "
              "chunk(s) of %d%s"
              % (plan.nbl_full, plan.nbl, plan.ndir, plan.rank, plan.R_max,
                 plan.n_blk_max, snap.n_chunks, snap.src_chunk, amps))
    elif verbose:
        print("[prisim_tpu_torch] banded NUFFT: %d bl, %d directions, rank "
              "%d, R_max %d, n_blk max %d, on a (%d, 1) 'bl' mesh of %s%s"
              % (plan.nbl, plan.ndir, plan.rank, plan.R_max, plan.n_blk_max,
                 mesh.devices.size,
                 ", ".join(str(d) for d in mesh.devices.flat), amps))
    sched = schedule_tensors(sim.obs, sim.inst.latitude, sim.inst.device)
    _banded_gate(parms, sim, plan, snap, sched, verbose,
                 label="" if mesh is None else "mesh ")
    if mesh is None:
        snaps, oks = [], []
        for t in range(sim.obs.n_acc):
            with tracing.span("snapshot", t=t):
                v, ok = snap(*(a[t] for a in sched))
            snaps.append(v)
            oks.append(ok)
        ok = bool(torch.stack(oks).all())
        vis = torch.stack(snaps) if ok else None
    else:
        from .parallel.mesh import simulate_drift_banded_sharded
        del plan, snap, sched
        rank, node_model, truth, plan_kw = settings
        vis, ok = simulate_drift_banded_sharded(
            sim.inst, sim.sky, sim.obs, sim.beam_fn, mesh, rank=rank,
            node_model=node_model, truth=truth, plan_kw=plan_kw)
    if not ok:
        raise _demote(parms, "banded NUFFT unit-source check failed")
    return vis


def _simulate_sorted(parms, sim, verbose, mesh=None):
    """All accumulations through the delay-space NUFFT with the sorted
    spread (kernel delay_spread on a card), processing.nufft_spread sorted
    or scatter (prisim_tpu/driver.py:1127-1215, :1321-1344, :1502-1545),
    at _nufft_rank's rank; on `mesh` through simulate_drift_nufft_sharded.
    The gate (processing.nufft_crosscheck, on by default): the direct
    engine's snapshot 0 (K1a on a card), run
    before the NUFFT's snapshots, against the NUFFT's snapshot 0 at
    processing.nufft_crosscheck_tol (1e-4 of max|V|, the reference's
    cross-program bar); a failure demotes the run to the direct engine.
    Returns (T, B, C) complex64."""
    proc = parms["processing"]
    freqs = sim.freqs
    rank = _nufft_rank(parms, freqs)
    spread = _nufft_spread(parms)
    sched = schedule_tensors(sim.obs, sim.inst.latitude, sim.inst.device)
    gate = proc.get("nufft_crosscheck", True)
    if gate:
        # the gate's direct snapshot first, with the whole device to itself
        with tracing.span("gate", line=verbose and
                          "NUFFT gate: direct snapshot 0"):
            with tracing.span("beam_flux"):
                seh, sel, amps, _ = snapshot_nudft_inputs(
                    sim.inst, sim.sky, *(a[0] for a in sched), sim.beam_fn)
            coherent = float(amps.double().abs().sum(dim=0).max())
            with tracing.span("k1a"):
                direct0 = direct_visibilities(seh, sel, sim.inst, amps,
                                              sim.src_block).cpu().numpy()
            del seh, sel, amps
    if verbose:
        print("[prisim_tpu_torch] delay-space NUFFT, %s spread: %d bl x %d "
              "ch, rank %d%s" % (spread, sim.inst.nbl, freqs.size, rank,
                                 ", on a %s mesh of %s" % (
                                     mesh.shape, ", ".join(
                                         str(d) for d in mesh.devices.flat))
                                 if mesh is not None else ""))
    with tracing.span("snapshots", line=verbose and "NUFFT snapshots"):
        if mesh is not None:
            from .parallel.mesh import simulate_drift_nufft_sharded
            vis = simulate_drift_nufft_sharded(sim.inst, sim.sky, sim.obs,
                                               sim.beam_fn, mesh, rank=rank)
        else:
            pinvQ, Q = chebyshev_projection(freqs, rank)
            snaps = []
            for t in range(sim.obs.n_acc):
                with tracing.span("snapshot", t=t):
                    snaps.append(simulate_snapshot_nufft_jit(
                        sim.inst, sim.sky, *(a[t] for a in sched),
                        sim.beam_fn, pinvQ, Q, spread=spread))
            vis = torch.stack(snaps)
    if not gate:
        return vis
    tol = float(proc.get("nufft_crosscheck_tol") or 1e-4)
    fast0 = vis[0].cpu().numpy()
    _dump_gate(sim, sched, fast0, direct0, rank, coherent)
    dmax = float(np.abs(fast0 - direct0).max())
    vmax = float(np.abs(direct0).max())
    rel = dmax / max(vmax, 1e-30)
    norms = ("max|dV|/max|V| = %.2e, max|dV|/max_c sum_s|A| = %.2e"
             % (rel, dmax / max(coherent, 1e-30)))
    if rel > tol:
        raise _demote(parms, "NUFFT engine cross-check FAILED (%s; rel=%.2e"
                      " > %.0e)" % (norms, rel, tol))
    if verbose:
        print("[prisim_tpu_torch] NUFFT/direct cross-check ok (%s)" % norms)
    return vis


def _simulate_direct(parms, sim, verbose, mesh=None):
    """All accumulations on the direct engine (K1a, K1b or K1c on a card),
    over `mesh` when one is given (prisim_tpu/driver.py:1567-1597).
    Returns ((T, B, C) complex64, a gradient run's {"baseline":
    (3, nbl, nchan, n_acc)} or None)."""
    if mesh is not None:
        from .parallel.mesh import (simulate_drift_sharded,
                                    simulate_drift_src_sharded)
        if verbose:
            print("[prisim_tpu_torch] direct engine on a %s mesh of %s"
                  % (mesh.shape,
                     ", ".join(str(d) for d in mesh.devices.flat)))
        fn = (simulate_drift_src_sharded if "src" in mesh.axis_names
              else simulate_drift_sharded)
        return fn(sim.inst, sim.sky, sim.obs, sim.beam_fn, mesh,
                  src_block=sim.src_block), None
    grad = bool(parms["processing"].get("gradient_mode"))
    out = simulate_drift(sim.inst, sim.sky, sim.obs, sim.beam_fn,
                         src_block=sim.src_block, gradient=grad)
    if not grad:
        return out, None
    # (T, 3, B, C) -> the reference's (3, nbl, nchan, n_acc)
    return out[0], {"baseline": np.ascontiguousarray(
        np.transpose(out[1].cpu().numpy(), (1, 2, 3, 0)))}


def _simulate_external(parms, sim, verbose):
    """All accumulations with an external HEALPix beam
    (prisim_tpu/driver.py:1017-1085), on the direct engine: the
    frequency-interpolated log table goes to the device once; per
    snapshot the sources are rotated on the device, their (S, 3) float32
    directions fetched, the angular weights computed on the host and
    uploaded, and ExternalBeam.device_evaluate feeds the NUDFT (K1a on a
    card). Returns (T, B, C) complex64."""
    bm = parms.get("beam") or {}
    path = bm["file"]
    ext = (ExternalBeam.from_fits(path) if _fits_beam(path)
           else ExternalBeam.from_hdf5(path))
    dev = sim.inst.device
    logtable = torch.as_tensor(ext.channel_table(
        sim.freqs, chromatic=bool(bm.get("chromatic", True)),
        select_freq=bm.get("select_freq")), device=dev)
    # bound the (4 x chunk, C) float32 gather of device_evaluate to 1 GiB
    chunk = max(1, (1 << 28) // (4 * sim.freqs.size))
    sector = parms.get("_sector")
    if verbose:
        print("[prisim_tpu_torch] external beam %s: nside %d, %d model "
              "frequencies; direct engine" % (path, ext.nside,
                                              ext.freqs.size))
    Mh, Ml, pch, pcl = schedule_tensors(sim.obs, sim.inst.latitude, dev)
    snaps = []
    for t in range(sim.obs.n_acc):
        with tracing.span("snapshot", t=t):
            sh, _ = df_rotate3(Mh[t], Ml[t], sim.sky.s_eq_hi,
                               sim.sky.s_eq_lo)
            altaz = geom.dircos2altaz(np.clip(sh.cpu().numpy().astype(
                np.float64), -1.0, 1.0), xp=np)
            pix, wgt = (torch.as_tensor(x, device=dev)
                        for x in ext.interp_weights(altaz))

            def beam(s, f, pix=pix, wgt=wgt):
                pb = ExternalBeam.device_evaluate(logtable, pix, wgt, chunk)
                if sector is not None:
                    pb = pb * _sector_mask(s, *sector)[:, None]
                return pb

            snaps.append(simulate_snapshot(sim.inst, sim.sky, Mh[t], Ml[t],
                                           pch[t], pcl[t], beam,
                                           src_block=sim.src_block))
    return torch.stack(snaps)


def _noise_generator(parms, device="cpu"):
    """The torch.Generator on `device` of a run's thermal noise, seeded
    from skyparm.seed; a chunk of a chunked run (pp._chunk) seeds it from
    (seed, chunk index), so each chunk draws its own noise and a resumed
    chunk repeats its draw on the same kind of device (JAX folds the index
    into its key, prisim_tpu/driver.py:1735-1738)."""
    seed = int(parms["skyparm"].get("seed") or 0)
    chunk = (parms.get("pp") or {}).get("_chunk")
    if chunk is not None:
        seed = int(np.random.SeedSequence(
            [seed, int(chunk["index"])]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _finalize_on_card(vis_tbc):
    """Whether the finalize of the engine's (T, B, C) cube runs on the
    card: it does for a CUDA cube, whose kernel library is built or loaded
    here (a failed build raises)."""
    if not vis_tbc.is_cuda:
        return False
    cuda_finalize._library()
    return True


def _finalize_simulation(parms, sim, vis_tbc, outdir, verbose, save, device,
                         gradients=None):
    """Noise, gains, container, phasing, projection, optional delay
    transform, save, of the engine's (T, B, C) cube `vis_tbc`. Where
    _finalize_on_card holds, the noise is drawn and the gains applied on
    the card in the cube's order, and kernel phase_cubes re-phases and
    transposes the three cubes (complex128 where a gains file's complex128
    gains made vis so) before their one copy to the host; otherwise all of
    it runs on the host. `gradients` ({"baseline": (3, nbl, nchan, n_acc)}
    or None) goes into the container unphased, as in the reference."""
    tp = parms["telescope"]
    bls, freqs, obs = sim.bls, sim.freqs, sim.obs
    card = _finalize_on_card(vis_tbc)
    dev = vis_tbc.device if card else torch.device("cpu")
    with tracing.span("finalize.noise",
                      line=verbose and "Tsys, rms and noise"):
        tsys = build_tsys(parms, freqs, bls.nbl, obs.n_acc)
        df = float(parms["bandpass"]["freq_resolution"])
        rms = thermal_noise_rms(
            float(tp.get("A_eff") or 154.0), df, float(obs.t_acc[0]),
            tsys, nbl=bls.nbl, nchan=freqs.size, ntimes=obs.n_acc,
            eff_Q=float(tp.get("eff_Q") or 1.0))
        gen = _noise_generator(parms, dev)
        if card:
            noise = generate_noise(gen, torch.as_tensor(
                np.asarray(rms, np.float32), device=dev).permute(
                    2, 0, 1).contiguous())
        else:
            noise = generate_noise(gen, rms).numpy()
    with tracing.span("finalize.post", line=verbose and
                      "gains, container, phasing, projection"):
        tracing.count("finalize.vis", bls.nbl * freqs.size * obs.n_acc)
        gains = 1.0
        if parms["gains"].get("file"):
            gi = GainInfo.read_hdf5(parms["gains"]["file"])
            gains = gi.eval_gains(
                bls.labels, freqs=freqs,
                times=np.asarray(obs.jd) - obs.jd[0],
                kind=parms["gains"].get("interp") or "cubic",
                smoothness=parms["gains"].get("smoothness"))
        if card:
            skyvis = vis_tbc
            if isinstance(gains, np.ndarray):
                gains = torch.as_tensor(gains, device=dev).permute(2, 0, 1)
        else:
            with tracing.span("transfer"):
                skyvis = np.ascontiguousarray(
                    np.transpose(vis_tbc.cpu().numpy(), (1, 2, 0)))
        vis = apply_gains(skyvis, gains, noise)

        bp, bp_wts = _bandpass_weights(parms, bls.nbl, freqs, obs.n_acc)
        vs = VisibilitySet(
            baselines=bls.vectors, labels=bls.labels, freqs=freqs,
            lst=obs.lst_deg, vis_rms=rms, timestamps=obs.jd, t_acc=obs.t_acc,
            bp=bp, bp_wts=bp_wts, Tsys=tsys,
            A_eff=float(tp.get("A_eff") or 154.0),
            eff_Q=float(tp.get("eff_Q") or 1.0),
            latitude=float(tp["latitude"]),
            longitude=float(tp.get("longitude") or 0.0),
            altitude=float(tp.get("altitude") or 0.0),
            pointing_center=obs.pointing_altaz, pointing_coords="altaz",
            phase_center=obs.pointing_altaz.copy(),
            phase_center_coords="altaz",
            telescope=sim.telescope,
            layout=dict(positions=np.asarray(sim.layout.positions),
                        labels=np.asarray(sim.layout.labels, dtype=str),
                        ids=np.arange(len(sim.layout.labels)),
                        coords="ENU"),
            flux_unit="Jy", gradients=gradients,
            blgroups=_blgroups_dict(bls))
        ph = parms.get("phasing") or {}
        center = ph.get("center")
        if center is not None:
            center = np.atleast_2d(np.asarray(center, dtype=np.float64))
        coords = ph.get("coords", "altaz")
        cubes = (skyvis, vis, noise)
        if card:
            path = nu = None
            if center is not None:
                path = torch.as_tensor(np.ascontiguousarray(
                    phase_path(vs, center, coords)), device=dev)
                nu = torch.as_tensor(np.asarray(freqs, np.float64),
                                     device=dev)
            out = cuda_finalize.phase_cubes_cuda(
                *(x.contiguous() for x in cubes), path=path, freqs=nu)
            with tracing.span("transfer"):
                host = out.cpu().numpy()
            del out
            # unphased cubes keep their own dtypes, as on the host
            cubes = [h if center is not None else h.astype(
                np.complex64 if x.dtype == torch.complex64 else np.complex128,
                copy=False) for h, x in zip(host, cubes)]
        vs = dataclasses.replace(vs, **dict(zip(("skyvis", "vis",
                                                 "vis_noise"), cubes)))
        if center is not None:
            vs = (with_phase_center(vs, center, coords) if card
                  else phase_centering(vs, center, coords))
        vs = project_baselines(vs)
        if parms["processing"].get("delay_transform"):
            vs = delay_transform(vs, pad=float(
                parms["processing"].get("f_pad") or 1.0), device=device)
    outpath = None
    if save:
        with tracing.span("write", line=verbose and "products saved"):
            outpath = _save_products(vs, parms, outdir)
    if verbose:
        print("[prisim_tpu_torch] done in %.2f s%s"
              % (tracing.current("simulation").seconds(),
                 (" -> " + outpath) if outpath else ""))
    return vs, outpath


def _write_metadata(obj, path_stem):
    """YAML metadata when pyyaml imports; otherwise the same content as
    JSON (<stem>.json). Returns the path written."""
    try:
        dump_parms(obj, path_stem + ".yaml")
        return path_stem + ".yaml"
    except ImportError:
        with open(path_stem + ".json", "w") as f:
            json.dump(obj, f, indent=2, default=lambda o: (
                o.tolist() if hasattr(o, "tolist") else str(o)))
        return path_stem + ".json"


def _count_written(paths):
    """Add the on-disk sizes of the closed files `paths` to the innermost
    span's counter write.bytes."""
    tracing.count("write.bytes", sum(os.path.getsize(p) for p in paths))


def _save_products(vs, parms, outdir=None):
    """Output directory tree + products + metadata (prisim_tpu/driver.py:
    1793-1868): HDF5 or native FITS (save_formats.fmt), NPZ, UVFITS and
    UVH5 (on the full redundant set with save_redundant), figures
    (plots). The format writers run in the span write.file, the metadata
    in write.meta; each counts the bytes of the files it closed
    (write.bytes), the figures in the caller's span."""
    from .io import save_fits, save_hdf5, save_npz
    ds = parms["dirstruct"]
    if outdir is None:
        simid = ds.get("simid") or time.strftime("sim_%Y%m%d_%H%M%S")
        outdir = os.path.join(ds.get("rootdir") or "./",
                              ds.get("project") or "prisim_tpu_torch", simid)
    os.makedirs(os.path.join(outdir, "simdata"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "metainfo"), exist_ok=True)
    base = os.path.join(outdir, "simdata", "simvis")
    sf = parms["save_formats"]
    fmt = (sf.get("fmt") or "HDF5").lower()
    with tracing.span("write.file", fmt=fmt):
        written = []
        if fmt == "hdf5":
            save_hdf5(vs, base + ".hdf5")
            written.append(base + ".hdf5")
        elif fmt == "fits":
            save_fits(vs, base + ".fits")
            written.append(base + ".fits")
        if sf.get("npz"):
            save_npz(vs, base + ".npz")
            written.append(base + ".npz")
        if sf.get("uvfits") or sf.get("uvh5"):
            vs_uv = vs
            if parms.get("save_redundant") and vs.blgroups:
                vs_uv = _expand_redundant(vs)
            # AIPS code for the simulated feed: X -> -5 (XX), Y -> -6 (YY)
            polcode = (-6,) if str((parms.get("beam") or {}).get("pol")
                                   or "X").upper() == "Y" else (-5,)
            if sf.get("uvfits"):
                from .io.uvfits import save_uvfits
                save_uvfits(vs_uv, base + ".uvfits", pols=polcode)
                written.append(base + ".uvfits")
            if sf.get("uvh5"):
                from .io.uvh5 import save_uvh5
                save_uvh5(vs_uv, base + ".uvh5", pols=polcode)
                written.append(base + ".uvh5")
        _count_written(written)
    if parms.get("plots"):
        try:
            figdir = _save_plots(vs, outdir)
            _count_written(e.path for e in os.scandir(figdir)
                           if e.is_file())
        except Exception as exc:     # diagnostics must never kill a run
            print("[prisim_tpu_torch] plots failed: %s" % exc)
    with tracing.span("write.meta"):
        _count_written([
            _write_metadata(parms, os.path.join(outdir, "metainfo",
                                                "simparms")),
            _write_metadata({"user": os.environ.get("USER", "unknown"),
                             "date": time.strftime("%Y-%m-%dT%H:%M:%S"),
                             "prisim_tpu_torch_version": __version__},
                            os.path.join(outdir, "metainfo", "meta"))])
    return outdir


def _expand_redundant(vs):
    """vs on the full redundant baseline set for the UVData-format exports
    (prisim_tpu/driver.py:1814-1848; the reference duplicates measurements
    before pyuvdata_write, run_prisim.py:2289-2328): every all-pairs
    baseline of the layout takes its unique exemplar's rows. Built only
    when a UV format is asked for: the (nbl x n_unique x 3) float64
    distance array is ~40 GB at HERA-331's 54,615 baselines. On a failure
    it prints why and returns vs (the unique baselines)."""
    try:
        vecs, pairs = baseline_generator(
            np.asarray(vs.layout["positions"], dtype=np.float64),
            labels=np.asarray(vs.layout["labels"], dtype=str))
        uvec, _, _, group_of = uniq_baselines(vecs)
        d = np.linalg.norm(np.asarray(vs.baselines)[:, None, :]
                           - uvec[None, :, :], axis=-1)
        match = d.argmin(axis=1)
        inv = np.full(uvec.shape[0], -1)
        inv[match] = np.arange(match.size)
        expand = inv[group_of]
        if not np.all(expand >= 0):
            return vs
        kw = {n: np.asarray(getattr(vs, n))[expand]
              for n in ("skyvis", "vis", "vis_noise", "vis_rms", "bp",
                        "bp_wts", "Tsys")
              if getattr(vs, n) is not None}
        return project_baselines(dataclasses.replace(
            vs, baselines=vecs, labels=pairs, projected_baselines=None,
            **kw))
    except Exception as exc:
        print("[prisim_tpu_torch] save_redundant expansion failed (%s); "
              "writing unique baselines" % exc)
        return vs


def _save_plots(vs, outdir):
    """Diagnostic figures under <outdir>/figures/ (the 'plots' flag,
    prisim_tpu/driver.py:1871-1920): amplitude waterfalls for the
    shortest/median/longest baseline, amplitude vs baseline length, and a
    delay-spectrum waterfall when lags are present. matplotlib is
    imported here."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    figdir = os.path.join(outdir, "figures")
    os.makedirs(figdir, exist_ok=True)
    cube = np.asarray(vs.vis if vs.vis is not None else vs.skyvis)
    lens = vs.baseline_lengths
    order = np.argsort(lens)
    picks = [order[0], order[order.size // 2], order[-1]]
    fig, axes = plt.subplots(1, len(picks), figsize=(4 * len(picks), 3),
                             squeeze=False)
    for ax, b in zip(axes[0], picks):
        im = ax.imshow(np.abs(cube[b]).T, aspect="auto", origin="lower",
                       extent=[vs.freqs[0] / 1e6, vs.freqs[-1] / 1e6,
                               0, cube.shape[2]])
        ax.set_title("|V| bl %.1f m" % lens[b])
        ax.set_xlabel("freq [MHz]")
        ax.set_ylabel("accumulation")
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(os.path.join(figdir, "vis_waterfall.png"), dpi=100)
    plt.close(fig)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.semilogy(lens, np.abs(cube).mean(axis=(1, 2)), ".")
    ax.set_xlabel("baseline length [m]")
    ax.set_ylabel("mean |V| [Jy]")
    fig.tight_layout()
    fig.savefig(os.path.join(figdir, "amp_vs_baseline.png"), dpi=100)
    plt.close(fig)
    if vs.lags is not None and vs.skyvis_lag is not None:
        lag = np.asarray(vs.skyvis_lag)
        fig, ax = plt.subplots(figsize=(5, 3.5))
        im = ax.imshow(np.log10(np.abs(lag[:, :, 0]) + 1e-12),
                       aspect="auto", origin="lower",
                       extent=[vs.lags[0] * 1e6, vs.lags[-1] * 1e6,
                               0, lag.shape[0]])
        ax.set_xlabel("delay [us]")
        ax.set_ylabel("baseline index")
        fig.colorbar(im, ax=ax, label="log10 |V(tau)|")
        fig.tight_layout()
        fig.savefig(os.path.join(figdir, "delay_waterfall.png"), dpi=100)
        plt.close(fig)
    return figdir


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="prisim_tpu_torch simulation driver")
    p.add_argument("-i", "--infile", required=True,
                   help="YAML simulation parameters")
    p.add_argument("-o", "--outdir", default=None)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the CUDA kernels; raises without a card) "
                        "or 'cpu' (their plain versions)")
    args = p.parse_args(argv)
    parms = load_parms(args.infile)
    run = (run_simulation_chunked
           if int((parms.get("pp") or {}).get("n_chunks") or 1) > 1
           else run_simulation)
    run(parms, outdir=args.outdir, verbose=not args.quiet,
        device=args.device)


def run_simulation_chunked(parms, outdir=None, verbose=True, device="cuda",
                           devices=None):
    """Chunked execution with checkpoint/resume (prisim_tpu/driver.py:
    1944-2030).

    The reference writes per-chunk ``simdata/_part_N`` files and
    concatenates on rank 0 (run_prisim.py:1995, 2224-2287), which doubles
    as crash recovery. Here: split the run along pp.key ('freq': the
    channel axis, otherwise the accumulation axis) into pp.n_chunks
    pieces, simulate each on `device` to ``simdata/_part_<i>.npz`` (a
    lossless NPZ, io.parts) - skipping parts that already exist (resume) -
    then concatenate, redo the delay transform when
    processing.delay_transform asks for it, save the final products,
    record metainfo/chunkinfo (YAML, or JSON without pyyaml) and apply
    processing.cleanup (>= 1 removes the part files). `devices` as in
    run_simulation: each chunk runs on them. Returns (VisibilitySet,
    output_dir)."""
    from .io.parts import load_part_npz, save_part_npz
    from .vis import concatenate
    if not isinstance(parms, dict) or "telescope" not in parms:
        parms = load_parms(parms)
    pp = parms.get("pp") or {}
    n_chunks = int(pp.get("n_chunks") or 1)
    if n_chunks <= 1:
        return run_simulation(parms, outdir=outdir, verbose=verbose,
                              device=device, devices=devices)
    devs = resolve_devices(device, devices)
    dev = devs[0]
    ds = parms["dirstruct"]
    if outdir is None:
        simid = ds.get("simid") or time.strftime("sim_%Y%m%d_%H%M%S")
        outdir = os.path.join(ds.get("rootdir") or "./",
                              ds.get("project") or "prisim_tpu_torch", simid)
    os.makedirs(os.path.join(outdir, "simdata"), exist_ok=True)
    key = (pp.get("key") or "freq").lower()
    axis = 1 if key == "freq" else 2
    if axis == 1:
        edges = np.linspace(0, int(parms["bandpass"]["nchan"]),
                            n_chunks + 1).astype(int)
    else:
        edges = np.linspace(0, int(parms["obsparm"]["n_acc"]),
                            n_chunks + 1).astype(int)
    parts = []
    for i in range(n_chunks):
        part_path = os.path.join(outdir, "simdata", "_part_%d.npz" % i)
        if os.path.exists(part_path):
            if verbose:
                print("[prisim_tpu_torch] resume: part %d exists, skipping"
                      % i)
            parts.append(part_path)
            continue
        p2 = copy.deepcopy(parms)
        p2["pp"]["n_chunks"] = 1
        p2["pp"]["_chunk"] = {
            "index": i, "axis": axis,
            "chan0": int(edges[i]) if axis == 1 else 0,
            "nchan_total": int(parms["bandpass"]["nchan"])}
        if axis == 1:
            nchan = int(parms["bandpass"]["nchan"])
            df = float(parms["bandpass"]["freq_resolution"])
            f_center = float(parms["bandpass"]["freq"])
            f_lo = f_center + df * (-nchan / 2)
            nloc = int(edges[i + 1] - edges[i])
            p2["bandpass"]["nchan"] = nloc
            p2["bandpass"]["freq"] = f_lo + df * (edges[i] + nloc / 2)
        else:
            n_acc = int(parms["obsparm"]["n_acc"])
            p2["obsparm"]["n_acc"] = n_acc     # schedule then pick
            p2["snapshot"]["pick"] = list(range(int(edges[i]),
                                                int(edges[i + 1])))
            p2["snapshot"]["all"] = False
        vs_i, _ = run_simulation(p2, verbose=False, save=False, devices=devs)
        if not isinstance(vs_i, VisibilitySet):
            raise ValueError("chunked runs take one single-polarization "
                             "run without sky sectors")
        save_part_npz(vs_i, part_path)
        parts.append(part_path)
        if verbose:
            print("[prisim_tpu_torch] chunk %d/%d -> %s"
                  % (i + 1, n_chunks, part_path))
    vs = concatenate([load_part_npz(p) for p in parts], axis)
    if parms["processing"].get("delay_transform"):
        # lag-domain products were dropped by concatenate (partial-band
        # spectra are invalid); recompute over the merged band
        vs = delay_transform(vs, pad=float(
            parms["processing"].get("f_pad") or 1.0), device=dev)
    outpath = _save_products(vs, parms, outdir)
    # record the decomposition (run_prisim.py:1793-1801 chunkinfo.yaml)
    os.makedirs(os.path.join(outpath, "metainfo"), exist_ok=True)
    _write_metadata({"key": key, "n_chunks": n_chunks,
                     "chunk_edges": [int(e) for e in edges],
                     "parts": [os.path.basename(p) for p in parts]},
                    os.path.join(outpath, "metainfo", "chunkinfo"))
    cleanup = int(parms["processing"].get("cleanup") or 0)
    if cleanup >= 1:
        for p in parts:
            os.remove(p)
    return vs, outpath


if __name__ == "__main__":
    main()
