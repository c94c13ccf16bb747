"""Post-simulation tooling: the reference's scripts/ CLI surface.

Counterpart of prisim_tpu/tools.py (PRISim's scripts/):
* ``convert``   - write_PRISim_visibilities.py / prisim_to_uvfits.py:
  re-save a sim to HDF5/NPZ/UVFITS/UVH5, optional re-phasing.
* ``update-noise`` - update_PRISim_noise.py: regenerate thermal noise
  with new Tsys/A_eff and rewrite vis = skyvis + noise.
* ``replicate`` - replicate_sim.py + scriptUtils/replicatesim_util.py:
  Monte-Carlo noise realizations of an existing sim -> NPZ/UVFITS.
* ``redundant`` - make_redundant_visibilities.py: expand unique-baseline
  vis onto the full redundant set (duplicate_measurements).
* ``ls`` / ``grep`` - prisim_ls.py / prisim_grep.py: list sims in a
  project with parameter diffs; query sims by parameter values.
* ``feko2hpx``  - FEKO_beam_to_healpix.py: far-field text beams ->
  HEALPix maps.
* ``delay-ps``, ``closure-npz``, ``xcpdps`` - delay power spectra (with
  delay CLEAN), closure phases to the HERA NPZ layout, closure-phase delay
  cross power spectra.
* ``gsm``, ``plot``, ``mesh-check`` - Global Sky Model maps (needs
  pygsm/pygdsm), the driver's figures of a saved sim, a device-mesh check
  and weak-scaling bench.

CLI: ``python -m prisim_tpu_torch.tools <command> ...`` (or the
``prisim-tpu-torch-tools`` script); the commands that compute on tensors
take ``--device`` ('cuda', the default, raises without a card, or 'cpu').

Products are read by ``_load_any`` (native HDF5, UVH5, the native FITS
product, NPZ). The sims that ``update_noise`` and
``expand_redundant_file`` write, and the beams of ``feko_to_healpix``, go
out by the output's suffix: ``.fits`` the native FITS product (a HEALPix
image with a FREQS extension for a beam, as ExternalBeam.from_fits reads
it), ``.npz`` NPZ, anything else HDF5 as in the reference (h5py). Noise is
drawn with torch.Generator (ROADMAP R4): ``update_noise`` seeds it with
manual_seed(seed), ``replicate`` realization i from
np.random.SeedSequence([seed, i]). ``delay_ps`` and ``xcpdps`` write with
io.dicth5 (h5py); with outfile=None they write nothing and return the
product dict. A path that needs h5py (or pyyaml) where it is missing
raises ImportError before any compute.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from . import healpix as hp

__all__ = ["convert", "update_noise", "replicate", "expand_redundant_file",
           "list_sims", "grep_sims", "feko_to_healpix", "delay_ps",
           "closure_npz", "xcpdps", "plot_sim", "main"]


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


def _writable(outfile, hint="pass outfile=None to get the product dict "
                            "only"):
    """Raise ImportError, before any compute, when `outfile` is a path
    and h5py (which writes it) is missing."""
    if outfile is not None:
        from .io.hdf5 import h5py
        if h5py is None:
            raise ImportError("writing %s needs h5py; %s" % (outfile, hint))


def _is_fits(path):
    return str(path).endswith(".fits") and not str(path).endswith(".uvfits")


def _product_writer(path):
    """writer(vs, path) of a sim product by the suffix of `path`: the native
    FITS product, NPZ, or HDF5 (ImportError here without h5py)."""
    from .io import save_fits, save_hdf5, save_npz
    if _is_fits(path):
        return save_fits
    if str(path).endswith(".npz"):
        return save_npz
    _writable(path, "give a .fits or .npz path")
    return lambda vs, p: save_hdf5(vs, p, overwrite=True)


def convert(infile, outfile, formats=("hdf5",), phase_center=None,
            phase_center_coords="altaz", datatype="noiseless"):
    """Load a sim and re-save it in the requested formats (hdf5, npz,
    uvfits, uvh5) (write_PRISim_visibilities.py:9-117)."""
    from .io import save_hdf5, save_npz
    from .vis import phase_centering
    formats = [f.lower() for f in formats]
    for fmt in formats:
        if fmt not in ("hdf5", "npz", "uvfits", "uvh5"):
            raise ValueError("unknown format %r" % fmt)
        if fmt in ("hdf5", "uvh5"):
            _writable(outfile + "." + fmt, "choose npz or uvfits")
    vs = _load_any(infile)
    if phase_center is not None:
        vs = phase_centering(vs, np.atleast_2d(np.asarray(
            phase_center, dtype=np.float64)), phase_center_coords)
    written = []
    for fmt in formats:
        path = outfile + "." + fmt
        if fmt == "hdf5":
            save_hdf5(vs, path)
        elif fmt == "npz":
            save_npz(vs, path)
        elif fmt == "uvfits":
            from .io.uvfits import save_uvfits
            save_uvfits(vs, path, datatype=datatype)
        else:
            from .io.uvh5 import save_uvh5
            save_uvh5(vs, path, datatype=datatype)
        written.append(path)
    return written


def _noise_rms(vs):
    """The radiometer rms of a sim's Tsys, A_eff and eff_Q (host numpy)."""
    from .engine.noise import thermal_noise_rms
    dt = float(vs.t_acc[0]) if vs.t_acc is not None else 1.0
    return np.asarray(thermal_noise_rms(
        vs.A_eff, vs.freq_resolution, dt, vs.Tsys, nbl=vs.nbl,
        nchan=vs.nchan, ntimes=vs.n_acc, eff_Q=vs.eff_Q))


def update_noise(infile, outfile=None, Tsys=None, A_eff=None, eff_Q=None,
                 seed=0, device="cuda"):
    """Regenerate thermal noise on an existing sim
    (update_PRISim_noise.py:110-131), drawn on `device` with a
    torch.Generator seeded manual_seed(seed). Returns the updated
    VisibilitySet, written to outfile (or back to infile) by its suffix."""
    from .driver import resolve_device
    from .engine.noise import generate_noise
    dev = resolve_device(device)
    write = _product_writer(outfile or infile)
    vs = _load_any(infile)
    if Tsys is not None:
        vs.Tsys = np.broadcast_to(
            np.asarray(Tsys, dtype=np.float64),
            (vs.nbl, vs.nchan, vs.n_acc)).copy()
    if A_eff is not None:
        vs.A_eff = float(A_eff)
    if eff_Q is not None:
        vs.eff_Q = float(eff_Q)
    if vs.Tsys is None:
        raise ValueError("no Tsys available to generate noise")
    rms = _noise_rms(vs)
    noise = generate_noise(torch.Generator(device=dev).manual_seed(
        int(seed)), rms).cpu().numpy()
    vs.vis_rms = rms
    vs.vis_noise = noise
    vs.vis = vs.skyvis + noise
    write(vs, outfile or infile)
    return vs


def replicate(infile, outfile_prefix, n_realize=4, seed=100, fmt="npz",
              device="cuda"):
    """Monte-Carlo noise realizations
    (scriptUtils/replicatesim_util.py:10-123): n_realize noise cubes
    scaled by the stored (or derived) rms, realization i drawn on `device`
    with a torch.Generator seeded from np.random.SeedSequence([seed, i]);
    one NPZ with all realizations (the reference's keys) or one UVFITS per
    realization."""
    from .driver import resolve_device
    from .engine.noise import generate_noise
    dev = resolve_device(device)
    if fmt not in ("npz", "uvfits"):
        raise ValueError("fmt must be 'npz' or 'uvfits'")
    vs = _load_any(infile)
    if vs.vis_rms is not None:
        rms = np.asarray(vs.vis_rms)
    elif vs.Tsys is not None:
        rms = _noise_rms(vs)
    else:
        raise ValueError("sim carries neither vis_rms nor Tsys")
    seeds = [int(np.random.SeedSequence([int(seed), i]).generate_state(
        1, np.uint64)[0]) for i in range(n_realize)]
    noises = np.stack([generate_noise(
        torch.Generator(device=dev).manual_seed(s), rms).cpu().numpy()
        for s in seeds])
    vises = vs.skyvis[None] + noises
    written = []
    if fmt == "npz":
        path = outfile_prefix + ".npz"
        np.savez_compressed(path, skyvis=vs.skyvis, vis=vises,
                            noise=noises, freqs=vs.freqs, lst=vs.lst,
                            bl=vs.baselines)
        written.append(path)
    else:
        import dataclasses
        from .io.uvfits import save_uvfits
        for i in range(n_realize):
            v2 = dataclasses.replace(vs, vis=vises[i], vis_noise=noises[i])
            path = "%s_%d.uvfits" % (outfile_prefix, i)
            save_uvfits(v2, path, datatype="noisy")
            written.append(path)
    return written


def expand_redundant_file(infile, outfile):
    """Expand a unique-baseline sim onto all redundant baselines using
    the stored antenna layout (make_redundant_visibilities.py;
    duplicate_measurements at interferometry.py:6823). The sim is read by
    _load_any and written by the suffix of `outfile`."""
    import dataclasses
    from .baselines import baseline_generator, uniq_baselines
    write = _product_writer(outfile)
    vs = _load_any(infile)
    if vs.layout is None:
        raise ValueError("sim has no antenna layout; cannot expand")
    vectors, label_pairs = baseline_generator(
        np.asarray(vs.layout["positions"], dtype=np.float64),
        labels=np.asarray(vs.layout["labels"], dtype=str))
    uvec, ind, counts, group_of = uniq_baselines(vectors)
    # match saved unique baselines to the recomputed unique set
    d = np.linalg.norm(np.asarray(vs.baselines)[:, None, :]
                       - uvec[None, :, :], axis=-1)
    match = d.argmin(axis=1)
    if not np.allclose(d[np.arange(match.size), match], 0.0, atol=1e-6):
        raise ValueError("saved baselines do not match layout's unique "
                         "baseline set")
    inv = np.full(uvec.shape[0], -1)
    inv[match] = np.arange(match.size)
    expand = inv[group_of]
    if np.any(expand < 0):
        raise ValueError("some redundant groups missing from saved sim")
    kw = {}
    for name in ("skyvis", "vis", "vis_noise", "vis_rms", "bp",
                 "bp_wts", "Tsys"):
        arr = getattr(vs, name)
        if arr is not None:
            kw[name] = np.asarray(arr)[expand]
    out = dataclasses.replace(
        vs, baselines=vectors, labels=label_pairs,
        projected_baselines=None, **kw)
    write(out, outfile)
    return out


def _load_meta(simdir):
    """A sim's parameters: metainfo/simparms.yaml (needs pyyaml), else the
    simparms.json that the driver writes where pyyaml is missing; None for
    a directory with neither."""
    base = os.path.join(simdir, "metainfo", "simparms")
    have_yaml = os.path.exists(base + ".yaml")
    if have_yaml:
        try:
            import yaml
        except ImportError:
            yaml = None
        if yaml is not None:
            with open(base + ".yaml") as f:
                return yaml.safe_load(f)
    if os.path.exists(base + ".json"):
        with open(base + ".json") as f:
            return json.load(f)
    if have_yaml:
        raise ImportError("reading %s.yaml needs pyyaml" % base)
    return None


def _flatten(d, prefix=""):
    out = {}
    for k, v in (d or {}).items():
        key = prefix + str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def list_sims(project_dir, diff=True):
    """List sims under a project dir; with diff=True, report only the
    parameters that differ across sims (prisim_ls.py)."""
    sims = {}
    for simdir in sorted(glob.glob(os.path.join(project_dir, "*"))):
        meta = _load_meta(simdir)
        if meta is not None:
            sims[os.path.basename(simdir)] = _flatten(meta)
    if not diff or len(sims) < 2:
        return {"sims": sorted(sims), "diffs": {}}
    keys = sorted(set().union(*[set(v) for v in sims.values()]))
    diffs = {}
    for key in keys:
        vals = {name: sims[name].get(key) for name in sims}
        if len({repr(v) for v in vals.values()}) > 1:
            diffs[key] = vals
    return {"sims": sorted(sims), "diffs": diffs}


def grep_sims(project_dir, **param_values):
    """Sims whose parameters match all given dotted-key values
    (prisim_grep.py:45-66). Example: grep_sims(d, **{
    'array.layout': 'HERA-19'})."""
    hits = []
    for simdir in sorted(glob.glob(os.path.join(project_dir, "*"))):
        meta = _load_meta(simdir)
        if meta is None:
            continue
        flat = _flatten(meta)
        if all(repr(flat.get(k)) == repr(v)
               for k, v in param_values.items()):
            hits.append(os.path.basename(simdir))
    return hits


def read_feko(infile):
    """Parse a FEKO far-field text export with per-frequency blocks.

    The format (FEKO_beam_to_healpix.py:14-48): '#Frequency: <Hz>'
    starts a block, '... Theta Samples: N' / '... Phi Samples: N'
    declare the grid, data rows are 'theta phi ... gain_dB' with the
    gain in the LAST column. Phi is rotated by +90 deg into the
    HEALPix spherical convention (same as the reference).

    Returns (freqs (F,), theta_deg (T,), phi_deg (P,),
             gain_db (F, T, P)) for gridded data, where theta/phi are
    the regular grid axes. Raises ValueError if no frequency blocks
    are found (caller falls back to the generic table path)."""
    freqs, gaindb = [], []
    theta_list, phi_list = [], []
    ntheta = nphi = None
    with open(infile) as f:
        for ln in f:
            words = ln.split()
            if "Frequency" in ln and words:
                freqs.append(float(words[-1]))
                gaindb.append([])
                continue
            if ntheta is None and "Theta Samples" in ln:
                ntheta = int(float(words[-1]))
                continue
            if nphi is None and "Phi Samples" in ln:
                nphi = int(float(words[-1]))
                continue
            if not words or ln[0] in "#*\"":
                continue
            try:
                row = [float(x) for x in words]
            except ValueError:
                continue
            if not freqs:
                continue
            gaindb[-1].append(row[-1])
            if len(gaindb) == 1:
                theta_list.append(row[0])
                phi_list.append(row[1])
    if not freqs:
        raise ValueError(f"no FEKO frequency blocks in {infile}")
    theta_list = np.asarray(theta_list)
    phi_list = np.asarray(phi_list) + 90.0   # HEALPix phi convention
    gaindb = np.asarray(gaindb, dtype=np.float64)
    if ntheta is None or nphi is None:
        ntheta = np.unique(theta_list).size
        nphi = np.unique(phi_list).size
    theta = np.linspace(theta_list.min(), theta_list.max(), ntheta)
    phi = np.linspace(phi_list.min(), phi_list.max(), nphi)
    # rows iterate theta fastest within each phi column
    # (reference: reshape(F, nphi, ntheta) -> transpose to (F, T, P))
    gaindb = np.transpose(gaindb.reshape(len(freqs), nphi, ntheta),
                          (0, 2, 1))
    return np.asarray(freqs), theta, phi, gaindb


def _feko_spline_map(theta_deg, phi_deg, gain_db, nside):
    """One frequency -> HEALPix map by bivariate spline on the gridded
    dB beam (FEKO_beam_to_healpix.py:80-127). Phi is handled
    periodically by wrap-padding the grid one full turn on each side
    (equivalent to the reference's three-branch boundary evaluation).
    Out-of-theta-range pixels get zero power (below the sampled
    hemisphere). Returns peak-normalized POWER (npix,)."""
    from scipy.interpolate import RectBivariateSpline
    th = np.radians(theta_deg)
    ph = np.radians(phi_deg)
    # grids that close the circle (last col == first col + 2pi) would
    # produce duplicate knots under wrap-padding: drop the closing col
    if ph[-1] - ph[0] >= 2 * np.pi - 1e-9:
        ph = ph[:-1]
        gain_db = gain_db[:, :-1]
    # periodic wrap-pad in phi: copy the grid shifted by +-2pi
    ph_ext = np.concatenate([ph - 2 * np.pi, ph, ph + 2 * np.pi])
    g_ext = np.concatenate([gain_db] * 3, axis=1)
    spl = RectBivariateSpline(th, ph_ext, g_ext, kx=3, ky=3)
    npix = hp.nside2npix(nside)
    pt, pp = hp.pix2ang(nside, np.arange(npix))
    # map pixel phi into the padded grid's central period
    pp = ph[0] + np.mod(pp - ph[0], 2 * np.pi)
    hmap_db = np.full(npix, -np.inf)
    inb = (pt >= th.min()) & (pt <= th.max())
    hmap_db[inb] = spl.ev(pt[inb], pp[inb])
    hmap_db -= hmap_db[inb].max()
    out = np.zeros(npix)
    out[inb] = 10.0 ** (hmap_db[inb] / 10.0)
    return out


def _feko_scatter_map(theta, phi, power, nside, interp):
    """One frequency of scattered (theta, phi, power) samples ->
    HEALPix map: 'healpix' = 4-neighbor bilinear weights binned per
    pixel (FEKO_beam_to_healpix.py:139-146), 'nearest' = per-pixel
    nearest sample. Returns peak-normalized power (npix,)."""
    npix = hp.nside2npix(nside)
    if interp == "healpix":
        pix, wts = hp.get_interp_weights(nside, theta, phi)
        wmap = np.bincount(pix.ravel(), weights=wts.ravel(),
                           minlength=npix)
        hmap = np.bincount(pix.ravel(),
                           weights=(wts * power[None, :]).ravel(),
                           minlength=npix)
        good = wmap > 1e-12
        hmap[good] /= wmap[good]
        hmap[~good] = 0.0
    else:
        pix_t, pix_p = hp.pix2ang(nside, np.arange(npix))
        vt = np.stack([np.sin(pix_t) * np.cos(pix_p),
                       np.sin(pix_t) * np.sin(pix_p),
                       np.cos(pix_t)], axis=-1)
        vs_ = np.stack([np.sin(theta) * np.cos(phi),
                        np.sin(theta) * np.sin(phi),
                        np.cos(theta)], axis=-1)
        best = np.empty(npix, dtype=np.int64)
        chunk = 4096
        for lo in range(0, npix, chunk):
            dots = vt[lo:lo + chunk] @ vs_.T
            best[lo:lo + chunk] = dots.argmax(axis=1)
        hmap = power[best]
    return hmap / hmap.max()


def gsm_to_npz(outfile, nside=64, freqs=(150e6,), model="gsm2008"):
    """Generate Global Sky Model maps with pygsm/pygdsm and save an npz
    the driver's gsm branch reads (keys: 'maps' (npix, nf) equatorial
    RING brightness-temperature maps in K, 'freqs' Hz).

    Replaces the reference's in-process pygsm sky build
    (run_prisim.py:1253-1279, SM.diffuse_radio_sky_model). pygsm is not
    bundled, so this converter runs wherever pygsm IS installed, and the
    npz is shipped; nothing is fetched. The galactic->equatorial
    reprojection uses this package's own HEALPix bilinear interpolation
    (no healpy)."""
    try:
        try:
            from pygdsm import GlobalSkyModel, GlobalSkyModel2016
        except ImportError:
            from pygsm import GlobalSkyModel, GlobalSkyModel2016
    except ImportError:
        raise RuntimeError(
            "pygsm/pygdsm is not installed in this environment. Run "
            "`python -m prisim_tpu_torch.tools gsm` on a machine that has "
            "it, then point catalog.spectrum_file at the npz.")
    gsm = GlobalSkyModel2016() if model == "gsm2016" else \
        GlobalSkyModel()
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    # J2000 equatorial -> galactic rotation (IAU 1958 pole/zero-point)
    ra = phi
    dec = np.pi / 2 - theta
    v_eq = np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                     np.sin(dec)], axis=-1)
    v_gal = v_eq @ _EQ2GAL.T
    th_g = np.arccos(np.clip(v_gal[:, 2], -1.0, 1.0))
    ph_g = np.mod(np.arctan2(v_gal[:, 1], v_gal[:, 0]), 2 * np.pi)
    maps = np.empty((npix, freqs.size), dtype=np.float64)
    for i, f in enumerate(freqs):
        g = np.asarray(gsm.generate(f / 1e6), dtype=np.float64)
        maps[:, i] = hp.interp_map(g, th_g, ph_g)
    np.savez(outfile, maps=maps, freqs=freqs)
    return outfile


# rows: galactic x,y,z in equatorial J2000 coordinates (the standard
# NGP ra=192.85948 dec=27.12825, l_omega=32.93192 rotation)
_EQ2GAL = np.array(
    [[-0.0548755604, -0.8734370902, -0.4838350155],
     [+0.4941094279, -0.4448296300, +0.7469822445],
     [-0.8676661490, -0.1980763734, +0.4559837762]])


def _write_beam(outfile, maps, freqs, nside, scheme, interp, source, pols):
    """A HEALPix beam by the suffix of `outfile`: FITS (maps (npix, nfreq)
    as the primary image with NSIDE/ORDERING/INTERP/SOURCE cards, the
    model frequencies as the FREQS image, each extra polarization as an
    image named after it: the layout ExternalBeam.from_fits reads), NPZ
    (the HDF5 layout's names as keys), or the reference's HDF5."""
    if _is_fits(outfile):
        from .io.fitsio import card, write_image
        with open(outfile, "wb") as fh:
            write_image(fh, maps, primary=True, extra_cards=[
                card("NSIDE", int(nside)), card("ORDERING", scheme.upper()),
                card("INTERP", interp), card("SOURCE", source)])
            write_image(fh, np.asarray(freqs, np.float64), extname="FREQS")
            for name, pm in pols.items():
                write_image(fh, pm, extname=name)
    elif str(outfile).endswith(".npz"):
        np.savez(outfile, beam=maps, freqs=freqs, nside=nside, scheme=scheme,
                 interp=interp, source=source,
                 **{"pols/" + k: v for k, v in pols.items()})
    else:
        import h5py
        with h5py.File(outfile, "w") as f:
            f["beam"] = maps
            f["beam"].attrs["nside"] = nside
            f["beam"].attrs["scheme"] = scheme
            f["beam"].attrs["interp"] = interp
            f["freqs"] = freqs
            f["freqs"].attrs["units"] = "Hz"
            f["source"] = source
            for name, pm in pols.items():
                f["pols/" + name] = pm


def feko_to_healpix(infile, outfile, nside=64, scheme="ring",
                    interp="spline", col_theta=0, col_phi=1,
                    col_gain_db=None, col_etheta=(2, 3),
                    col_ephi=(4, 5), extra_pol_files=()):
    """Convert FEKO far-field text beams to a chromatic HEALPix beam
    (FEKO_beam_to_healpix.py:14-283), written by the suffix of `outfile`
    (.fits, .npz, else HDF5 as the reference writes it).

    Native FEKO exports (per-frequency '#Frequency:' blocks, gain dB
    in the last column) are parsed with all frequency blocks stacked
    into a (npix, nfreq) chromatic beam; `interp` picks 'spline'
    (bivariate spline on the gridded dB map, the reference default),
    'healpix' (bilinear pixel weights), or 'nearest'. Plain tables
    (theta phi Re/Im field components or an explicit gain column, no
    block headers) fall back to a single-map nearest/healpix path.
    `extra_pol_files` adds more polarizations, stored as 'P<i>' (the
    reference's P1/P2 pair). Returns the (npix, nfreq) maps."""
    if not (_is_fits(outfile) or str(outfile).endswith(".npz")):
        _writable(outfile, "give a .fits or .npz path")
    try:
        freqs, theta, phi, gaindb = read_feko(infile)
        is_feko = True
    except ValueError:
        is_feko = False
    if is_feko:
        if interp == "spline":
            maps = np.stack([_feko_spline_map(theta, phi, gaindb[i],
                                              nside)
                             for i in range(freqs.size)], axis=-1)
        else:
            pt = np.radians(np.repeat(theta, phi.size))
            pp = np.radians(np.tile(phi, theta.size))
            maps = np.stack(
                [_feko_scatter_map(pt, pp,
                                   10.0 ** (gaindb[i].ravel() / 10.0),
                                   nside, interp)
                 for i in range(freqs.size)], axis=-1)
    else:
        # generic table: no FEKO blocks; single (achromatic) map
        rows = []
        with open(infile) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith(("#", "*", '"')):
                    continue
                try:
                    rows.append([float(x) for x in ln.split()])
                except ValueError:
                    continue
        data = np.asarray(rows)
        theta_s = np.radians(data[:, col_theta])
        phi_s = np.radians(data[:, col_phi])
        if col_gain_db is not None:
            power = 10.0 ** (data[:, col_gain_db] / 10.0)
        else:
            et = data[:, col_etheta[0]] + 1j * data[:, col_etheta[1]]
            ep = data[:, col_ephi[0]] + 1j * data[:, col_ephi[1]]
            power = np.abs(et) ** 2 + np.abs(ep) ** 2
        itp = interp if interp in ("healpix", "nearest") else "nearest"
        maps = _feko_scatter_map(theta_s, phi_s, power, nside,
                                 itp)[:, None]
        freqs = np.asarray([150e6])
    pols = {}
    for i, pf in enumerate(extra_pol_files):
        pfreqs, pth, pph, pdb = read_feko(pf)
        pols["P%d" % (i + 2)] = np.stack(
            [_feko_spline_map(pth, pph, pdb[j], nside)
             for j in range(pfreqs.size)], axis=-1)
    _write_beam(outfile, maps, freqs, nside, scheme, interp,
                os.path.basename(infile), pols)
    return maps


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


def plot_sim(infile, outdir):
    """Regenerate the driver's diagnostic figures from a saved sim
    (driver._save_plots on any file _load_any reads; needs matplotlib)."""
    from .driver import _save_plots
    vs = _load_any(infile)
    os.makedirs(outdir, exist_ok=True)
    # _save_plots writes under <outdir>/figures
    return _save_plots(vs, outdir)


def _mesh_devices(n_devices, device):
    """n_devices mesh entries on `device`: 'cpu' repeated, a 'cuda:k' card
    repeated, or for 'cuda' the visible cards in turn (repeated on a host
    with fewer cards than entries)."""
    from .driver import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev] * int(n_devices)
    n_cards = torch.cuda.device_count()
    return [torch.device("cuda", i % n_cards) for i in range(n_devices)]


def _platform_device(platform, device):
    """The device of mesh-check's --platform: cpu, native (the cards) or
    auto (`device`)."""
    return {"cpu": "cpu", "native": "cuda"}.get(platform, device)


def _sync(devs):
    for d in set(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def mesh_check(n_devices=8, device="cuda"):
    """Multi-device smoke test (the reference's test_mpi4py_for_prisim.py
    analog): an n-shard mesh (parallel.make_mesh) over `device`'s entries
    (_mesh_devices) and one reduction across it: each shard sums its 4
    values of arange(4 n) on its device, and the partials are summed in
    shard order on the first. A mesh that repeats a device checks the
    decomposition, not scaling. Returns whether the sum is right."""
    from .parallel.mesh import make_mesh
    mesh = make_mesh((int(n_devices),), ("bl",),
                     _mesh_devices(n_devices, device))
    devs = list(mesh.devices.flat)
    x = torch.arange(len(devs) * 4, dtype=torch.float64)
    parts = [x[4 * i:4 * i + 4].to(d).sum() for i, d in enumerate(devs)]
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(devs[0])
    got = float(total)
    expect = sum(range(len(devs) * 4))
    ok = abs(got - expect) < 1e-6
    print("mesh of %d x %s devices (%d distinct): psum %s (expected %g, "
          "got %g)" % (len(devs), devs[0].type, len(set(devs)),
                       "OK" if ok else "MISMATCH", expect, got))
    return ok


def mesh_bench(n_devices=8, per_bl=32, nchan=64, nside=16, repeats=3,
               use_pallas=None, platform="auto", device="cuda"):
    """Weak-scaling harness over the sharded drift engine: FIXED
    per-device work (per_bl baselines per device, full sky and band on
    every shard), meshes of 1, 2, 4, ..., n_devices over the 'bl' axis,
    per-device rates as JSON lines (the reference's MPI strong/weak-scaling
    analog: run_prisim.py:1791-1860 bl/freq splits). `platform` cpu runs
    CPU entries, native the cards, auto `device`; on a mesh that repeats
    a device ("distinct_devices" below the mesh size) the shards run one
    after another, so the rates say nothing about scaling. use_pallas is
    checked as in observe.check_kernel_knobs (a CUDA shard runs K1a).

    Returns the list of per-mesh result dicts."""
    import time
    from . import skymodel as sm
    from .beams import airy_beam
    from .engine.observe import Instrument, Observation, SkySources
    from .parallel.mesh import make_mesh, simulate_drift_sharded

    devs = _mesh_devices(n_devices, _platform_device(platform, device))
    sizes = []
    d = 1
    while d <= len(devs):
        sizes.append(d)
        d *= 2
    rng = np.random.default_rng(7)
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    loc = np.stack([np.degrees(phi), 90.0 - np.degrees(theta)],
                   axis=-1)
    nsrc = loc.shape[0]
    model = sm.SkyModel(
        location=loc, spec_kind="power-law", spec_parms={
            "flux-scale": rng.uniform(0.1, 10.0, nsrc),
            "freq-ref": np.full(nsrc, 150e6),
            "power-law-index": np.full(nsrc, -0.8),
            "flux-offset": np.zeros(nsrc)})
    freqs = 100e6 + 97656.25 * np.arange(nchan)
    sky = SkySources.from_skymodel(model, freqs, devs[0])

    def beam_fn(s, f):
        return airy_beam(s, f, 14.0)

    obs = Observation(lst_deg=np.asarray([30.0]),
                      jd=np.asarray([2458000.5]),
                      t_acc=np.asarray([10.0]),
                      pointing_altaz=np.asarray([[90.0, 0.0]]))

    # one big reproducible baseline pool, sliced per mesh size so every
    # device always owns exactly per_bl baselines (weak scaling)
    pool = rng.uniform(-300.0, 300.0, (per_bl * sizes[-1], 3))
    pool[:, 2] = 0.0

    results = []
    base_rate = None
    for nd in sizes:
        nbl = per_bl * nd
        inst = Instrument.build(pool[:nbl], freqs, devs[0], latitude=-30.72)
        mesh = make_mesh((nd,), ("bl",), devs[:nd])

        def run():
            return simulate_drift_sharded(inst, sky, obs, beam_fn, mesh,
                                          use_pallas=use_pallas)

        run()                                     # warm
        _sync(devs[:nd])
        t0 = time.perf_counter()
        for _ in range(repeats):
            run()
        _sync(devs[:nd])
        dt = (time.perf_counter() - t0) / repeats
        gmacs = nsrc * nbl * nchan / dt / 1e9
        per_dev = gmacs / nd
        if base_rate is None:
            base_rate = per_dev
        row = {"devices": nd, "platform": devs[0].type,
               "distinct_devices": len(set(devs[:nd])),
               "nbl": nbl, "nchan": nchan, "nsrc": nsrc,
               "seconds_per_snapshot": round(dt, 4),
               "gmacs_total": round(gmacs, 3),
               "gmacs_per_device": round(per_dev, 3),
               "weak_scaling_efficiency": round(per_dev / base_rate, 3)}
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


def _parser():
    """The CLI's parser: every subcommand and flag of the reference's
    (prisim_tpu/tools.py:841-945), plus --device on the commands that
    compute on tensors."""
    import argparse
    p = argparse.ArgumentParser(prog="prisim_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(sp):
        sp.add_argument("--device", default="cuda",
                        help="'cuda' (raises without a card) or 'cpu'")

    c = sub.add_parser("convert")
    c.add_argument("infile")
    c.add_argument("outfile")
    c.add_argument("--formats", nargs="+", default=["hdf5"])
    c.add_argument("--datatype", default="noiseless")

    u = sub.add_parser("update-noise")
    u.add_argument("infile")
    u.add_argument("-o", "--outfile", default=None)
    u.add_argument("--tsys", type=float, default=None)
    u.add_argument("--a-eff", type=float, default=None)
    u.add_argument("--seed", type=int, default=0)
    device_flag(u)

    r = sub.add_parser("replicate")
    r.add_argument("infile")
    r.add_argument("outprefix")
    r.add_argument("-n", "--n-realize", type=int, default=4)
    r.add_argument("--seed", type=int, default=100)
    r.add_argument("--fmt", default="npz")
    device_flag(r)

    e = sub.add_parser("redundant")
    e.add_argument("infile")
    e.add_argument("outfile")

    ls = sub.add_parser("ls")
    ls.add_argument("project_dir")

    g = sub.add_parser("grep")
    g.add_argument("project_dir")
    g.add_argument("params", nargs="+",
                   help="dotted key=value pairs, e.g. array.layout=HERA-19")

    dp = sub.add_parser("delay-ps")
    dp.add_argument("infile")
    dp.add_argument("outfile")
    dp.add_argument("--pad", type=float, default=1.0)
    dp.add_argument("--nside-beam", type=int, default=32)
    dp.add_argument("--clean", action="store_true")
    dp.add_argument("--subband-centers", type=float, nargs="+")
    dp.add_argument("--subband-bw", type=float, nargs="+")
    device_flag(dp)

    cn = sub.add_parser("closure-npz")
    cn.add_argument("infile")
    cn.add_argument("outfile")
    cn.add_argument("--datatype", default="vis")

    xp = sub.add_parser("xcpdps")
    xp.add_argument("infile")
    xp.add_argument("outfile")
    xp.add_argument("--freq-center", type=float, nargs="+")
    xp.add_argument("--bw-eff", type=float, nargs="+")
    xp.add_argument("--pad", type=float, default=1.0)
    xp.add_argument("--lstbin", type=float)
    xp.add_argument("--ndaybins", type=int, default=2)
    xp.add_argument("--num-kbins", type=int)
    xp.add_argument("--errinfo", action="store_true")
    xp.add_argument("--rescale-vis")
    xp.add_argument("--rescale-triad", nargs=3)
    xp.add_argument("--cohax", type=int, nargs="+",
                    help="axes averaged coherently (1=lst 2=days 3=triads)")
    xp.add_argument("--incohax", type=int, nargs="+",
                    help="axes cross-multiplied incoherently")
    xp.add_argument("--collapse-axes", type=int, nargs="+",
                    help="incoherent axes collapsed onto covariance "
                         "diagonals")
    xp.add_argument("--avgcov", action="store_true")
    xp.add_argument("--lst-shifts", type=int, nargs="+")

    pl = sub.add_parser("plot")
    pl.add_argument("infile")
    pl.add_argument("outdir")

    m = sub.add_parser("mesh-check")
    m.add_argument("-n", "--n-devices", type=int, default=8)
    m.add_argument("--bench", action="store_true",
                   help="weak-scaling bench: per-device rates on "
                        "1..n-device meshes")
    m.add_argument("--per-bl", type=int, default=32)
    m.add_argument("--nchan", type=int, default=64)
    m.add_argument("--nside", type=int, default=16)
    m.add_argument("--pallas", action="store_true")
    m.add_argument("--platform", default="auto",
                   choices=["auto", "cpu", "native"],
                   help="cpu: n CPU entries; native: the cards; auto: "
                        "--device")
    device_flag(m)

    f = sub.add_parser("feko2hpx")
    f.add_argument("infile")
    f.add_argument("outfile")
    f.add_argument("--nside", type=int, default=64)
    f.add_argument("--gain-db-col", type=int, default=None)
    f.add_argument("--interp", default="spline",
                   choices=["spline", "healpix", "nearest"])
    f.add_argument("--pol2", default=None,
                   help="second-polarization FEKO file (ref P2)")

    gs = sub.add_parser("gsm")
    gs.add_argument("--nside", type=int, default=64)
    gs.add_argument("--freqs", required=True,
                    help="comma-separated frequencies in Hz")
    gs.add_argument("--model", default="gsm2008",
                    choices=["gsm2008", "gsm2016"])
    gs.add_argument("-o", "--outfile", required=True)
    return p


def main(argv=None):
    import signal
    try:                       # die quietly when piped into head etc.
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass
    a = _parser().parse_args(argv)
    if a.cmd == "convert":
        print("\n".join(convert(a.infile, a.outfile, a.formats,
                                datatype=a.datatype)))
    elif a.cmd == "update-noise":
        update_noise(a.infile, a.outfile, Tsys=a.tsys, A_eff=a.a_eff,
                     seed=a.seed, device=a.device)
        print("noise updated -> %s" % (a.outfile or a.infile))
    elif a.cmd == "replicate":
        print("\n".join(replicate(a.infile, a.outprefix, a.n_realize,
                                  a.seed, a.fmt, device=a.device)))
    elif a.cmd == "redundant":
        out = expand_redundant_file(a.infile, a.outfile)
        print("expanded to %d baselines -> %s" % (out.nbl, a.outfile))
    elif a.cmd == "ls":
        print(json.dumps(list_sims(a.project_dir), indent=2, default=str))
    elif a.cmd == "grep":
        kv = dict(s.split("=", 1) for s in a.params)
        print("\n".join(grep_sims(a.project_dir, **kv)))
    elif a.cmd == "delay-ps":
        dps = delay_ps(a.infile, a.outfile, pad=a.pad,
                       nside_beam=a.nside_beam, clean=a.clean,
                       subband_centers=a.subband_centers,
                       subband_bw=a.subband_bw, device=a.device)
        print("wrote %s (z=%.3f, %d lags)"
              % (a.outfile, dps["z"], len(dps["kprll"])))
    elif a.cmd == "closure-npz":
        cpd = closure_npz(a.infile, a.outfile, datatype=a.datatype)
        print("wrote %s: %d lst x %d triads x %d chans"
              % (a.outfile, cpd.cp.shape[0], cpd.cp.shape[2],
                 cpd.cp.shape[3]))
    elif a.cmd == "xcpdps":
        ps = xcpdps(a.infile, a.outfile, freq_center=a.freq_center,
                    bw_eff=a.bw_eff, pad=a.pad, lstbinsize=a.lstbin,
                    ndaybins=a.ndaybins, num_kbins=a.num_kbins,
                    errinfo=a.errinfo, rescale_vis=a.rescale_vis,
                    rescale_triad=a.rescale_triad, cohax=a.cohax,
                    incohax=a.incohax, collapse_axes=a.collapse_axes,
                    avgcov=a.avgcov, lst_shifts=a.lst_shifts)
        print("wrote %s (%s spectrum, %d subbands, P shape %s)"
              % (a.outfile, ps["mode"], len(np.atleast_1d(ps["z"])),
                 ps["P"].shape))
    elif a.cmd == "plot":
        figdir = plot_sim(a.infile, a.outdir)
        print("wrote figures to %s" % figdir)
    elif a.cmd == "mesh-check":
        if a.bench:
            mesh_bench(a.n_devices, per_bl=a.per_bl, nchan=a.nchan,
                       nside=a.nside, use_pallas=a.pallas or None,
                       platform=a.platform, device=a.device)
            raise SystemExit(0)
        raise SystemExit(0 if mesh_check(
            a.n_devices, _platform_device(a.platform, a.device)) else 1)
    elif a.cmd == "gsm":
        freqs = np.asarray([float(s) for s in a.freqs.split(",")])
        path = gsm_to_npz(a.outfile, nside=a.nside, freqs=freqs,
                          model=a.model)
        print("wrote %s: nside %d x %d freqs" % (path, a.nside,
                                                 freqs.size))
    elif a.cmd == "feko2hpx":
        feko_to_healpix(a.infile, a.outfile, nside=a.nside,
                        col_gain_db=a.gain_db_col, interp=a.interp,
                        extra_pol_files=([a.pol2] if a.pol2 else ()))
        print("wrote %s" % a.outfile)


if __name__ == "__main__":
    main()
