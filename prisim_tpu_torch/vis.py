"""Visibility container, phasing and baseline projection.

Counterpart of prisim_tpu/vis.py: ``VisibilitySet`` is a plain dataclass
of host numpy arrays (complex cubes are (nbl, nchan, n_acc), the
reference's on-disk order) with the same fields, so the port's products
carry the same schema. ``phase_centering``, ``project_baselines``,
``conjugate``, ``concatenate`` (the chunk merge) and
``apply_baseline_gradients`` are host numpy; ``delay_transform`` runs on
torch.fft.

IO (HDF5/NPZ) lives in prisim_tpu_torch.io.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from . import constants as CNST
from . import geometry as geom
from . import windows as win

__all__ = ["VisibilitySet", "phase_centering", "phase_path",
           "with_phase_center", "project_baselines",
           "conjugate", "concatenate", "delay_transform",
           "apply_baseline_gradients", "to_dircos"]


@dataclass
class VisibilitySet:
    """Simulated visibilities + instrument/observation metadata.

    Complex cubes have shape (nbl, nchan, n_acc); bp/bp_wts/Tsys likewise.
    """
    baselines: np.ndarray                 # (nbl, 3) ENU m
    labels: np.ndarray                    # (nbl, 2) str (A2, A1)
    freqs: np.ndarray                     # (nchan,) Hz
    lst: np.ndarray                       # (n_acc,) deg
    skyvis: Optional[np.ndarray] = None   # (nbl, nchan, n_acc) complex
    vis: Optional[np.ndarray] = None
    vis_noise: Optional[np.ndarray] = None
    vis_rms: Optional[np.ndarray] = None  # (nbl, nchan, n_acc) float, Jy
    timestamps: Optional[np.ndarray] = None   # (n_acc,) JD
    t_acc: Optional[np.ndarray] = None        # (n_acc,) s
    bp: Optional[np.ndarray] = None
    bp_wts: Optional[np.ndarray] = None
    Tsys: Optional[np.ndarray] = None
    A_eff: float = 154.0
    eff_Q: float = 1.0
    latitude: float = 0.0
    longitude: float = 0.0
    altitude: float = 0.0
    pointing_center: Optional[np.ndarray] = None   # (n_acc, 2|3)
    pointing_coords: str = "altaz"
    phase_center: Optional[np.ndarray] = None      # (n_acc, 2|3)
    phase_center_coords: str = "altaz"
    projected_baselines: Optional[np.ndarray] = None  # (nbl, 3, n_acc)
    telescope: dict = field(default_factory=dict)
    layout: Optional[dict] = None          # positions/labels/ids/coords
    flux_unit: str = "Jy"
    # lag-domain products (filled by delay_transform)
    lags: Optional[np.ndarray] = None
    skyvis_lag: Optional[np.ndarray] = None
    vis_lag: Optional[np.ndarray] = None
    vis_noise_lag: Optional[np.ndarray] = None
    lag_kernel: Optional[np.ndarray] = None
    gradients: Optional[dict] = None
    blgroups: Optional[dict] = None        # label-tuple -> member labels

    @property
    def nbl(self):
        return int(np.asarray(self.baselines).shape[0])

    @property
    def nchan(self):
        return int(np.asarray(self.freqs).size)

    @property
    def n_acc(self):
        return int(np.asarray(self.lst).size)

    @property
    def freq_resolution(self):
        f = np.asarray(self.freqs)
        return float(f[1] - f[0]) if f.size > 1 else 0.0

    @property
    def baseline_lengths(self):
        return np.sqrt(np.sum(np.asarray(self.baselines) ** 2, axis=1))

    def default_bp(self):
        shp = (self.nbl, self.nchan, self.n_acc)
        bp = np.ones(shp) if self.bp is None else np.broadcast_to(
            self.bp, shp)
        wts = np.ones(shp) if self.bp_wts is None else np.broadcast_to(
            self.bp_wts, shp)
        return bp, wts

    def _vis_cubes(self):
        for name in ("skyvis", "vis", "vis_noise"):
            arr = getattr(self, name)
            if arr is not None:
                yield name, arr


def to_dircos(location, coords, lst_deg, latitude):
    """Convert per-snapshot sky positions (deg) in 'radec' | 'hadec' |
    'altaz' | 'dircos' to local direction cosines (n, 3). Mirrors the
    coordinate ladder of phase_centering
    (PRISim prisim/interferometry.py:7730-7840)."""
    location = np.atleast_2d(np.asarray(location, dtype=np.float64))
    lst_deg = np.asarray(lst_deg, dtype=np.float64).ravel()
    if location.shape[0] == 1 and lst_deg.size > 1:
        location = np.broadcast_to(location,
                                   (lst_deg.size, location.shape[1])).copy()
    if coords == "radec":
        hadec = location.copy()
        hadec[:, 0] = lst_deg - location[:, 0]
        altaz = geom.hadec2altaz(hadec, latitude, xp=np)
        return geom.altaz2dircos(altaz, xp=np)
    if coords == "hadec":
        altaz = geom.hadec2altaz(location, latitude, xp=np)
        return geom.altaz2dircos(altaz, xp=np)
    if coords == "altaz":
        return geom.altaz2dircos(location, xp=np)
    if coords == "dircos":
        if location.shape[1] == 2:
            n = np.sqrt(np.maximum(
                0.0, 1.0 - np.sum(location ** 2, axis=1)))
            location = np.hstack([location, n[:, None]])
        return location
    raise ValueError("invalid coordinate system '%s'" % coords)


def phase_path(vs, phase_center_new, phase_center_coords_new):
    """b . (l_old - l_new): the (nbl, n_acc) float64 path difference (m)
    of each baseline and accumulation between the set's phase center
    (zenith where it has none) and a new one, which phase_centering turns
    into the phase 2 pi (path nu / c)."""
    lnew = to_dircos(phase_center_new, phase_center_coords_new,
                     vs.lst, vs.latitude)
    if vs.phase_center is None:
        lold = np.zeros_like(lnew)
        lold[:, 2] = 1.0          # zenith
    else:
        lold = to_dircos(vs.phase_center, vs.phase_center_coords,
                         vs.lst, vs.latitude)
    dl = lold - lnew                                       # (n_acc, 3)
    return np.asarray(vs.baselines) @ dl.T                 # (nbl, n_acc)


def with_phase_center(vs, phase_center_new, phase_center_coords_new,
                      **cubes):
    """`vs` with the new phase center (one row an accumulation) and the
    re-phased `cubes` (skyvis, vis, vis_noise) put in."""
    center = np.atleast_2d(np.asarray(phase_center_new))
    return replace(vs, phase_center=np.broadcast_to(
        center, (vs.n_acc, center.shape[1])).copy(),
        phase_center_coords=phase_center_coords_new, **cubes)


def phase_centering(vs, phase_center_new, phase_center_coords_new,
                    do_delay_transform=False, device="cuda"):
    """Re-phase all visibility cubes to a new phase center.

    V' = V * exp(-2 pi i (b . (l_old - l_new)) nu / c)
    (PRISim prisim/interferometry.py:7841-7852). Returns a new
    VisibilitySet with updated phase_center; with do_delay_transform, also
    delay-transformed (delay_transform on `device`)."""
    b_dot_l = phase_path(vs, phase_center_new, phase_center_coords_new)
    cubes = list(vs._vis_cubes())
    if all(np.asarray(a).dtype == np.complex64 for _, a in cubes):
        # single-precision cubes: frac-reduce the cycle count in f64
        # (the argument spans ~1e3 cycles at 876 m baselines), then a
        # complex64 phasor, without upcasting three (B, C, T) cubes
        cyc = b_dot_l[:, None, :] * (np.asarray(vs.freqs, np.float64)
                                     .reshape(1, -1, 1) / CNST.c)
        cyc -= np.rint(cyc)
        ang = (2.0 * np.pi * cyc).astype(np.float32)
        phase = np.empty(ang.shape, np.complex64)
        phase.real = np.cos(ang)
        phase.imag = -np.sin(ang)
    else:
        phase = np.exp(-2j * np.pi * b_dot_l[:, None, :] *
                       np.asarray(vs.freqs).reshape(1, -1, 1) / CNST.c)
    out = with_phase_center(vs, phase_center_new, phase_center_coords_new,
                            **{name: np.asarray(arr) * phase
                               for name, arr in cubes})
    if do_delay_transform:
        out = delay_transform(out, device=device)
    return out


def project_baselines(vs, ref_location=None, ref_coords=None):
    """Per-snapshot uvw: rotate equatorial-XYZ baselines toward the
    reference point (defaults to the phase center). Rotation matrix from
    PRISim prisim/interferometry.py:7976-7985. Returns a new
    VisibilitySet with projected_baselines (nbl, 3, n_acc)."""
    if ref_location is None:
        if vs.phase_center is not None:
            ref_location = vs.phase_center
            ref_coords = vs.phase_center_coords
        else:
            ref_location = np.asarray([[90.0, 270.0]])   # zenith drift
            ref_coords = "altaz"
    dc = to_dircos(ref_location, ref_coords, vs.lst, vs.latitude)
    altaz = geom.dircos2altaz(dc, xp=np)
    hadec = geom.altaz2hadec(altaz, vs.latitude, xp=np)
    ha = np.radians(hadec[:, 0]).ravel()
    dec = np.radians(hadec[:, 1]).ravel()
    eq_baselines = geom.enu2xyz(np.asarray(vs.baselines), vs.latitude,
                                xp=np)
    rot = np.asarray([
        [np.sin(ha), np.cos(ha), np.zeros(ha.size)],
        [-np.sin(dec) * np.cos(ha), np.sin(dec) * np.sin(ha),
         np.cos(dec) * np.ones(ha.size)],
        [np.cos(dec) * np.cos(ha), -np.cos(dec) * np.sin(ha),
         np.sin(dec) * np.ones(ha.size)]])    # (3_out, 3_in, n_acc)
    proj = np.einsum("bj,ijt->bit", eq_baselines, rot)
    return replace(vs, projected_baselines=proj)


def conjugate(vs, ind="all"):
    """Flip baseline vectors and conjugate visibilities for the selected
    baselines (PRISim prisim/interferometry.py:7999-8050)."""
    if isinstance(ind, str):
        if ind != "all":
            raise ValueError('ind must be "all" if a string')
        ind = np.arange(vs.nbl)
    ind = np.asarray(ind).ravel()
    if np.any(ind >= vs.nbl):
        raise IndexError("baseline index out of range")
    mask = np.zeros(vs.nbl, dtype=bool)
    mask[ind] = True
    bl = np.asarray(vs.baselines).copy()
    bl[mask] = -bl[mask]
    labels = np.asarray(vs.labels).copy()
    labels[mask] = labels[mask][:, ::-1]
    updates = {}
    for name, arr in vs._vis_cubes():
        arr = np.asarray(arr).copy()
        arr[mask] = np.conj(arr[mask])
        updates[name] = arr
    proj = vs.projected_baselines
    if proj is not None:
        proj = np.asarray(proj).copy()
        proj[mask] = -proj[mask]
    return replace(vs, baselines=bl, labels=labels,
                   projected_baselines=proj, **updates)


def concatenate(parts, axis):
    """Stitch partial sims along axis 0 (baselines), 1 (channels), or
    2 (accumulations) - the chunk merge of the reference's MPI driver
    (PRISim prisim/interferometry.py:8291; run_prisim.py:2256-2267)."""
    if not parts:
        raise ValueError("no parts to concatenate")
    first = parts[0]

    def cat(get, ax):
        arrs = [get(p) for p in parts]
        if any(a is None for a in arrs):
            return None
        return np.concatenate([np.asarray(a) for a in arrs], axis=ax)

    kw = {}
    for name in ("skyvis", "vis", "vis_noise", "vis_rms", "bp", "bp_wts",
                 "Tsys"):
        kw[name] = cat(lambda p, n=name: getattr(p, n), axis)
    if axis == 0:
        kw["baselines"] = np.concatenate(
            [np.asarray(p.baselines) for p in parts], axis=0)
        kw["labels"] = np.concatenate(
            [np.asarray(p.labels) for p in parts], axis=0)
        kw["freqs"] = first.freqs
        kw["lst"] = first.lst
        kw["timestamps"] = first.timestamps
        kw["t_acc"] = first.t_acc
        if all(p.projected_baselines is not None for p in parts):
            kw["projected_baselines"] = np.concatenate(
                [np.asarray(p.projected_baselines) for p in parts], axis=0)
    elif axis == 1:
        kw["baselines"] = first.baselines
        kw["labels"] = first.labels
        kw["freqs"] = np.concatenate(
            [np.asarray(p.freqs) for p in parts])
        kw["lst"] = first.lst
        kw["timestamps"] = first.timestamps
        kw["t_acc"] = first.t_acc
        kw["projected_baselines"] = first.projected_baselines
    elif axis == 2:
        kw["baselines"] = first.baselines
        kw["labels"] = first.labels
        kw["freqs"] = first.freqs
        kw["lst"] = np.concatenate([np.asarray(p.lst) for p in parts])

        def cat_t(get):
            arrs = [get(p) for p in parts]
            if any(a is None for a in arrs):
                return None
            return np.concatenate([np.asarray(a) for a in arrs])
        kw["timestamps"] = cat_t(lambda p: p.timestamps)
        kw["t_acc"] = cat_t(lambda p: p.t_acc)
        if all(p.projected_baselines is not None for p in parts):
            kw["projected_baselines"] = np.concatenate(
                [np.asarray(p.projected_baselines) for p in parts], axis=2)
        for name in ("pointing_center", "phase_center"):
            arrs = [getattr(p, name) for p in parts]
            if all(a is not None for a in arrs):
                kw[name] = np.concatenate(
                    [np.atleast_2d(np.asarray(a)) for a in arrs], axis=0)
    else:
        raise ValueError("axis must be 0, 1 or 2")
    # lag-domain products are not concatenable (a partial-band delay
    # spectrum has the wrong lag axis): drop them; callers re-run
    # delay_transform on the merged set.
    for name in ("lags", "skyvis_lag", "vis_lag", "vis_noise_lag",
                 "lag_kernel"):
        kw[name] = None
    return replace(first, **kw)


def delay_transform(vs, pad=1.0, freq_wts=None, device="cuda"):
    """Windowed IFFT along the frequency axis with zero-padding and
    Fourier downsampling back to nchan lag bins (torch.fft on `device`;
    PRISim prisim/interferometry.py:8052-8139). freq_wts replaces the
    bandpass weights: (nchan,), (nbl, nchan) or (nbl, nchan, n_acc)
    values. Returns a new VisibilitySet with lags / *_lag / lag_kernel
    filled."""
    from .driver import resolve_device
    device = resolve_device(device)
    nchan = vs.nchan
    df = vs.freq_resolution
    bp, bp_wts = vs.default_bp()
    if freq_wts is not None:
        freq_wts = np.asarray(freq_wts)
        if freq_wts.size == nchan:
            bp_wts = np.broadcast_to(
                freq_wts.reshape(1, nchan, 1),
                (vs.nbl, nchan, vs.n_acc))
        elif freq_wts.size == nchan * vs.nbl:
            bp_wts = np.repeat(freq_wts.reshape(vs.nbl, nchan, 1),
                               vs.n_acc, axis=2)
        elif freq_wts.size == nchan * vs.nbl * vs.n_acc:
            bp_wts = freq_wts.reshape(vs.nbl, nchan, vs.n_acc)
        else:
            raise ValueError("window shape incompatible with data")
    lags = win.spectral_axis(nchan, delx=df, shift=True)
    updates = {"lags": lags, "bp_wts": np.asarray(bp_wts)}

    def _dt(arr):
        x = torch.as_tensor(np.asarray(arr * bp * bp_wts, dtype=np.complex64),
                            device=device)
        return win.ifft_delay_transform(x, df, pad=pad, axis=1).cpu().numpy()

    for name, arr in vs._vis_cubes():
        updates[name + "_lag"] = _dt(np.asarray(arr))
    updates["lag_kernel"] = _dt(np.ones((vs.nbl, nchan, vs.n_acc)))
    return replace(vs, **updates)

def apply_baseline_gradients(vs, delta_b):
    """First-order perturbed visibilities from the stored baseline
    gradients (PRISim's InterferometerArray.apply_gradients):

      V'(b + db) ~ V(b) - 2 pi i (nu / c) sum_k db_k G_k

    where G_k = sum_src s_k A w e^{-i phi} are the moments that
    processing.gradient_mode: baseline stores. delta_b: (3,) or (nbl, 3)
    meters. Returns the perturbed skyvis cube (nbl, nchan, n_acc)."""
    if not vs.gradients or "baseline" not in vs.gradients:
        raise ValueError("VisibilitySet carries no baseline gradients "
                         "(run with processing.gradient_mode='baseline')")
    grad = np.asarray(vs.gradients["baseline"])   # (3, nbl, nchan, n_acc)
    db = np.asarray(delta_b, dtype=np.float64)
    if db.ndim == 1:
        db = np.broadcast_to(db, (vs.nbl, 3))
    term = np.einsum("bk,kbct->bct", db, grad)
    nu = np.asarray(vs.freqs).reshape(1, -1, 1)
    return np.asarray(vs.skyvis) - 2j * np.pi * (nu / CNST.c) * term
