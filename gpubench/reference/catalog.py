"""The plain reference of a drift scan over a point-source catalog seen by
phased-array tiles.

From the parameter sections of a configuration (the same dict the program
is given) it works out again, by itself:

- the catalog of the synthetic `random` sky model from skyparm.seed: a
  numpy RandomState(seed) draws RA uniform over [0, 360) deg, dec as
  arcsin of a uniform over [-1, 1), the flux at 150 MHz by the inverse
  CDF of an S^-2 count law between flux_min and flux_max, and the
  spectral index as spindex + spindex_rms x a standard normal, in that
  order; the positions precessed from skyparm.epoch to the mean Julian
  date of the simulation;
- the baselines of the explicit layout (array.layout_positions), all
  pairs j > i in row-major order (geometry.baselines);
- the tile's power pattern |E_dipole AF|^2 GP^2: the finite dipole of
  0.74 m along the antenna's orientation, E = (cos(kh cos a) - cos kh) /
  (sin a (1 - cos kh)) with kh = pi nu 0.74 / c and a the angle from its
  axis; the array factor of the 4 x 4 tile of dipoles 1.1 m apart, AF =
  (1/16) sum_e exp(2 pi i nu (x_e . p - x_e . s) / c), steered to the
  pointing p; the image-dipole ground factor GP = sin(k h sin alt) /
  sin(k h) over a screen h below the dipoles;

and then the visibilities

    V(b, c, t) = sum_s A(s, c, t) exp(-2 pi i nu_c (s_t - q) . b / c)

with A the tile pattern times the flux of the sources above the horizon
and q the phase centre's direction cosines, by a direct sum over blocks
of sources in plain PyTorch. The LST and Julian date of each
accumulation, the precession, the projected baselines and the
thermal-noise rms are model.DriftReference's.

`precision` as in model.py: "float64" the reference, "control" the
geometry, delays and phases in float32, the amplitudes rounded to
bfloat16 and the sum in float32, "phase32" float32 geometry, delays,
phases, amplitudes and sum.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as G
from .model import PRECISIONS, DriftReference

DIPOLE_LENGTH = 0.74          # m, the MWA's bow-tie dipole
TILE_SPACING = 1.1            # m
TILE_SIDE = 4
SKY_FREQ_REF = 150e6          # Hz, where the random model's fluxes hold


def random_catalog(nsrc, flux_min, flux_max, spindex_mean, spindex_rms,
                   seed):
    """(ra_deg, dec_deg, flux at 150 MHz in Jy, spectral index), each
    (nsrc,) float64, of the `random` sky model drawn from `seed`."""
    rng = np.random.RandomState(int(seed))
    ra = rng.uniform(0.0, 360.0, nsrc)
    dec = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, nsrc)))
    u = rng.uniform(size=nsrc)
    # N(>S) ~ 1/S between the two fluxes, by its inverse CDF
    flux = flux_min * flux_max / (flux_max - u * (flux_max - flux_min))
    index = np.full(nsrc, float(spindex_mean))
    if spindex_rms > 0:
        index = index + spindex_rms * rng.randn(nsrc)
    return ra, dec, flux, index


def tile_positions():
    """(16, 3) positions in metres of the tile's dipoles: a 4 x 4 grid
    1.1 m apart, centred, rows from north to south, each west to east."""
    side = TILE_SPACING * (np.arange(TILE_SIDE) - (TILE_SIDE - 1) / 2.0)
    east, north = np.meshgrid(side, side[::-1])
    return np.stack([east.ravel(), north.ravel(),
                     np.zeros(TILE_SIDE * TILE_SIDE)], axis=-1)


def tile_power(s, nu, axis, pointing, ground_height):
    """(S, C) power pattern of the tile at ENU directions s (S, 3) and
    frequencies nu (C,), on the dtype and device of s: the dipole along
    the unit `axis` (3,), the array factor steered to the unit `pointing`
    (3,), the ground factor of a screen `ground_height` m below (None:
    none), peak 1 at the zenith for a zenith pointing."""
    k = (2.0 * np.pi / G.C_LIGHT) * nu                          # (C,)
    kh = k * (0.5 * DIPOLE_LENGTH)
    cosa = torch.clamp(s @ axis, -1.0, 1.0)
    sina = torch.sqrt(torch.clamp(1.0 - cosa * cosa, 1e-12, 1.0))
    e = ((torch.cos(kh[None, :] * cosa[:, None]) - torch.cos(kh)[None, :])
         / sina[:, None] / (1.0 - torch.cos(kh))[None, :])
    # along the axis the pattern's limit is 0
    e = torch.where((torch.abs(torch.abs(cosa) - 1.0) < 1e-10)[:, None],
                    torch.zeros_like(e), e)
    x = torch.as_tensor(tile_positions(), dtype=s.dtype, device=s.device)
    # delay of each dipole (x . p - x . s) / c, in metres here
    path = (x @ pointing)[None, :] - s @ x.T                    # (S, 16)
    re = torch.zeros_like(e)
    im = torch.zeros_like(e)
    for j in range(x.shape[0]):
        ph = path[:, j, None] * k[None, :]
        re = re + torch.cos(ph)
        im = im + torch.sin(ph)
    n = float(x.shape[0])
    power = e * e * (re * re + im * im) / (n * n)
    if ground_height is not None:
        sinalt = torch.clamp(s[:, 2], 0.0, 1.0)
        gp = (torch.sin(k[None, :] * ground_height * sinalt[:, None])
              / torch.sin(k * ground_height)[None, :])
        power = power * gp * gp
    return power


class CatalogReference(DriftReference):
    """The reference of one configuration's parameter sections: the MWA
    tile (telescope.id mwa, antenna.phased_array, no phasedarray.file and
    no delay or gain errors), a `random` point-source catalog, a drift
    scan, an explicit layout."""

    precisions = PRECISIONS

    def __init__(self, sections, device="cpu", src_chunk=8192):
        s = sections
        self.device = torch.device(device)
        self.src_chunk = int(src_chunk)
        tel, ant = s["telescope"], s["antenna"]
        pa = s.get("phasedarray") or {}
        if tel["id"] != "mwa" or not ant.get("phased_array"):
            raise ValueError("the reference knows the MWA tile only")
        if pa.get("file") or pa.get("delayerr") or pa.get("gainerr"):
            raise ValueError("the reference knows the tile of 4 x 4 "
                             "dipoles without delay or gain errors only")
        if str((s.get("beam") or {}).get("pol") or "X").upper() != "X":
            raise ValueError("the reference knows the X dipole only")
        if s["skyparm"]["model"] != "random":
            raise ValueError("the reference knows the random catalog only")
        if s["obsparm"]["obs_mode"] != "drift":
            raise ValueError("the reference knows drift scans only")
        if ant["ocoords"] != "altaz" or s["phasing"]["coords"] != "altaz":
            raise ValueError("the reference takes alt-az orientations and "
                             "phase centres only")
        self.lat = float(tel["latitude"])
        self.lon = float(tel["longitude"])
        self.tel = tel
        pos = np.asarray(s["array"]["layout_positions"], np.float64)
        if pos.shape[1] == 2:
            pos = np.concatenate([pos, np.zeros((pos.shape[0], 1))], 1)
        self.bl = G.baselines(pos, bool(s["array"]["redundant"]))
        bp = s["bandpass"]
        nchan = int(bp["nchan"])
        self.freqs = float(bp["freq"]) + float(bp["freq_resolution"]) * (
            np.arange(nchan) - nchan / 2)
        self.df = float(bp["freq_resolution"])
        op = s["obsparm"]
        self.obs_date = str(op["obs_date"])
        self.n_acc = int(op["n_acc"])
        self.t_acc = float(op["t_acc"])
        di = s["pointing"]["drift_init"]
        self.pointing = G.altaz_to_dircos(float(di["alt"]), float(di["az"]))
        self.axis = G.altaz_to_dircos(*(float(x) for x in ant["orientation"]))
        gp = ant.get("ground_plane")
        self.ground_height = None if gp is None else float(gp)
        self.phase_center = tuple(float(x) for x in s["phasing"]["center"])
        sp = s["skyparm"]
        self.epoch = float(sp["epoch"])
        ra, dec, self.flux150, self.index = random_catalog(
            int(sp["nsrc"]), float(sp["flux_min"]), float(sp["flux_max"]),
            float(sp["spindex"]), float(sp.get("spindex_rms") or 0.0),
            int(sp["seed"]))
        self._radec = (ra, dec)

    def visibilities(self, lst_init_hours, t_idx, bl_idx, ch_idx,
                     precision="float64"):
        """(len(t_idx), len(bl_idx), len(ch_idx)) complex visibilities
        (complex128 for the reference, complex64 below it)."""
        if precision not in PRECISIONS:
            raise ValueError(precision)
        low = precision != "float64"
        rdt = torch.float32 if low else torch.float64
        dev = self.device

        def on(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=dev,
                                   dtype=rdt)

        lst, jd = self.schedule(lst_init_hours)
        s_eq = self.sky_vectors(jd)
        b = on(self.bl[np.asarray(bl_idx)])
        nu = on(self.freqs[np.asarray(ch_idx)])
        pc = on(G.altaz_to_dircos(*self.phase_center))
        axis, pointing = on(self.axis), on(self.pointing)
        s_all = on(s_eq)
        flux150, index = on(self.flux150), on(self.index)
        out = []
        for t in np.asarray(t_idx):
            rot = G.enu_rotation(lst[t], self.lat)
            # float64 rotation of float64 vectors, or both in float32
            s = (torch.as_tensor(s_eq @ rot.T, device=dev) if not low
                 else s_all @ on(rot).T)
            up = s[:, 2] > 0
            s, fl, ix = s[up], flux150[up], index[up]
            vr = torch.zeros((b.shape[0], nu.shape[0]), dtype=rdt,
                             device=dev)
            vi = torch.zeros_like(vr)
            for s0 in range(0, s.shape[0], self.src_chunk):
                sc = s[s0:s0 + self.src_chunk]
                blk = slice(s0, s0 + self.src_chunk)
                amp = tile_power(sc, nu, axis, pointing,
                                 self.ground_height) * (
                    fl[blk, None]
                    * (nu[None, :] / SKY_FREQ_REF) ** ix[blk, None])
                if precision == "control":
                    amp = amp.to(torch.bfloat16).to(rdt)
                tau = (sc - pc) @ b.T / G.C_LIGHT               # (s, B)
                ph = (2.0 * np.pi) * tau[:, :, None] * nu[None, None, :]
                vr += (amp[:, None, :] * torch.cos(ph)).sum(dim=0)
                vi -= (amp[:, None, :] * torch.sin(ph)).sum(dim=0)
            out.append(torch.complex(vr, vi).cpu().numpy())
        return np.stack(out)
