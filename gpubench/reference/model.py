"""The plain reference of a drift scan over a HEALPix sky.

From the parameter sections of a configuration (the same dict the program
is given) it works out again, by itself: the baselines, the channels, the
LST and Julian date of each accumulation, the pixel directions precessed
to the epoch of the observation, their power-law fluxes, the Airy power
beam of the dish, and then the visibilities

    V(b, c, t) = sum_s A(s, c, t) exp(-2 pi i nu_c (s_t - p) . b / c)

with A the beam times the flux of the sources above the horizon and p the
phase centre's direction cosines, by a direct sum in plain PyTorch; and
the deterministic products of the finalize: the projected baselines and
the thermal-noise rms.

`precision="float64"` is the reference. `precision="control"` is the same
computation one step below what the configuration states: the geometry,
the delays and the phases in float32 in place of float64, the amplitudes
rounded to bfloat16 in place of float32, the sum in float32.
`precision="phase32"` lowers the phases alone: float32 geometry, delays,
phases and sum, the amplitudes kept in float32. The benchmark never runs
either; its calibration does, to show which of them the limits of
`correct` fail.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as G

PRECISIONS = ("float64", "control", "phase32")


def _airy_power(sin_t, freqs, diameter):
    """(2 J1(x) / x)^2 with x = pi D nu / c sin(theta), on the dtype of
    sin_t."""
    x = sin_t[:, None] * (np.pi * diameter / G.C_LIGHT) * freqs[None, :]
    small = x.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(x), x)
    p = torch.where(small, 1.0 - x * x / 8.0,
                    2.0 * torch.special.bessel_j1(safe) / safe)
    return p * p


class DriftReference:
    """The reference of one configuration's parameter sections."""

    precisions = PRECISIONS

    def __init__(self, sections, device="cpu", src_chunk=8192):
        s = sections
        self.device = torch.device(device)
        self.src_chunk = int(src_chunk)
        tel = s["telescope"]
        if tel["id"] != "hera" or s["antenna"]["shape"] != "dish":
            raise ValueError("the reference knows the HERA dish only")
        if s["skyparm"]["model"] != "usm":
            raise ValueError("the reference knows the uniform sky only")
        if s["obsparm"]["obs_mode"] != "drift":
            raise ValueError("the reference knows drift scans only")
        self.lat = float(tel["latitude"])
        self.lon = float(tel["longitude"])
        self.diameter = float(s["antenna"]["size"])
        self.orientation = tuple(float(x) for x in s["antenna"]["orientation"])
        self.bl = G.baselines(G.layout_positions(s["array"]["layout"]),
                              bool(s["array"]["redundant"]))
        bp = s["bandpass"]
        nchan = int(bp["nchan"])
        self.freqs = float(bp["freq"]) + float(bp["freq_resolution"]) * (
            np.arange(nchan) - nchan / 2)
        self.df = float(bp["freq_resolution"])
        op = s["obsparm"]
        self.obs_date = str(op["obs_date"])
        self.n_acc = int(op["n_acc"])
        self.t_acc = float(op["t_acc"])
        sp = s["skyparm"]
        self.nside = int(sp["nside"])
        self.epoch = float(sp["epoch"])
        self.f_ref = float(sp["custom_reffreq"]) * 1e9
        self.flux_index = float(sp["spindex"]) + 2.0
        # 1 K per pixel (the uniform sky), Rayleigh-Jeans, in Jy
        self.flux_ref = (2.0 * G.K_BOLTZMANN * self.f_ref ** 2
                         / G.C_LIGHT ** 2 * G.pixel_area(self.nside)
                         / G.JANSKY)
        self.phase_center = tuple(float(x) for x in s["phasing"]["center"])
        if s["phasing"]["coords"] != "altaz":
            raise ValueError("the reference phases to an alt-az centre only")
        self.tel = tel
        self._radec = G.healpix_ring_radec(self.nside)

    @property
    def nbl(self):
        return self.bl.shape[0]

    @property
    def nchan(self):
        return self.freqs.size

    @property
    def nsrc(self):
        return self._radec[0].size

    def schedule(self, lst_init_hours):
        """(lst_deg (T,), jd (T,)) of a simulation starting at this LST."""
        return G.drift_schedule(self.obs_date, lst_init_hours, self.lon,
                                self.n_acc, self.t_acc)

    def sky_vectors(self, jd):
        """(S, 3) equatorial unit vectors of the pixels, precessed from the
        sky's epoch to the mean Julian date of the simulation."""
        ra, dec = G.precess_radec(*self._radec, G.jyear_to_jd(self.epoch),
                                  float(np.mean(jd)))
        return G.unit_vectors(ra, dec)

    def enu_sources(self, lst_init_hours):
        """Per accumulation, the (S, 3) float64 ENU directions."""
        lst, jd = self.schedule(lst_init_hours)
        s_eq = self.sky_vectors(jd)
        return [s_eq @ G.enu_rotation(l, self.lat).T for l in lst]

    def live_counts(self, lst_init_hours):
        """(T,) number of sources above the horizon at each accumulation:
        the sources whose amplitudes are not zero, the work of a
        snapshot."""
        return np.asarray([int((s[:, 2] > 0).sum())
                           for s in self.enu_sources(lst_init_hours)])

    def visibilities(self, lst_init_hours, t_idx, bl_idx, ch_idx,
                     precision="float64"):
        """(len(t_idx), len(bl_idx), len(ch_idx)) complex visibilities
        (complex128 for the reference, complex64 below it)."""
        if precision not in PRECISIONS:
            raise ValueError(precision)
        low = precision != "float64"
        rdt = torch.float32 if low else torch.float64
        dev = self.device
        lst, jd = self.schedule(lst_init_hours)
        s_eq = self.sky_vectors(jd)
        pc = G.altaz_to_dircos(*self.phase_center)
        axis = G.altaz_to_dircos(*self.orientation)
        b = torch.as_tensor(self.bl[np.asarray(bl_idx)], dtype=rdt,
                            device=dev)
        nu = torch.as_tensor(self.freqs[np.asarray(ch_idx)], dtype=rdt,
                             device=dev)
        out = []
        for t in np.asarray(t_idx):
            rot = G.enu_rotation(lst[t], self.lat)
            if low:
                s = torch.as_tensor(s_eq, dtype=rdt, device=dev) @ \
                    torch.as_tensor(rot, dtype=rdt, device=dev).T
            else:
                s = torch.as_tensor(s_eq @ rot.T, device=dev)
            s = s[s[:, 2] > 0]
            ax = torch.as_tensor(axis, dtype=rdt, device=dev)
            pct = torch.as_tensor(pc, dtype=rdt, device=dev)
            vr = torch.zeros((b.shape[0], nu.shape[0]), dtype=rdt,
                             device=dev)
            vi = torch.zeros_like(vr)
            for s0 in range(0, s.shape[0], self.src_chunk):
                sc = s[s0:s0 + self.src_chunk]
                cosa = sc @ ax
                sin_t = torch.sqrt(torch.clamp(1.0 - cosa * cosa, 0.0, 1.0))
                amp = _airy_power(sin_t, nu, self.diameter) * (
                    self.flux_ref * (nu / self.f_ref) ** self.flux_index)
                amp = torch.where((cosa >= 0)[:, None], amp,
                                  torch.zeros_like(amp))
                if precision == "control":
                    amp = amp.to(torch.bfloat16).to(rdt)
                tau = (sc - pct) @ b.T / G.C_LIGHT               # (s, B)
                ph = (2.0 * np.pi) * tau[:, :, None] * nu[None, None, :]
                vr += (amp[:, None, :] * torch.cos(ph)).sum(dim=0)
                vi -= (amp[:, None, :] * torch.sin(ph)).sum(dim=0)
            out.append(torch.complex(vr, vi).cpu().numpy())
        return np.stack(out)

    def uvw(self, lst_init_hours, precision="float64"):
        """(B, 3, T) projected baselines towards the phase centre."""
        lst, _ = self.schedule(lst_init_hours)
        if precision == "control":
            f32 = np.float32
            return G.projected_baselines(
                self.bl.astype(f32), tuple(f32(x) for x in self.phase_center),
                lst.astype(f32), f32(self.lat)).astype(f32)
        return G.projected_baselines(self.bl, self.phase_center, lst,
                                     self.lat)

    def vis_rms(self, precision="float64"):
        """(C,) thermal-noise rms of a complex visibility in Jy: Tsys =
        Trx + Tant_ref (nu / Tant_freqref)^Tant_spindex, rms = 2 k Tsys /
        (A_eff eff_Q sqrt(t_acc df)) / Jy."""
        dt = np.float32 if precision == "control" else np.float64
        t = self.tel
        nu = self.freqs.astype(dt)
        tsys = dt(t["Trx"]) + dt(t["Tant_ref"]) * (
            nu / dt(t["Tant_freqref"])) ** dt(t["Tant_spindex"])
        return (dt(2.0 * G.K_BOLTZMANN) / np.sqrt(dt(self.t_acc * self.df))
                * tsys / dt(t["A_eff"]) / dt(t["eff_Q"]) / dt(G.JANSKY))
