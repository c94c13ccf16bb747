"""Snapshot and drift-scan observations on torch tensors.

Counterpart of prisim_tpu/engine/observe.py. The host computes, in
float64, the per-snapshot rotation from celestial to local (E, N, U)
coordinates and the phase-center dircos, split to two-float32; the
device rotates the source unit vectors in two-float, evaluates the beam
in f32, weights the spectrum and runs the NUDFT. A Python loop over the
accumulations takes the place of lax.scan.

A snapshot whose tensors lie on a CUDA card runs the NUDFT kernels
(cuda_nudft.nudft_cuda: K1a, with the gradient moments K1b and the
gaussian weights of extended sources K1c); one whose tensors lie on the
CPU runs their plain version (nudft.nudft_visibilities). On a card, the
beam of a plain Airy dish and the flux are weighted in one kernel
(cuda_beam.airy_amps_cuda).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import geometry as geom
from .. import tracing
from .. import twofloat as tf
from .cuda_beam import airy_amps_cuda
from .cuda_nudft import nudft_cuda
from .nudft import freq_grid_scalars, nudft_visibilities

__all__ = ["Instrument", "Observation", "SkySources", "enu_rotation_from_eq",
           "df_rotate3", "rotated_sources", "snapshot_nudft_inputs",
           "check_kernel_knobs", "direct_visibilities",
           "simulate_snapshot",
           "simulate_drift_rotations", "simulate_drift", "schedule_tensors"]


def enu_rotation_from_eq(lst_deg, lat_deg):
    """3x3 rotation: celestial equatorial cartesian (X to RA=0 on the
    equator, Z to NCP) -> local (E, N, U), at the given LST/latitude.
    Host float64; array lst -> (..., 3, 3)."""
    th = np.radians(np.asarray(lst_deg, dtype=np.float64))
    ph = np.radians(np.float64(lat_deg))
    ct, st = np.cos(th), np.sin(th)
    cp, sp = np.cos(ph), np.sin(ph)
    z = np.zeros_like(ct)
    o = np.ones_like(ct)
    return np.stack([
        np.stack([-st, ct, z], axis=-1),
        np.stack([-sp * ct, -sp * st, cp * o], axis=-1),
        np.stack([cp * ct, cp * st, sp * o], axis=-1),
    ], axis=-2)


def df_rotate3(Mh, Ml, sh, sl):
    """Two-float (3,3) @ (S,3)^T -> (S,3) rotated two-float vectors."""
    outs_h, outs_l = [], []
    for i in range(3):
        ph, pl = tf.two_prod(sh[:, 0], Mh[i, 0])
        pl = pl + (sh[:, 0] * Ml[i, 0] + sl[:, 0] * Mh[i, 0])
        for k in (1, 2):
            qh, ql = tf.two_prod(sh[:, k], Mh[i, k])
            ql = ql + (sh[:, k] * Ml[i, k] + sl[:, k] * Mh[i, k])
            ph, pl = tf.df_add(ph, pl, qh, ql)
        outs_h.append(ph)
        outs_l.append(pl)
    return torch.stack(outs_h, dim=-1), torch.stack(outs_l, dim=-1)


@dataclass
class SkySources:
    """Device sky: celestial unit vectors (two-float), spectra and the
    gaussian widths of extended sources."""
    s_eq_hi: torch.Tensor     # (S, 3) float32
    s_eq_lo: torch.Tensor
    flux: torch.Tensor        # (S, C) float32, Jy
    src_shape_sigma: Optional[torch.Tensor] = None   # (S,) uv sigma or None

    @classmethod
    def from_skymodel(cls, skymodel, freqs, device):
        """Unit vectors (host f64, split to two-float) and the (S, C)
        spectrum. Power-law spectra are evaluated on the device in f32
        from the per-source parameters, so only those cross to it.
        A src_shape (major, minor, pa in degrees) gives each source the
        uv-plane sigma of the gaussian of FWHM sqrt(major * minor), as
        prisim_tpu does (inf, a point source, for a zero FWHM)."""
        ra = np.radians(skymodel.location[:, 0])
        dec = np.radians(skymodel.location[:, 1])
        s_eq = np.stack([np.cos(dec) * np.cos(ra),
                         np.cos(dec) * np.sin(ra),
                         np.sin(dec)], axis=-1)
        sh, sl = tf.split_f64(s_eq)

        def dev32(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float32),
                                   device=device)

        if skymodel.spec_kind == "power-law":
            p = skymodel.spec_parms
            off = p.get("flux-offset", 0.0)
            off = (np.asarray(off) if np.ndim(off)
                   else np.full(len(p["flux-scale"]), float(off)))
            f = dev32(freqs)
            flux = (dev32(off)[:, None] + dev32(p["flux-scale"])[:, None]
                    * (f[None, :] / dev32(p["freq-ref"])[:, None])
                    ** dev32(p["power-law-index"])[:, None])
        else:
            flux = dev32(skymodel.generate_spectrum(np.asarray(freqs)))
        sigma = None
        if skymodel.src_shape is not None:
            # sigma_uv = 1 / (sqrt(2 ln 2) fwhm_dc), fwhm_dc the FWHM as a
            # chord in direction cosines
            fwhm = np.sqrt(skymodel.src_shape[:, 0] * skymodel.src_shape[:, 1])
            fwhm_dc = 2.0 * np.sin(0.5 * np.radians(fwhm))
            with np.errstate(divide="ignore"):
                sigma = dev32(np.where(
                    fwhm_dc > 0, 1.0 / (np.sqrt(2 * np.log(2))
                                        * np.maximum(fwhm_dc, 1e-12)),
                    np.inf))
        return cls(dev32(sh), dev32(sl), flux.contiguous(), sigma)


@dataclass
class Instrument:
    """Baselines on the device plus host metadata."""
    bl_hi: torch.Tensor       # (B, 3) ENU meters, float32
    bl_lo: torch.Tensor
    freqs: np.ndarray         # (C,) Hz, host float64, uniform grid
    telescope: dict = field(default_factory=dict)
    latitude: float = 0.0
    longitude: float = 0.0
    altitude: float = 0.0
    A_eff: float = 154.0
    eff_Q: float = 1.0

    @classmethod
    def build(cls, baseline_vectors, freqs, device, **kw):
        bh, bl = tf.split_f64(np.asarray(baseline_vectors, dtype=np.float64))
        return cls(torch.as_tensor(bh, device=device),
                   torch.as_tensor(bl, device=device),
                   np.asarray(freqs, dtype=np.float64), **kw)

    @property
    def device(self):
        return self.bl_hi.device

    @property
    def nu0(self):
        return float(self.freqs[0])

    @property
    def dnu(self):
        return float(self.freqs[1] - self.freqs[0])

    @property
    def nchan(self):
        return int(self.freqs.size)

    @property
    def nbl(self):
        return int(self.bl_hi.shape[0])

    def grid_scalars(self):
        return freq_grid_scalars(self.nu0, self.dnu)


@dataclass
class Observation:
    """Per-snapshot pointing and timing, host float64."""
    lst_deg: np.ndarray          # (T,)
    jd: np.ndarray               # (T,)
    t_acc: np.ndarray            # (T,) seconds
    pointing_altaz: np.ndarray   # (T, 2) phased-up center, degrees
    mode: str = "drift"

    @property
    def n_acc(self):
        return int(self.lst_deg.size)

    def rotations(self, latitude):
        return tf.split_f64(enu_rotation_from_eq(self.lst_deg, latitude))

    def pc_dircos(self):
        return geom.altaz2dircos(self.pointing_altaz, xp=np)


def _beam_and_flux(s_enu_hi, flux, freqs_f32, beam_fn, pc=None):
    """amps = beam(s) * flux, zeroed below the horizon.

    pc: the snapshot's (3,) pointing dircos tensor. A beam_fn marked
    `needs_pointing = True` (a phased array steered per accumulation)
    receives it as a third argument. A beam_fn that carries `airy =
    (diameter, axis)` (a plain chromatic Airy dish, driver._make_beam_fn)
    weights CUDA tensors in one launch of the airy_amps kernel, which
    computes what the torch chain below computes; the chain counts the
    sources x frequencies it evaluates as beam.evals."""
    airy = getattr(beam_fn, "airy", None)
    if airy is not None and flux.is_cuda:
        return airy_amps_cuda(s_enu_hi.contiguous(), flux.contiguous(),
                              airy[0], freqs_f32.contiguous(), axis=airy[1])
    tracing.count("beam.evals", s_enu_hi.shape[0] * freqs_f32.shape[0])
    if pc is not None and getattr(beam_fn, "needs_pointing", False):
        pb = beam_fn(s_enu_hi, freqs_f32, pc)
    else:
        pb = beam_fn(s_enu_hi, freqs_f32)
    above = (s_enu_hi[:, 2] > 0.0)[:, None]
    return torch.where(above, pb * flux, torch.zeros_like(flux))


def rotated_sources(Mh, Ml, pch, pcl, s_eq_hi, s_eq_lo, flux, freqs_f32,
                    beam_fn, above_horizon=False):
    """(seh, sel, amps, sh) of sources s_eq_hi/s_eq_lo (S, 3) with spectra
    flux (S, C) at freqs_f32 (C,) in one accumulation: the rotated
    effective direction cosines s - pc (two-float), the beam-weighted
    fluxes and the rotated sky directions s (the hi part, which the
    gradient moments and the gaussian weights take). Mh/Ml (3, 3) and
    pch/pcl (3,) are float32 tensors on the device. With `above_horizon`
    only the sources above the horizon are kept, before the beam is
    evaluated (the others' rows would be zero). Counts the rows weighted
    as src.processed."""
    sh, sl = df_rotate3(Mh, Ml, s_eq_hi, s_eq_lo)
    if above_horizon:
        up = torch.nonzero(sh[:, 2] > 0.0).reshape(-1)
        sh, sl, flux = sh[up], sl[up], flux[up]
    tracing.count("src.processed", flux.shape[0])
    seh, sel = tf.df_add(sh, sl, -pch[None, :], -pcl[None, :])
    return seh, sel, _beam_and_flux(sh, flux, freqs_f32, beam_fn, pc=pch), sh


def snapshot_nudft_inputs(instrument, sky, Mh, Ml, pch, pcl, beam_fn,
                          above_horizon=False):
    """rotated_sources of `sky` on `instrument`'s channels, each tensor
    contiguous."""
    freqs_f32 = torch.as_tensor(instrument.freqs, dtype=torch.float32,
                                device=sky.flux.device)
    return tuple(t.contiguous() for t in rotated_sources(
        Mh, Ml, pch, pcl, sky.s_eq_hi, sky.s_eq_lo, sky.flux, freqs_f32,
        beam_fn, above_horizon=above_horizon))


def check_kernel_knobs(device, use_pallas=None, interpret=False):
    """Check the reference's kernel switches against `device`. A CUDA
    device always runs the kernels, so use_pallas=False (the plain
    version) or interpret=True (the kernel's interpreter) raises
    ValueError there; use_pallas None or True takes the kernel. On the
    CPU the plain version runs whatever they say."""
    if torch.device(device).type != "cuda":
        return
    if use_pallas is False:
        raise ValueError("use_pallas=False asks for the plain NUDFT, but a "
                         "CUDA device always runs its kernels (K1a, K1b, "
                         "K1c)")
    if interpret:
        raise ValueError("interpret=True asks for a kernel interpreter, "
                         "which a CUDA device does not have: it always "
                         "runs the kernels (K1a to K1c, K2)")


def direct_visibilities(seh, sel, instrument, amps, src_block=512,
                        s_sky=None, src_shape_sigma=None, gradient=False):
    """The direct engine on `instrument`'s baselines: the NUDFT kernels for
    CUDA tensors, the plain version (in blocks of src_block sources) for
    CPU tensors. Returns (B, C) complex64, and with `gradient` also the
    (3, B, C) complex64 moments; `src_shape_sigma` (S,) weights extended
    sources. Both need s_sky (S, 3). Counts the sources whose amplitude
    row is not all zero as src.live (the kernels' live_order)."""
    args = (seh, sel, instrument.bl_hi, instrument.bl_lo, amps,
            instrument.grid_scalars(), instrument.nchan)
    kw = dict(s_sky=s_sky, src_shape_sigma=src_shape_sigma,
              gradient=gradient)
    if seh.is_cuda:
        return nudft_cuda(*args, **kw)
    if tracing.recording():
        tracing.count_device("src.live", (amps != 0).any(dim=1).sum())
    return nudft_visibilities(*args, src_block=src_block, **kw)


def simulate_snapshot(instrument, sky, Mh, Ml, pch, pcl, beam_fn,
                      src_block=512, gradient=False, use_pallas=None,
                      interpret=False):
    """One accumulation: (B, C) complex64 noiseless visibilities, and with
    `gradient` also the (3, B, C) moments. src_block sizes the plain
    version's source blocks (CPU tensors); use_pallas and interpret as in
    check_kernel_knobs."""
    check_kernel_knobs(sky.flux.device, use_pallas, interpret)
    with tracing.span("beam_flux"):
        seh, sel, amps, sh = snapshot_nudft_inputs(instrument, sky, Mh, Ml,
                                                   pch, pcl, beam_fn)
    shaped = sky.src_shape_sigma is not None
    with tracing.span("k1b" if gradient else "k1c" if shaped else "k1a"):
        return direct_visibilities(
            seh, sel, instrument, amps, src_block,
            s_sky=sh if (gradient or shaped) else None,
            src_shape_sigma=sky.src_shape_sigma, gradient=gradient)


def schedule_tensors(observation, latitude, device):
    """Per-accumulation two-float rotations (T, 3, 3) and phase-center
    dircos (T, 3) as float32 tensors (Mh, Ml, pch, pcl) on `device`."""
    Mh, Ml = observation.rotations(latitude)
    pch, pcl = tf.split_f64(observation.pc_dircos())
    return tuple(torch.as_tensor(x, device=device)
                 for x in (Mh, Ml, pch, pcl))


def simulate_drift_rotations(instrument, sky, Mh, Ml, pch, pcl, beam_fn,
                             src_block=512, gradient=False, use_pallas=None,
                             interpret=False):
    """Loop over per-accumulation rotations (T, 3, 3) and phase centers
    (T, 3), float32 tensors. Returns (T, B, C) complex64 on the device,
    and with `gradient` also the (T, 3, B, C) moments."""
    check_kernel_knobs(sky.flux.device, use_pallas, interpret)
    snaps = []
    for t in range(Mh.shape[0]):
        with tracing.span("snapshot", t=t):
            snaps.append(simulate_snapshot(
                instrument, sky, Mh[t], Ml[t], pch[t], pcl[t], beam_fn,
                src_block=src_block, gradient=gradient))
    if gradient:
        return (torch.stack([v for v, _ in snaps]),
                torch.stack([g for _, g in snaps]))
    return torch.stack(snaps)


def simulate_drift(instrument, sky, observation, beam_fn, src_block=512,
                   gradient=False, use_pallas=None, interpret=False):
    """All accumulations of `observation`: (T, B, C) complex64 (transpose
    to the reference's (nbl, nchan, n_acc) at IO time), and with
    `gradient` also the (T, 3, B, C) moments."""
    check_kernel_knobs(sky.flux.device, use_pallas, interpret)
    sched = schedule_tensors(observation, instrument.latitude,
                             instrument.device)
    return simulate_drift_rotations(instrument, sky, *sched, beam_fn,
                                    src_block=src_block, gradient=gradient)
