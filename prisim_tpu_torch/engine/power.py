"""Antenna power: beam-weighted mean sky flux per snapshot and channel.

Counterpart of prisim_tpu/engine/power.py: for each LST, transform the
catalog positions to alt/az on the host, keep the upper hemisphere,
evaluate the primary beam on the device and return the beam-weighted
average source flux

    P(t, nu) = sum_src pb * S / sum_src pb

used for antenna-temperature / Tsys estimation."""

from __future__ import annotations

import numpy as np
import torch

from .. import geometry as geom

__all__ = ["antenna_power"]


def antenna_power(skymodel, freqs, lst_deg, latitude, beam_fn,
                  pointing_altaz=None, device="cuda"):
    """(n_lst, nchan) beam-weighted mean flux, float64 on the host.

    skymodel: SkyModel (RA/dec degrees); beam_fn(dircos, freqs) -> (S, C)
    power beam on float32 tensors on `device` ('cuda', the default, raises
    without a card; 'cpu'). pointing_altaz informs beam_fn via closure
    (pass a pointed beam_fn for steered beams)."""
    from ..driver import resolve_device
    dev = resolve_device(device)
    lst_deg = np.atleast_1d(np.asarray(lst_deg, dtype=np.float64))
    freqs = np.asarray(freqs, dtype=np.float64)
    flux = skymodel.generate_spectrum(freqs)          # (S, C)
    ra = skymodel.location[:, 0]
    dec = skymodel.location[:, 1]
    f32 = torch.as_tensor(freqs, dtype=torch.float32, device=dev)
    out = np.empty((lst_deg.size, freqs.size))
    for i, lst in enumerate(lst_deg):
        hadec = np.stack([lst - ra, dec], axis=-1)
        altaz = geom.hadec2altaz(hadec, latitude, xp=np)
        up = altaz[:, 0] >= 0.0
        dc = geom.altaz2dircos(altaz[up], xp=np)
        pb = beam_fn(torch.as_tensor(dc, dtype=torch.float32, device=dev),
                     f32).cpu().numpy()
        denom = np.sum(pb, axis=0)
        out[i] = np.sum(pb * flux[up], axis=0) / np.where(denom > 0,
                                                          denom, 1.0)
    return out
