"""Aperture synthesis: uvw generation and uv-grid setup.

Rebuild of PRISim's ``class ApertureSynthesis``
(prisim/interferometry.py:8990-9258): phase baseline
vectors toward per-snapshot phase centers to get (u, v, w), flatten, and
construct a regular uvw grid for imaging experiments. Pure functions
over arrays (host numpy).

Counterpart of prisim_tpu/aperture_synthesis.py: the code is a copy, on
the port's own geometry and constants."""

from __future__ import annotations

import numpy as np

from . import constants as CNST
from . import geometry as geom

__all__ = ["gen_uvw", "reorder_uvw", "uvw_grid"]


def gen_uvw(baselines_enu, latitude, lst_deg, phase_center,
            phase_center_coords, freqs=None):
    """uvw in meters (nbl, 3, n_acc) and, if freqs given, in wavelengths
    (nbl, 3, nchan, n_acc) (genUVW, interferometry.py:9167-9198)."""
    lst_deg = np.atleast_1d(np.asarray(lst_deg, dtype=np.float64))
    pc = np.atleast_2d(np.asarray(phase_center, dtype=np.float64))
    if pc.shape[0] == 1:
        pc = np.broadcast_to(pc, (lst_deg.size, pc.shape[1])).copy()
    if phase_center_coords == "hadec":
        hadec = pc
    elif phase_center_coords == "radec":
        hadec = np.stack([lst_deg - pc[:, 0], pc[:, 1]], axis=-1)
    elif phase_center_coords == "altaz":
        hadec = geom.altaz2hadec(pc, latitude, xp=np)
    else:
        raise ValueError("phase_center_coords must be hadec/radec/altaz")
    ha = np.radians(hadec[:, 0])
    dec = np.radians(hadec[:, 1])
    rot = np.asarray([
        [np.sin(ha), np.cos(ha), np.zeros_like(ha)],
        [-np.sin(dec) * np.cos(ha), np.sin(dec) * np.sin(ha),
         np.cos(dec)],
        [np.cos(dec) * np.cos(ha), -np.cos(dec) * np.sin(ha),
         np.sin(dec)]])                               # (3, 3, n_acc)
    blxyz = geom.enu2xyz(np.asarray(baselines_enu, dtype=np.float64),
                         latitude, xp=np)
    uvw_m = np.einsum("bj,ijt->bit", blxyz, rot)      # (nbl, 3, n_acc)
    if freqs is None:
        return uvw_m
    wl = CNST.c / np.asarray(freqs, dtype=np.float64)
    uvw_lambda = uvw_m[:, :, None, :] / wl.reshape(1, 1, -1, 1)
    return uvw_m, uvw_lambda


def reorder_uvw(uvw_lambda):
    """(nbl, 3, nchan, n_acc) -> (3, nbl*nchan*n_acc)
    (reorderUVW, interferometry.py:9199-9213)."""
    return np.swapaxes(np.asarray(uvw_lambda), 0, 1).reshape(3, -1)


def uvw_grid(uvw_lambda, spacing=0.5, pad=None, pow2=True):
    """Regular uvw grid covering the sampled points
    (setUVWgrid, interferometry.py:9214-9258).

    Returns dict(u, v, w) of 1-D grid coordinate arrays with spacing
    <= `spacing` wavelengths, optionally padded and rounded up to
    power-of-two sizes."""
    flat = reorder_uvw(uvw_lambda) if np.asarray(uvw_lambda).ndim == 4 \
        else np.asarray(uvw_lambda)
    if pad is None:
        pad = [0.0, 0.0, 0.0]
    pad = (list(np.atleast_1d(pad)) * 3)[:3]
    axes = {}
    for i, name in enumerate(("u", "v", "w")):
        lo = flat[i].min() - pad[i]
        hi = flat[i].max() + pad[i]
        span = max(hi - lo, spacing)
        n = int(np.ceil(span / spacing)) + 1
        if pow2:
            n = 1 << int(np.ceil(np.log2(n)))
        axes[name] = lo + (hi - lo) * np.arange(n) / max(n - 1, 1)
    return axes
