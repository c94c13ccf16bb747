"""Carry the JAX package's engine state across to the port.

The fields of prisim_tpu.engine.observe.Instrument and SkySources, taken
as numpy arrays (np.asarray of the JAX arrays), become the port's
dataclasses on `device`, so one test can feed both packages identical
inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.observe import Instrument, SkySources

__all__ = ["instrument_from_numpy", "sky_from_numpy"]


def _f32(x, device):
    return torch.as_tensor(np.array(x, dtype=np.float32, order="C"),
                           device=device)


def instrument_from_numpy(bl_hi, bl_lo, freqs, device="cuda", **meta):
    """Instrument from two-float baselines (B, 3) and host freqs (C,);
    `meta` takes the remaining Instrument fields (telescope, latitude,
    longitude, altitude, A_eff, eff_Q)."""
    return Instrument(_f32(bl_hi, device), _f32(bl_lo, device),
                      np.asarray(freqs, dtype=np.float64), **meta)


def sky_from_numpy(s_eq_hi, s_eq_lo, flux, device="cuda",
                   src_shape_sigma=None):
    """SkySources from two-float unit vectors (S, 3), the (S, C) spectrum
    and, for extended sources, the (S,) uv-plane gaussian sigmas (inf for
    a point source)."""
    return SkySources(_f32(s_eq_hi, device), _f32(s_eq_lo, device),
                      _f32(flux, device),
                      None if src_shape_sigma is None
                      else _f32(src_shape_sigma, device))
