"""Thermal noise: radiometer-equation rms and complex gaussian draws.

Counterpart of prisim_tpu/engine/noise.py. The complex visibility noise
rms is

  sigma(Jy) = 2 k_B Tsys / (A_eff eff_Q sqrt(dt df)) / 1e-26
  sigma(K)  = Tsys / (eff_Q sqrt(dt df))

with 1/sqrt(2) of sigma in each of the real and imaginary parts. Draws
come from an explicit torch.Generator, on its device: they cannot reproduce
the JAX package's threefry bits, so they are checked by their statistics
and by same-seed reproducibility.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as CNST

__all__ = ["thermal_noise_rms", "generate_noise"]


def thermal_noise_rms(A_eff, df, dt, Tsys, nbl=1, nchan=1, ntimes=1,
                      flux_unit="Jy", eff_Q=1.0):
    """Complex-visibility thermal noise rms (host numpy), broadcast to
    (nbl, nchan, ntimes). A_eff / Tsys / eff_Q may be scalars or arrays
    broadcastable to that shape."""
    Tsys = np.asarray(Tsys)
    A_eff = np.asarray(A_eff)
    eff_Q = np.asarray(eff_Q)
    if flux_unit.lower() == "k":
        rms = Tsys / eff_Q / np.sqrt(dt * df)
    elif flux_unit.lower() == "jy":
        rms = (2.0 * CNST.k_B / np.sqrt(dt * df)
               * (Tsys / A_eff / eff_Q) / CNST.Jy)
    else:
        raise ValueError("flux_unit must be 'K' or 'Jy'")
    return np.broadcast_to(rms, (nbl, nchan, ntimes))


def generate_noise(generator, noise_rms):
    """Complex64 gaussian noise with per-sample rms `noise_rms` (array or
    tensor), drawn with `generator` (a torch.Generator) on its device."""
    dev = generator.device
    rms = torch.as_tensor(np.array(noise_rms, dtype=np.float32), device=dev)
    scale = rms / np.sqrt(2.0)
    re = torch.randn(rms.shape, generator=generator, dtype=torch.float32,
                     device=dev)
    im = torch.randn(rms.shape, generator=generator, dtype=torch.float32,
                     device=dev)
    return torch.complex(scale * re, scale * im)
