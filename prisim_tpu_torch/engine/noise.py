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

__all__ = ["thermal_noise_rms", "generate_noise", "tsys_model"]


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


def generate_noise(generator, noise_rms, shape=None):
    """Complex64 gaussian noise with per-sample rms `noise_rms` (array,
    scalar or tensor, broadcastable to `shape`; default noise_rms.shape),
    drawn in float32 with `generator` (a torch.Generator) on its
    device."""
    dev = generator.device
    if isinstance(noise_rms, torch.Tensor):
        rms = noise_rms.to(device=dev, dtype=torch.float32)
    else:
        rms = torch.as_tensor(np.array(noise_rms, dtype=np.float32),
                              device=dev)
    shape = rms.shape if shape is None else tuple(int(n) for n in shape)
    scale = rms.broadcast_to(shape) / np.sqrt(2.0)
    re = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=dev)
    im = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=dev)
    return torch.complex(scale * re, scale * im)


def tsys_model(Trx, Tant_T0, Tant_f0, Tant_spindex, freqs, Tnet=None):
    """Tsys(nu) = Trx + T0 (nu/f0)^spindex, or the Tnet override broadcast
    to freqs' shape (the reference PRISim's interferometry.py system
    temperature): a tensor on the device of `freqs` (a host array becomes a
    CPU tensor)."""
    freqs = torch.as_tensor(freqs)
    if Tnet is not None:
        return torch.as_tensor(Tnet, dtype=freqs.dtype,
                               device=freqs.device).broadcast_to(freqs.shape)
    return Trx + Tant_T0 * (freqs / Tant_f0) ** Tant_spindex
