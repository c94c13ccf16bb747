"""Self-contained flat-LCDM cosmology for 21 cm delay power spectra.

Replaces the reference's astropy dependency
(PRISim's prisim/delay_spectrum.py:33-35 uses Planck 15 cloned to
H0=100 km/s/Mpc; :356-393 dkprll_deta; :3682-3861 comoving
distances/k-mappings). astropy is not available in this environment, so
E(z) and comoving distances are computed directly (photon + massless-
neutrino radiation included; the 0.06 eV massive neutrino of Planck 15 is
folded into matter — a <1e-4 fractional effect at 21 cm redshifts).
Distances are in Mpc (H0=100 => effectively Mpc/h).

Host numpy copy of prisim_tpu/analysis/cosmology.py, code unchanged (imports
relative)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as CNST

__all__ = ["FlatLCDM", "cosmo100", "dkprll_deta", "k_parallel", "k_perp",
           "comoving_depth", "jy2k", "freq_to_z", "z_to_freq"]

_C_KMS = CNST.c / 1e3


@dataclass(frozen=True)
class FlatLCDM:
    """Flat Lambda-CDM: H0 (km/s/Mpc), Om0, optional radiation via
    Tcmb0 (K) and Neff."""
    H0: float = 100.0
    Om0: float = 0.3075
    Tcmb0: float = 2.725
    Neff: float = 3.046

    @property
    def h(self):
        return self.H0 / 100.0

    @property
    def Ogamma0(self):
        if self.Tcmb0 == 0.0:
            return 0.0
        # rho_gamma = a_B T^4 / c^2; Omega = rho/rho_crit
        a_B = 7.565723e-16          # J m^-3 K^-4
        G = 6.67430e-11
        H0_si = self.H0 * 1e3 / 3.0856775814913673e22
        rho_crit = 3.0 * H0_si ** 2 / (8.0 * np.pi * G)
        return a_B * self.Tcmb0 ** 4 / CNST.c ** 2 / rho_crit

    @property
    def Onu0(self):
        return self.Ogamma0 * 0.2271073 * self.Neff

    @property
    def Or0(self):
        return self.Ogamma0 + self.Onu0

    @property
    def Ode0(self):
        return 1.0 - self.Om0 - self.Or0

    def efunc(self, z):
        z = np.asarray(z, dtype=np.float64)
        zp1 = 1.0 + z
        return np.sqrt(self.Om0 * zp1 ** 3 + self.Or0 * zp1 ** 4 +
                       self.Ode0)

    def hubble_distance(self):
        return _C_KMS / self.H0                       # Mpc

    def comoving_distance(self, z, n=4096):
        """Line-of-sight comoving distance (Mpc) via dense trapezoid
        quadrature of c/H(z)."""
        z = np.atleast_1d(np.asarray(z, dtype=np.float64))
        zmax = float(np.max(z))
        grid = np.linspace(0.0, max(zmax, 1e-8), n | 1)  # odd count
        integrand = 1.0 / self.efunc(grid)
        from scipy.integrate import cumulative_trapezoid
        cd = np.concatenate([[0.0], cumulative_trapezoid(integrand, grid)])
        out = self.hubble_distance() * np.interp(z, grid, cd)
        return out if out.size > 1 else float(out[0])

    def comoving_transverse_distance(self, z, **kw):
        return self.comoving_distance(z, **kw)        # flat universe


cosmo100 = FlatLCDM()


def freq_to_z(freq_hz):
    """Redshift of the HI 21 cm line observed at freq_hz."""
    return CNST.rest_freq_HI / np.asarray(freq_hz, dtype=np.float64) - 1.0


def z_to_freq(z):
    return CNST.rest_freq_HI / (1.0 + np.asarray(z, dtype=np.float64))


def dkprll_deta(redshift, cosmo=cosmo100):
    """Jacobian d(k_parallel)/d(eta) in (h/Mpc)/s
    (PRISim's prisim/delay_spectrum.py:389)."""
    z = np.asarray(redshift, dtype=np.float64)
    return (2.0 * np.pi * cosmo.H0 * CNST.rest_freq_HI * cosmo.efunc(z)
            / CNST.c / (1.0 + z) ** 2 * 1e3)


def k_parallel(lags, redshift, cosmo=cosmo100):
    """Line-of-sight wavenumber (h/Mpc) for delays `lags` (s)
    (PRISim's prisim/delay_spectrum.py:3786-3824)."""
    return dkprll_deta(redshift, cosmo) * np.asarray(lags)


def k_perp(baseline_length, redshift, wl, cosmo=cosmo100):
    """Transverse wavenumber (h/Mpc) for baseline length (m) observed at
    wavelength wl (m) (PRISim's prisim/delay_spectrum.py:3825-3863)."""
    rz = cosmo.comoving_transverse_distance(redshift)
    return 2.0 * np.pi * (np.asarray(baseline_length) / wl) / rz


def comoving_depth(bw, redshift, cosmo=cosmo100):
    """Comoving line-of-sight depth (Mpc/h) spanned by bandwidth bw (Hz)
    (PRISim's prisim/delay_spectrum.py:3708)."""
    z = np.asarray(redshift, dtype=np.float64)
    return (_C_KMS * bw * (1.0 + z) ** 2 / CNST.rest_freq_HI /
            cosmo.H0 / cosmo.efunc(z))


def jy2k(wl):
    """Jy -> K conversion factor: wl^2 Jy / (2 k_B)
    (PRISim's prisim/delay_spectrum.py:4046)."""
    return np.asarray(wl) ** 2 * CNST.Jy / (2.0 * CNST.k_B)
