"""Jones-vector feed models and Mueller beam weights for full-pol runs
(torch).

Counterpart of prisim_tpu/beams/jones.py: float32 elementwise maths on
the device of the direction cosines, with the same clips. The reference
is single-polarization: its beam dispatcher returns one power pattern
per run (PRISim's prisim/primary_beams.py:9). This module gives
physical XY/YX cross-polarization from dipole Jones vectors, so a
`beam.pol: full` run produces all four linear correlations with real
leakage instead of flagged zeros.

Physics. A linear feed p with horizontal orientation p_hat responds to
the transverse field of a source at direction s_hat with the Jones
VECTOR

    J_p(s, nu) = A_p(s, nu) * (p_hat - (p_hat . s_hat) s_hat)

where the unnormalized transverse projection has norm sin(psi_p)
(psi_p = angle between s_hat and the dipole axis) and A_p =
F_p(psi_p)/sin(psi_p) * g(theta, nu) carries the finite-length element
factor F_p and the ground-plane image factor g. For an UNPOLARIZED sky
(Stokes I only, the reference's regime) the correlated power beam
between feeds p and q is the Mueller weight

    B_pq(s, nu) = J_p . J_q*

(the sky field is isotropic in the transverse plane, so the average
collapses to the dot product of the Jones vectors: no theta/phi basis,
and no zenith azimuth singularity). With real dipole Jones vectors B_XY
is real and B_YX = B_XY; `mueller_from_jones` combines complex Jones
components for beams with phase.

Visibilities then follow from the same scalar engines, once per
product: V_pq(b, nu) = sum_s B_pq(s, nu) I_s(nu) exp(-2 pi i nu b.s/c).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as CNST

__all__ = ["dipole_jones", "mueller_unpol_weights", "mueller_from_jones"]


def _f32(x, device):
    """x as a float32 tensor on `device`, at least 1-d."""
    return torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32,
                                            device=device))


def _element_amp(cosa, freqs, length, short_dipole=False,
                 half_wave=False):
    """Element factor A = F(psi)/sin(psi) for a linear dipole, as a
    function of cos(psi): (S, C), peak-normalized at psi = 90 deg.

    F matches beams.analytic.dipole_beam:
    short:      F = sin(psi)          -> A = 1
    half-wave:  F = cos(pi/2 cos psi) -> A = F / sin(psi)
    finite L:   F = (cos(kh cos psi) - cos(kh)) / (1 - cos(kh))
    The sin(psi) in A cancels the |transverse projection| = sin(psi)
    of the unnormalized Jones vector, so J = A * (p - (p.s)s) has
    |J| = F exactly. `freqs` is a float32 tensor on cosa's device."""
    cosa = torch.clamp(cosa, -1.0, 1.0)
    sina2 = torch.clamp(1.0 - cosa * cosa, 1e-12, 1.0)
    nf = freqs.shape[0]
    if short_dipole:
        return torch.ones_like(cosa)[:, None].expand(cosa.shape[0], nf)
    if half_wave:
        a = torch.cos(0.5 * math.pi * cosa) / sina2
        return a[:, None].expand(cosa.shape[0], nf)
    k = 2.0 * math.pi * freqs / CNST.c
    kh = k * (0.5 * float(length))
    num = torch.cos(kh[None, :] * cosa[:, None]) - torch.cos(kh)[None, :]
    return num / sina2[:, None] / (1.0 - torch.cos(kh))[None, :]


def dipole_jones(dircos, freqs, orientation_dircos=(1.0, 0.0, 0.0),
                 length=1.0, ground_height=None, short_dipole=False,
                 half_wave=True):
    """Jones vector of one linear feed: (amp (S, C), evec (S, 3)), float32
    on dircos's device.

    J(s, nu) = amp * evec with evec = p_hat - (p_hat.s_hat) s_hat (the
    unnormalized transverse projection; frequency-independent) and amp
    the element factor times the ground-plane image factor
    2 sin(k h s_z) when ground_height is given. The split keeps the
    arrays small: the direction vector is (S, 3) once, not (S, C, 3)."""
    dircos = torch.as_tensor(dircos, dtype=torch.float32)
    dev = dircos.device
    p = np.asarray(orientation_dircos, dtype=np.float64)
    p = _f32(p / np.linalg.norm(p), dev)
    f = _f32(freqs, dev)
    cosa = dircos @ p
    evec = p[None, :] - cosa[:, None] * dircos
    amp = _element_amp(cosa, f, length, short_dipole=short_dipole,
                       half_wave=half_wave)
    if ground_height is not None:
        k = 2.0 * math.pi * f / CNST.c
        sz = torch.clamp(dircos[:, 2], 0.0, 1.0)
        amp = amp * (2.0 * torch.sin(k[None, :] * float(ground_height)
                                     * sz[:, None]))
    return amp, evec


def mueller_unpol_weights(dircos, freqs, length=1.3,
                          ground_height=None,
                          x_orientation_deg=0.0,
                          y_orientation_deg=90.0,
                          short_dipole=False, half_wave=True):
    """Unpolarized-sky Mueller beam weights {XX, YY, XY} of a crossed
    linear-dipole pair, each (S, C) float32 on dircos's device.

    Orientation angles are degrees east-through-north of the dipole
    AXES (X along east by default, Y along north). XX and YY are
    normalized to 1 at zenith per frequency; XY is normalized by
    sqrt(zenith_XX * zenith_YY) so the hermitian structure survives.
    A y_orientation_deg other than x+90 models feed misalignment: the
    zenith XY leakage becomes cos(dtheta) instead of 0, and off-zenith
    leakage picks up the projection asymmetry. The engines take these
    as any power beam (amps = B_pq * flux); B_XY is sign-indefinite."""
    dircos = torch.as_tensor(dircos, dtype=torch.float32)
    ax = np.radians(float(x_orientation_deg))
    ay = np.radians(float(y_orientation_deg))
    px = (np.cos(ax), np.sin(ax), 0.0)
    py = (np.cos(ay), np.sin(ay), 0.0)
    # zenith row appended for the normalization
    zen = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float32,
                       device=dircos.device)
    dall = torch.cat([dircos, zen], dim=0)
    kw = dict(length=length, ground_height=ground_height,
              short_dipole=short_dipole, half_wave=half_wave)
    amp_x, ev_x = dipole_jones(dall, freqs, orientation_dircos=px, **kw)
    amp_y, ev_y = dipole_jones(dall, freqs, orientation_dircos=py, **kw)
    dot_xx = torch.sum(ev_x * ev_x, dim=1)[:, None]      # (S+1, 1)
    dot_yy = torch.sum(ev_y * ev_y, dim=1)[:, None]
    dot_xy = torch.sum(ev_x * ev_y, dim=1)[:, None]
    b_xx = amp_x * amp_x * dot_xx
    b_yy = amp_y * amp_y * dot_yy
    b_xy = amp_x * amp_y * dot_xy
    zx = torch.clamp(b_xx[-1:], min=1e-30)               # (1, C)
    zy = torch.clamp(b_yy[-1:], min=1e-30)
    return {"XX": b_xx[:-1] / zx,
            "YY": b_yy[:-1] / zy,
            "XY": b_xy[:-1] / torch.sqrt(zx * zy)}


def _single(x):
    """x as a complex64 or float32 tensor (what a JAX array of it holds
    without 64-bit mode), on its own device."""
    t = torch.as_tensor(x)
    return t.to(torch.complex64 if t.is_complex() else torch.float32)


def mueller_from_jones(jx_theta, jx_phi, jy_theta, jy_phi):
    """Unpolarized-sky Mueller weights from complex Jones components
    on any (theta_hat, phi_hat) transverse basis: B_pq = J_p . J_q^*.

    Returns {XX, YY (real float32), XY (complex64)}; B_YX =
    conj(B_XY). For external full-pol beams (e.g. simulated Jones
    tables) where the feed response carries phase."""
    jxt, jxp, jyt, jyp = (_single(x) for x in (jx_theta, jx_phi, jy_theta,
                                               jy_phi))
    b_xx = (jxt.abs() ** 2 + jxp.abs() ** 2).to(torch.float32)
    b_yy = (jyt.abs() ** 2 + jyp.abs() ** 2).to(torch.float32)
    b_xy = (jxt * jyt.conj() + jxp * jyp.conj()).to(torch.complex64)
    return {"XX": b_xx, "YY": b_yy, "XY": b_xy}
