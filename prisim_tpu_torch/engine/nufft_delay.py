"""Delay-space NUFFT pieces that the banded engine (nufft_banded.py) uses.

Counterpart of the host parts of prisim_tpu/engine/nufft_delay.py: the
Kaiser-Bessel spreading kernel and its Fourier transform, the per-tap
polynomial fits the spread evaluates, the fixed Chebyshev spectral basis
in ln(nu) (projection form and node form) and the blocked spectral
projection. The scatter, gather and sorted spreads of that module are not
ported: they were the TPU's way round having no fast scatter, and the
banded engine replaces them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["kb_kernel", "kb_fourier", "kb_tap_coeffs", "chebyshev_projection",
           "chebyshev_node_model", "NodeModel", "spectral_project"]


def kb_kernel(z, K, alpha):
    """Kaiser-Bessel spreading kernel w(z) on |z| <= K/2 (z in grid
    units), zero outside."""
    arg = 1.0 - (2.0 * z / K) ** 2
    inside = arg > 0
    out = np.zeros_like(np.asarray(z, dtype=np.float64))
    out[inside] = np.i0(alpha * np.sqrt(arg[inside])) / np.i0(alpha)
    return out


def kb_fourier(k_over_n, K, alpha):
    """Continuous Fourier transform of the KB kernel at xi = k/n cycles
    per grid step: (K/I0(alpha)) sinh(sqrt(alpha^2 - (pi K xi)^2)) /
    sqrt(...), continued to sinc where the argument turns imaginary."""
    xi = np.asarray(k_over_n, dtype=np.float64)
    t = alpha ** 2 - (np.pi * K * xi) ** 2
    out = np.empty_like(t)
    pos = t > 0
    rt = np.sqrt(np.abs(t))
    out[pos] = np.sinh(rt[pos]) / rt[pos]
    out[~pos] = np.sinc(rt[~pos] / np.pi)
    return K * out / np.i0(alpha)


def kb_tap_coeffs(K, alpha, degree=12):
    """Per-tap polynomial fits of the KB kernel: tap j's weight
    w_j(z0) = kb(z0 - j) on z0 in [-1/2, 1/2], fit by a degree-`degree`
    Chebyshev series at 64 nodes and converted to monomials. Returns
    (K, degree+1) float64, highest degree first (np.polyval order)."""
    half = K // 2
    z = np.polynomial.chebyshev.chebpts1(64) * 0.5
    out = np.empty((K, degree + 1))
    for idx, j in enumerate(range(-half, half + 1)):
        w = kb_kernel(z - j, K, alpha)
        cheb = np.polynomial.chebyshev.Chebyshev.fit(z, w, degree,
                                                     domain=[-0.5, 0.5])
        out[idx] = cheb.convert(kind=np.polynomial.Polynomial).coef[::-1]
    return out


def chebyshev_projection(freqs, rank):
    """Fixed spectral basis: (pinvQ (C, r), Q (C, r)) float32 with
    P = amps @ pinvQ. The pseudo-inverse is taken of the float32-cast
    basis, so that P @ Q.T is a true projection for the f32 Q."""
    freqs = np.asarray(freqs, dtype=np.float64)
    C = freqs.size
    x = np.log(freqs / freqs[C // 2])
    x = 2.0 * (x - x.min()) / (x.max() - x.min()) - 1.0
    Q = np.polynomial.chebyshev.chebvander(x, rank - 1)
    Qf = Q.astype(np.float32)
    return (np.linalg.pinv(Qf.astype(np.float64)).T.astype(np.float32),
            Qf)


@dataclass
class NodeModel:
    """Static pieces of the rank-r spectral node model
    (chebyshev_node_model)."""
    nu_nodes: np.ndarray
    node2coef: np.ndarray
    V: np.ndarray
    Q: np.ndarray
    expand: np.ndarray
    node2coef64: np.ndarray = None
    Q64: np.ndarray = None


def chebyshev_node_model(freqs, rank):
    """Node form of the rank-r spectral model: beam x flux is evaluated at
    the rank Chebyshev nodes of the band (in scaled ln nu) and the amps
    are the unique degree-(r-1) interpolant, so the engine never holds an
    (S, C) table.

    Returns a NodeModel with
      nu_nodes  (r,)  f64  node frequencies
      node2coef (r, r) f32  P = amps_at_nodes @ node2coef
      V         (r, r) f32  values_at_nodes = coefficients @ V.T
      Q         (C, r) f32  full-grid basis (chebyshev_projection's x)
      expand    (C, r) f32  amps_full = amps_at_nodes @ expand.T
    and the float64 node2coef64 and Q64."""
    freqs = np.asarray(freqs, dtype=np.float64)
    C = freqs.size
    x = np.log(freqs / freqs[C // 2])
    xlo, xhi = x.min(), x.max()
    xs = 2.0 * (x - xlo) / (xhi - xlo) - 1.0
    t = np.polynomial.chebyshev.chebpts1(rank)
    x_nodes = xlo + (t + 1.0) * 0.5 * (xhi - xlo)
    nu_nodes = freqs[C // 2] * np.exp(x_nodes)
    V = np.polynomial.chebyshev.chebvander(t, rank - 1)
    Vinv = np.linalg.inv(V)
    Q = np.polynomial.chebyshev.chebvander(xs, rank - 1)
    return NodeModel(
        nu_nodes=nu_nodes, node2coef=Vinv.T.astype(np.float32),
        V=V.astype(np.float32), Q=Q.astype(np.float32),
        expand=(Q @ Vinv).astype(np.float32),
        node2coef64=Vinv.T, Q64=Q)


def spectral_project(amps, pinvQ, block=128):
    """P = amps @ pinvQ in float32 with channel-blocked Kahan accumulation:
    each block of `block` channels is one matmul, and the block partials
    are Kahan-summed, as the JAX package does (a single f32 matmul's
    rounding is value-correlated across sources of one spectral family).
    amps (S, C) and pinvQ (C, r) are float32 tensors or arrays on one
    device; returns (S, r) float32."""
    amps = torch.as_tensor(amps, dtype=torch.float32)
    W = torch.as_tensor(pinvQ, dtype=torch.float32, device=amps.device)
    S, C = amps.shape
    r = W.shape[1]
    nb = -(-C // block)
    if nb * block != C:
        amps = torch.nn.functional.pad(amps, (0, nb * block - C))
        W = torch.nn.functional.pad(W, (0, 0, 0, nb * block - C))
    parts = torch.einsum("snc,ncr->nsr", amps.reshape(S, nb, block),
                         W.reshape(nb, block, r))
    tot = torch.zeros((S, r), dtype=torch.float32, device=amps.device)
    comp = torch.zeros_like(tot)
    for p in parts:
        y = p - comp
        t = tot + y
        comp = (t - tot) - y
        tot = t
    return tot
