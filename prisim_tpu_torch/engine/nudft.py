"""Non-uniform DFT visibilities: the plain PyTorch version of kernels K1a,
K1b and K1c.

Computes, on a uniform channel grid nu_c = nu0 + (chan0 + c) dnu,

    V(b, c)   = sum_s A(s, c) w(s, b, c) exp(-2 pi i nu_c (s_eff . b) / c)
    G_k(b, c) = sum_s s_sky,k(s) A(s, c) w(s, b, c) exp(...)    (gradient)

where s_eff = s_sky - pc is the effective direction, s_sky the rotated
ENU direction, and w the gaussian weight of an extended source,
w = exp(-0.5 (u_proj / sigma)^2) with u_proj = sqrt(|b|^2 - (s_sky.b)^2)
nu_c / c (w = 1 for a point source, sigma = inf, or without shapes). The
structure is that of prisim_tpu/engine/nudft.py:

* the cycle count nu (s.b)/c is two-float (see ../twofloat.py), reduced
  mod 1 exactly;
* U.W factorization: with c = q L + r, the phasor is U[s,b,q] W[s,b,r],
  so only S B (Q + L) phasors are formed, by float64 anchored rotations
  as in the kernels (every mode): along chains of `anchor` steps only the
  first phasor and the step phasor are evaluated, the others are products
  by the step (`_phasors_rot`);
* sources stream in blocks of `src_block`; the weights and the gradient
  moments are taken per coarse group q, so no (src_block, B, C) table is
  built.

Unlike the JAX engines, the phasors are evaluated in float64 from the
reduced two-float cycle counts, and the products are summed in float64.
On the card's slice shape an f32 phasor and product chain floors at
2.1e-6 of max|V| against the f64 golden even with an exact sum (PERF.md),
above the engines' 2e-6 bar; the f64 chain is exact to the
complex64 rounding of the output. The gaussian weight is float32, from a
float32 exponent alpha (nu_c/c)^2 (`ext_alpha`, `ext_chan_scale`), as in
the TPU kernel; its product with the f32 amplitude is exact in float64.

This module is what a CPU tensor runs, and what the CUDA kernels
(cuda_nudft.py) are held against on the card: they round every step of
the weight as written here. `nudft_reference_f64` is the float64 golden
of the same sums.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as CNST
from .. import twofloat as tf

__all__ = ["nudft_visibilities", "nudft_reference_f64", "freq_grid_scalars",
           "choose_ql", "ext_alpha", "ext_chan_scale", "ANCHOR"]

# The phasor chain length (anchor period) of every mode, set by
# measurement (profile_banded.py --k1-anchors, PERF.md): at 4, 8, 16 and
# 32 the error against the f64 golden is the same, and 16 is the fastest
# for K1a and K1c and within 3% of the fastest (32) for K1b. In float64 a
# chain of 16 products drifts by ~1e-15.
ANCHOR = 16


def freq_grid_scalars(nu0, dnu):
    """Host-side: (nu0/c, dnu/c) as two-float32 scalars, returned as
    Python floats that are exact float32 values."""
    g0h, g0l = tf.split_f64(np.float64(nu0) / CNST.c)
    gdh, gdl = tf.split_f64(np.float64(dnu) / CNST.c)
    return (float(g0h), float(g0l), float(gdh), float(gdl))


def choose_ql(nchan):
    """Pick the channel factorization C <= Q*L with L ~ sqrt(C), L a power
    of two."""
    L = 1
    while L * L < nchan:
        L *= 2
    Q = -(-nchan // L)
    return Q, L


def ext_alpha(s_sky, sigma, blh, bll):
    """Exponent scale of the gaussian weight, alpha = |b_perp|^2 /
    (2 sigma^2) with |b_perp|^2 = max(|b|^2 - (s_sky . b)^2, 0), per
    (source, baseline): float64 from the float32 inputs (b = blh + bll),
    each operation rounded once in the order written, then rounded to
    float32. sigma = inf (a point source) gives 0.

    s_sky (S, 3), sigma (S,), blh/bll (B, 3) float32. Returns (S, B)
    float32."""
    b = blh.double() + bll.double()
    s = s_sky.double()
    ksky = (s[:, None, 0] * b[None, :, 0] + s[:, None, 1] * b[None, :, 1]
            + s[:, None, 2] * b[None, :, 2])
    bl2 = b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1] + b[:, 2] * b[:, 2]
    proj2 = torch.clamp(bl2[None, :] - ksky * ksky, min=0.0)
    sig = sigma.double()
    return ((0.5 * proj2) / (sig * sig)[:, None]).float()


def ext_chan_scale(grid_scalars, nchan, chan0=0, device="cpu"):
    """(nu_c / c)^2 for channels chan0 .. chan0 + nchan - 1: nu_c/c =
    g0 + gd (chan0 + c) in float64 from the two-float grid scalars (each
    of g0, gd exact in float64), squared, rounded to float32. Returns
    (nchan,) float32."""
    g0h, g0l, gdh, gdl = (float(v) for v in grid_scalars)
    c = torch.arange(int(nchan), dtype=torch.float64, device=device)
    x = (g0h + g0l) + (gdh + gdl) * (c + float(chan0))
    return (x * x).float()


def _phasors(p0h, p0l, dh, dl, steps):
    """Phasors e^{-2 pi i frac(p0 + k*d)} for the integer steps k.

    p0, d: (S, B) two-floats; steps: (K,) float32 exact integers. The
    reduced two-float cycle count is exact in float64, where the sincos
    is taken. Returns float64 (cos, -sin), each (S, B, K)."""
    k = steps.reshape(1, 1, -1)
    mh, ml = tf.two_prod(dh[..., None], k)
    ml = ml + dl[..., None] * k
    th, tl = tf.df_add(p0h[..., None], p0l[..., None], mh, ml)
    th, tl = tf.df_frac(th, tl)
    ang = (2.0 * np.pi) * (th.double() + tl.double())
    return torch.cos(ang), -torch.sin(ang)


def _phasors_rot(p0h, p0l, dh, dl, n, stride, start, anchor):
    """Phasors e^{-2 pi i frac(p0 + (start + m stride) d)} for m < n by
    anchored rotations: the anchors m = 0, anchor, 2 anchor, ... and the
    step e^{-2 pi i stride d} by _phasors, the phasors between them by
    complex products with the step in float64, each product rounded as
    kernel K1a rounds it ((x.re y.re - x.im y.im, x.re y.im + x.im y.re)).
    Returns float64 (cos, -sin), each (S, B, n)."""
    dev = p0h.device
    steps = (torch.arange(0, n, anchor, dtype=torch.float32, device=dev)
             * float(stride) + float(start))
    xc, xs = _phasors(p0h, p0l, dh, dl, steps)                 # (S, B, nA)
    zero = torch.zeros_like(p0h)
    rc, rs = _phasors(zero, zero, dh, dl, torch.tensor(
        [float(stride)], dtype=torch.float32, device=dev))     # (S, B, 1)
    cs, ss = [xc], [xs]
    for _ in range(1, min(anchor, n)):
        xc, xs = xc * rc - xs * rs, xc * rs + xs * rc
        cs.append(xc)
        ss.append(xs)
    S, B = p0h.shape
    return tuple(torch.stack(v, dim=-1).reshape(S, B, -1)[..., :n]
                 for v in (cs, ss))


def _source_block_vis(seh, sel, blh, bll, amps, g, Q, L, chan0, s_sky=None,
                      alpha=None, k2=None, anchor=None):
    """Visibility contribution of one source block: float64 (re, im),
    each (B, Q*L), and when s_sky is given the moments (re, im), each
    (3, B, Q*L).

    seh/sel: (S, 3) effective direction cosines, two-float
    blh/bll: (B, 3) baselines (m), two-float
    amps:    (S, Q*L) beam-weighted fluxes (padded channels are zero)
    g:       (g0h, g0l, gdh, gdl) float32 0-d tensors
    s_sky:   (S, 3) float32 sky directions, for the gradient moments
    alpha:   (S, B) float32 ext_alpha, with k2 (Q*L,) float32
             ext_chan_scale: the gaussian weight exp(-alpha k2)
    anchor:  chain length of anchored rotations for U and W (None: every
             phasor evaluated)"""
    g0h, g0l, gdh, gdl = g
    kh, kl = tf.df_dot3(seh[:, None, :], sel[:, None, :],
                        blh[None, :, :], bll[None, :, :])      # (S, B) m
    p0h, p0l = tf.df_frac(*tf.df_mul(kh, kl, g0h, g0l))
    dh, dl = tf.df_frac(*tf.df_mul(kh, kl, gdh, gdl))
    S, B = kh.shape
    dev = seh.device
    zero = torch.zeros_like(p0h)
    if anchor:
        Uc, Us = _phasors_rot(p0h, p0l, dh, dl, Q, L, chan0, anchor)
        Wc, Ws = _phasors_rot(zero, zero, dh, dl, L, 1, 0, anchor)
    else:
        q_steps = (torch.arange(Q, dtype=torch.float32, device=dev)
                   * float(L) + float(chan0))
        r_steps = torch.arange(L, dtype=torch.float32, device=dev)
        Uc, Us = _phasors(p0h, p0l, dh, dl, q_steps)            # (S, B, Q)
        Wc, Ws = _phasors(zero, zero, dh, dl, r_steps)          # (S, B, L)
    A = amps.double().reshape(S, Q, L)
    gradient = s_sky is not None
    nrow = 8 if gradient else 2
    sk = s_sky.double() if gradient else None
    out = torch.empty((B, Q, nrow, 2 * L), dtype=torch.float64, device=dev)
    for q in range(Q):
        Aq = A[:, q, :][:, None, :]                             # (S, 1, L)
        if alpha is not None:
            w = torch.exp(-(alpha[:, :, None] * k2[q * L:(q + 1) * L]))
            Aq = Aq * w.double()                                # (S, B, L)
        # rhs (B, S, 2L) = [A W_re | A W_im]; lhs (B, nrow, S) holds the
        # rows U_re, U_im, then s_k U_re, s_k U_im for the moments
        rhs = torch.cat([Aq * Wc, Aq * Ws], dim=2).permute(1, 0, 2)
        U = torch.stack([Uc[:, :, q], Us[:, :, q]], dim=0)       # (2, S, B)
        if gradient:
            U = torch.cat([U] + [U * sk[None, :, k, None] for k in range(3)])
        out[:, q] = torch.bmm(U.permute(2, 0, 1), rhs)          # (B, nrow, 2L)
    re = out[:, :, 0::2, :L] - out[:, :, 1::2, L:]              # (B, Q, n, L)
    im = out[:, :, 0::2, L:] + out[:, :, 1::2, :L]
    re, im = (x.permute(2, 0, 1, 3).reshape(nrow // 2, B, Q * L)
              for x in (re, im))
    if gradient:
        return re[0], im[0], re[1:], im[1:]
    return re[0], im[0]


def nudft_visibilities(seh, sel, blh, bll, amps, grid_scalars, nchan,
                       chan0=0, src_shape_sigma=None, s_sky=None,
                       inv_wl=None, src_block=512, gradient=False,
                       ql=None, anchor=ANCHOR):
    """Full NUDFT over all sources, streamed in source blocks.

    seh/sel : (S, 3) float32 two-float effective dircos (s_hat - pc_hat)
    blh/bll : (B, 3) float32 two-float baselines (m, local ENU)
    amps    : (S, nchan) float32 beam-weighted source fluxes (Jy)
    grid_scalars : freq_grid_scalars(nu0, dnu)
    src_shape_sigma : optional (S,) float32 gaussian sigma in uv units
        (inf for a point source); needs s_sky
    s_sky   : (S, 3) float32 rotated sky directions (ENU)
    inv_wl  : optional (>= nchan,) 1/lambda of channels chan0.., as the
        reference takes it for the gaussian weights; the wavelengths come
        from grid_scalars, and a given inv_wl is only checked against them
        (ValueError beyond float32 rounding)
    gradient: also return the moments G_k = sum_s s_sky,k A w E; needs
        s_sky
    ql      : the reference's (Q, L) channel tiling; None or a pair with
        Q * L >= nchan (else ValueError), with no effect here
    anchor  : the chain length of the anchored rotations, as the kernels
        take them in every mode (None or 0: every phasor evaluated)
    Returns complex64 (B, nchan) on the device of the inputs, and with
    `gradient` also the complex64 (3, B, nchan) moments."""
    _check_channel_knobs(grid_scalars, nchan, chan0, inv_wl, ql)
    sr, si = _nudft_sums(seh, sel, blh, bll, amps, grid_scalars, nchan,
                         chan0, src_shape_sigma, s_sky, src_block, gradient,
                         anchor)
    res = torch.complex(sr.float(), si.float())
    if gradient:
        return res[0], res[1:]
    return res[0]


# inv_wl as the reference builds it, freqs_f32 / c in float32, carries the
# float32 roundings of the frequency, of c and of the quotient
_INV_WL_RTOL = 2.0 * float(np.finfo(np.float32).eps)


def _check_channel_knobs(grid_scalars, nchan, chan0=0, inv_wl=None,
                        ql=None):
    """Raise ValueError for a reference `inv_wl` that does not cover the
    nchan channels from chan0 or differs from grid_scalars' 1/lambda by
    more than float32 rounding, and for a `ql` tiling (Q, L) with
    Q * L < nchan."""
    nchan = int(nchan)
    if ql is not None:
        Q, L = ql
        if Q * L < nchan:
            raise ValueError("ql=%r covers %d < nchan=%d channels"
                             % (tuple(ql), Q * L, nchan))
    if inv_wl is None:
        return
    if isinstance(inv_wl, torch.Tensor):
        got = inv_wl.detach().cpu().double().reshape(-1)
    else:
        got = torch.as_tensor(np.array(inv_wl, np.float64)).reshape(-1)
    if got.shape[0] < nchan:
        raise ValueError("inv_wl has %d < nchan=%d channels"
                         % (got.shape[0], nchan))
    g0h, g0l, gdh, gdl = (float(v) for v in grid_scalars)
    want = (g0h + g0l) + (gdh + gdl) * (
        torch.arange(nchan, dtype=torch.float64) + float(chan0))
    err = float(((got[:nchan] - want).abs() / want.abs()).max()) \
        if nchan else 0.0
    if not err <= _INV_WL_RTOL:
        raise ValueError("inv_wl differs from grid_scalars' 1/lambda by "
                         "%.3g relative (float32 rounding: %.3g)"
                         % (err, _INV_WL_RTOL))


def _nudft_sums(seh, sel, blh, bll, amps, grid_scalars, nchan, chan0,
                src_shape_sigma, s_sky, src_block, gradient, anchor):
    """The float64 sums of nudft_visibilities before their complex64
    rounding: (re, im), each (1 or 4, B, nchan)."""
    if (gradient or src_shape_sigma is not None) and s_sky is None:
        raise ValueError("s_sky is required for gradient/extended mode")
    nchan = int(nchan)
    Q, L = choose_ql(nchan)
    C_pad = Q * L
    dev = seh.device
    g = tuple(torch.tensor(v, dtype=torch.float32, device=dev)
              for v in grid_scalars)
    if amps.shape[1] < C_pad:
        amps = torch.nn.functional.pad(amps, (0, C_pad - amps.shape[1]))
    k2 = None
    if src_shape_sigma is not None:
        k2 = ext_chan_scale(grid_scalars, C_pad, chan0, dev)
    S = seh.shape[0]
    B = blh.shape[0]
    nout = 4 if gradient else 1
    sr = torch.zeros((nout, B, C_pad), dtype=torch.float64, device=dev)
    si = torch.zeros_like(sr)
    for s0 in range(0, S, int(src_block)):
        sl = slice(s0, s0 + int(src_block))
        alpha = None
        if src_shape_sigma is not None:
            alpha = ext_alpha(s_sky[sl], src_shape_sigma[sl], blh, bll)
        out = _source_block_vis(
            seh[sl], sel[sl], blh, bll, amps[sl], g, Q, L, chan0,
            s_sky=s_sky[sl] if gradient else None, alpha=alpha, k2=k2,
            anchor=anchor)
        sr[0] += out[0]
        si[0] += out[1]
        if gradient:
            sr[1:] += out[2]
            si[1:] += out[3]
    return sr[:, :, :nchan], si[:, :, :nchan]


def nudft_reference_f64(s_eff, baselines, amps, freqs, s_sky=None,
                        src_shape_sigma=None, gradient=False,
                        src_chunk=2048):
    """Direct float64 evaluation of the same sums, for golden checks (the
    formulas of prisim_tpu.engine.nudft.nudft_reference_f64).

    Inputs are numpy arrays or tensors; the sum runs in float64 on the
    device of `s_eff` (the CPU for numpy input), in source chunks so the
    (chunk, B, C) phase table stays bounded. Returns complex128 (B, C),
    and with `gradient` also the complex128 (3, B, C) moments."""
    dev = s_eff.device if isinstance(s_eff, torch.Tensor) else "cpu"

    def f64(x):
        return None if x is None else torch.as_tensor(
            x, dtype=torch.float64, device=dev)

    s_eff, baselines, amps, freqs, s_sky, sigma = (
        f64(x) for x in (s_eff, baselines, amps, freqs, s_sky,
                         src_shape_sigma))
    B, C = baselines.shape[0], freqs.shape[0]
    vr = torch.zeros((4 if gradient else 1, B, C), dtype=torch.float64,
                     device=dev)
    vi = torch.zeros_like(vr)
    bl_len2 = (baselines ** 2).sum(dim=1)
    for s0 in range(0, s_eff.shape[0], int(src_chunk)):
        sl = slice(s0, s0 + int(src_chunk))
        tau = s_eff[sl] @ baselines.T / CNST.c                  # (s, B)
        phase = 2.0 * np.pi * tau[:, :, None] * freqs[None, None, :]
        ar = amps[sl][:, None, :] * torch.cos(phase)            # (s, B, C)
        ai = -amps[sl][:, None, :] * torch.sin(phase)
        if sigma is not None:
            ksky = s_sky[sl] @ baselines.T
            proj = torch.sqrt(torch.clamp(bl_len2[None, :] - ksky ** 2,
                                          min=0.0))
            u = proj[:, :, None] * (freqs / CNST.c)[None, None, :]
            w = torch.exp(-0.5 * (u / sigma[sl, None, None]) ** 2)
            ar, ai = ar * w, ai * w
        vr[0] += ar.sum(dim=0)
        vi[0] += ai.sum(dim=0)
        if gradient:
            vr[1:] += torch.einsum("sk,sbc->kbc", s_sky[sl], ar)
            vi[1:] += torch.einsum("sk,sbc->kbc", s_sky[sl], ai)
    res = torch.complex(vr, vi)
    if gradient:
        return res[0], res[1:]
    return res[0]
