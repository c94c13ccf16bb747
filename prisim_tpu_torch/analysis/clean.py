"""Hogbom CLEAN for 1-D complex (delay-domain) spectra, batched on one
device.

Counterpart of prisim_tpu/analysis/clean.py (``complex1dClean``,
PRISim's prisim/delay_spectrum.py:133-354, and ``DelaySpectrum.delayClean``,
:1622-1841). JAX runs a ``lax.while_loop`` per spectrum under ``vmap``;
here every spectrum of the flattened batch is one row of (N, n) complex64
tensors on the device, and each iteration updates only the rows still
active, so a finished row keeps its cc, res, niter and stop code exactly as
a run of that spectrum alone would leave them. The loop reads the active
mask on the host only every CHECK_EVERY iterations (extra iterations change
no finished row) and never runs past maxiter.

Semantics matched to the reference:
* the kernel is normalized to peak |k| = 1; the component at the residual
  peak (the first maximum) shifts it by a circular roll, a per-row gather;
* per-iteration clean component = gain * residual_peak;
* termination: |peak| <= threshold * max|input| (relative) or the absolute
  threshold (code 0), OR maxiter (code 1), OR, when a clean box masks out
  more than 2 pixels, in-box MAD <= out-of-box MAD (code 2).
The rms-vs-iteration histories are not returned (as in JAX): the final
in/out MAD and the iteration count are.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["complex_clean_1d", "batch_clean", "clean_rows", "delay_clean_vs"]

CHECK_EVERY = 8


def _wmedian(vals, w):
    """Per-row median of vals where w > 0: sort with +inf padding and
    average the entries at (n-1)//2 and n//2, n the row's count of w > 0."""
    n = vals.shape[-1]
    big = torch.where(w > 0, vals, torch.full_like(vals, float("inf")))
    cnt = (w > 0).sum(dim=-1, keepdim=True)
    s = torch.sort(big, dim=-1).values
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), 0, n - 1)
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, n - 1)
    return (0.5 * (s.gather(-1, lo) + s.gather(-1, hi)))[..., 0]


def _mad(x, w):
    """Per-row weighted median absolute deviation |x - median(x)| over
    w > 0."""
    med = torch.complex(_wmedian(x.real, w), _wmedian(x.imag, w))
    return _wmedian((x - med[:, None]).abs(), w)


def clean_rows(inp, kernel, cbox=None, gain=0.1, maxiter=100,
               threshold=5e-3, threshold_abs=False, use_box_stop=True):
    """CLEAN every row of `inp` (N, n) complex64 with the matching row of
    `kernel` (N, n) and, optionally, of the clean box `cbox` (N, n) (any
    dtype; nonzero = in the box), on their device. Returns a dict of
    tensors on that device: cc, res (N, n) complex64, niter,
    terminated_by (N,) int32, inrms, outrms (N,) float32."""
    inp = inp.to(torch.complex64)
    kernel = kernel.to(torch.complex64)
    dev = inp.device
    N, n = inp.shape
    kernel = kernel / kernel.abs().max(dim=1, keepdim=True).values
    kmaxind = kernel.abs().argmax(dim=1)
    if cbox is None:
        box = torch.ones((N, n), dtype=torch.float32, device=dev)
        has_out = False
    else:
        box = (cbox != 0).to(torch.float32)
        has_out = True
    out_box = 1.0 - box
    box_stop = has_out and use_box_stop
    n_out = out_box.sum(dim=1)
    inp_max = inp.abs().max(dim=1).values
    if threshold_abs:
        lolim = threshold / torch.clamp(inp_max, min=1e-30)
    else:
        lolim = torch.full_like(inp_max, threshold)
    stop_at = lolim * inp_max
    cols = torch.arange(n, device=dev)
    cc = torch.zeros_like(inp)
    res = inp.clone()
    itr = torch.zeros(N, dtype=torch.int32, device=dev)
    code = torch.full((N,), -1, dtype=torch.int32, device=dev)
    active = code < 0
    for step in range(max(int(maxiter), 1)):
        ind = (res.abs() * box).argmax(dim=1)
        maxres = res.gather(1, ind[:, None])[:, 0]
        ccval = gain * maxres
        hit = (cols[None, :] == ind[:, None]) & active[:, None]
        cc = torch.where(hit, cc + ccval[:, None], cc)
        shift = ind - kmaxind
        rolled = kernel.gather(1, torch.remainder(cols[None, :]
                                                  - shift[:, None], n))
        res = torch.where(active[:, None], res - ccval[:, None] * rolled, res)
        itr = itr + active.to(torch.int32)
        new = torch.where(maxres.abs() <= stop_at, 0,
                          torch.where(itr >= maxiter, 1, -1)).to(torch.int32)
        if box_stop:
            cond3 = (n_out > 2) & (_mad(res, box) <= _mad(res, out_box))
            new = torch.where((new < 0) & cond3, 2, new).to(torch.int32)
        code = torch.where(active, new, code)
        active = code < 0
        if (step + 1) % CHECK_EVERY == 0 and not bool(active.any()):
            break
    inrms = _mad(res, box)
    outrms = (_mad(res, out_box) if has_out
              else torch.zeros(N, dtype=torch.float32, device=dev))
    return dict(cc=cc, res=res, niter=itr, inrms=inrms, outrms=outrms,
                terminated_by=code)


def batch_clean(specs, kernels, cboxes=None, gain=0.1, maxiter=100,
                threshold=5e-3, threshold_abs=False, use_box_stop=True,
                device="cuda"):
    """CLEAN every spectrum along the last axis of `specs` (..., n) on
    `device` ('cuda' raises without a card); kernels (..., n) and cboxes
    (..., n) bool (or None: no box, no box stop, outrms 0) broadcast to
    it. Arrays or tensors. Returns a dict of host numpy arrays, cc/res
    (..., n) and niter, terminated_by, inrms, outrms (...,) (the
    reference's Pool fan-out, PRISim's prisim/delay_spectrum.py:1748-1777,
    as one batch)."""
    from ..driver import resolve_device
    dev = resolve_device(device)

    def _t(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype)
        x = np.array(x)               # a writable copy, in native order
        return torch.as_tensor(x.astype(x.dtype.newbyteorder("=")),
                               device=dev).to(dtype)

    x = _t(specs, torch.complex64)
    batch_shape, n = tuple(x.shape[:-1]), x.shape[-1]
    k = _t(kernels, torch.complex64).expand(x.shape)
    b = None
    if cboxes is not None:
        b = _t(cboxes, torch.bool).expand(x.shape).reshape(-1, n)
    out = clean_rows(x.reshape(-1, n), k.reshape(-1, n), b, gain=gain,
                     maxiter=maxiter, threshold=threshold,
                     threshold_abs=threshold_abs,
                     use_box_stop=use_box_stop and cboxes is not None)
    return {key: val.cpu().numpy().reshape(
        batch_shape + (() if val.ndim == 1 else (n,)))
        for key, val in out.items()}


def complex_clean_1d(inp, kernel, cbox=None, gain=0.1, maxiter=100,
                     threshold=5e-3, threshold_abs=False, use_box_stop=True,
                     device="cuda"):
    """CLEAN one complex spectrum: inp, kernel (n,) complex; cbox (n,)
    bool or None. Returns dict(cc, res, niter, inrms, outrms,
    terminated_by); terminated_by codes: 0 threshold, 1 maxiter,
    2 inrms <= outrms."""
    out = batch_clean(np.asarray(inp)[None], np.asarray(kernel)[None],
                      None if cbox is None else np.asarray(cbox)[None],
                      gain=gain, maxiter=maxiter, threshold=threshold,
                      threshold_abs=threshold_abs, use_box_stop=use_box_stop,
                      device=device)
    return {key: val[0] for key, val in out.items()}


def delay_clean_vs(vs, pad=1.0, gain=0.1, maxiter=100, threshold=5e-3,
                   horizon_buffer=0.0, device="cuda"):
    """Delay-CLEAN all (bl, time) delay spectra of a VisibilitySet
    (DelaySpectrum.delayClean, PRISim's prisim/delay_spectrum.py:1622):
    delay-transform on `device`, build per-baseline horizon clean boxes
    (|lag| <= |b|/c + buffer), CLEAN every cube present (skyvis, vis,
    noise) on `device`, return a dict with cc/residual lag cubes shaped
    (nbl, nlag, n_acc) and the iteration counts (nbl, n_acc)."""
    from ..vis import delay_transform
    vst = delay_transform(vs, pad=pad, device=device)
    lags = vst.lags
    cubes = {}
    for name in ("skyvis_lag", "vis_lag", "vis_noise_lag"):
        if getattr(vst, name) is not None:
            cubes[name] = np.asarray(getattr(vst, name))
    kern = np.asarray(vst.lag_kernel)
    blc = vs.baseline_lengths / 299792458.0 + horizon_buffer
    cbox = (np.abs(lags)[None, :, None] <=
            blc[:, None, None])                  # (nbl, nlag, 1)
    out = {"lags": lags}
    for name, cube in cubes.items():
        x = np.transpose(cube, (0, 2, 1))        # (nbl, nacc, nlag)
        k = np.transpose(kern, (0, 2, 1))
        b = np.broadcast_to(np.transpose(cbox, (0, 2, 1)), x.shape)
        res = batch_clean(x, k, b, gain=gain, maxiter=maxiter,
                          threshold=threshold, device=device)
        out["cc_" + name] = np.transpose(res["cc"], (0, 2, 1))
        out["res_" + name] = np.transpose(res["res"], (0, 2, 1))
        out["niter_" + name] = res["niter"]
    return out
