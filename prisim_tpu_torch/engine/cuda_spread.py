"""Wrapper of kernel delay_spread (csrc/spread.cu), the delay-grid spread of
the delay-space NUFFT engine, and its plain PyTorch version.

The kernel replaces prisim_tpu/engine/nufft_delay.py::
nufft_delay_multirank_sorted, an XLA function (not a Pallas kernel) that the
reference's sorted, scatter and gather spreads all compute in different
forms. Set-up here, in torch: the delays are folded onto the grid once in
float64 (nufft_delay.fold_delay_bins: bins m0 and offsets z0), and each
baseline's sources are sorted by bin (torch.sort). The kernel walks each
baseline's sorted sources and adds each run of equal bins to the grid
once per rank (see the note at the top of csrc/spread.cu).

`delay_spread_cuda` launches the kernel for CUDA tensors (or raises) and
runs `delay_spread_plain` for CPU tensors, only because they lie on the
CPU. `delay_spread_cuda.launches` counts kernel launches and nothing else;
kernel_args and launch split a call into its set-up and its launch, for
timing the kernel alone. The snapshot functions drop the sources below
the horizon before their beam, and those with an all-zero payload
(nufft_delay.live_sources) before their delays: a zero payload would add
exact zeros.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from .. import tracing
from .._build import load_kernel_library
from .nufft_delay import _alpha, fold_delay_bins, kb_tap_coeffs

__all__ = ["delay_spread_cuda", "delay_spread_plain", "spread_inputs",
           "kernel_args", "launch", "KERNEL_SOURCE", "TPU_KERNEL"]

KERNEL_SOURCE = "prisim_tpu_torch/csrc/spread.cu"
TPU_KERNEL = ("prisim_tpu/engine/nufft_delay.py::nufft_delay_multirank_sorted"
              " (:590; XLA, not Pallas)")

_P, _I, _D, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_longlong)
_SEG = 1024           # sorted sources of one baseline per block


@functools.cache
def _library():
    """The spread library, built or loaded, with its argument types."""
    lib = load_kernel_library("spread")
    lib.prisim_delay_spread.argtypes = ([_P] * 6 + [_L, _P, _I, _I, _D, _P]
                                        + [_I] * 5 + [_P])
    lib.prisim_delay_spread.restype = ctypes.c_int
    for fn in (lib.prisim_spread_max_taps, lib.prisim_spread_max_coef):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _taps(K, alpha, dev):
    """kb_tap_coeffs(K, alpha) as a float64 tensor on `dev`, fitted and
    uploaded once."""
    return torch.as_tensor(kb_tap_coeffs(K, alpha), dtype=torch.float64,
                           device=dev).contiguous()


def spread_inputs(tau_h, tau_l, P, nu0, dnu, nchan, beta=2.0, chan0=None):
    """What both versions spread, checked: a dict of the delays th/tl
    (S, B) float32, the payload P float64 (S, r) or (B, S, r), the folded
    bins m0 (S, B) int32 and offsets z0 (S, B) float64, n, and the carrier
    frequency nu_c = nu0 + (C/2 + chan0) dnu."""
    for name, t in (("tau_h", tau_h), ("tau_l", tau_l), ("P", P)):
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
    if tau_h.dim() != 2 or tau_l.shape != tau_h.shape:
        raise ValueError("tau_h and tau_l must be (S, B), got %s and %s"
                         % (tuple(tau_h.shape), tuple(tau_l.shape)))
    if tau_h.dtype != torch.float32 or tau_l.dtype != torch.float32:
        raise TypeError("tau_h and tau_l must be float32 (two-float)")
    S, B = tau_h.shape
    if not ((P.dim() == 2 and P.shape[0] == S)
            or (P.dim() == 3 and P.shape[:2] == (B, S))):
        raise ValueError("P must be (S, r) or (B, S, r) with S=%d, B=%d; "
                         "got %s" % (S, B, tuple(P.shape)))
    if P.device != tau_h.device or tau_l.device != tau_h.device:
        raise ValueError("tau_h, tau_l and P must lie on one device")
    m0, z0, n = fold_delay_bins(tau_h, tau_l, dnu, nchan, beta=beta)
    nu_c = float(nu0) + (nchan // 2 + float(chan0 or 0)) * float(dnu)
    return dict(th=tau_h, tl=tau_l, P=P.double(), m0=m0, z0=z0, n=n,
                nu_c=nu_c)


def _carrier(x):
    """(cos, -sin) of 2 pi frac(tau nu_c), float64 (S_l, B)."""
    cyc = (x["th"].double() + x["tl"].double()) * x["nu_c"]
    ang = (2.0 * np.pi) * (cyc - torch.round(cyc))
    return torch.cos(ang), -torch.sin(ang)


def delay_spread_plain(tau_h, tau_l, P, nu0, dnu, nchan, beta=2.0, K=13,
                       alpha=None, chan0=None):
    """The plain version of kernel delay_spread: float64 index_add_ over
    the flattened (b n + bin) index, one tap at a time.

    tau_h/tau_l (S, B) float32 two-float delays; P (S, r) or (B, S, r)
    payload; alpha the KB shape (None: the reference's default for K,
    beta); chan0 a channel shard's offset. Returns the grid (B, n, r)
    complex128:
    grid[b, (m0 + j) mod n, i] += w_j(z0) P[s, i] e^{-2 pi i frac(tau nu_c)}
    over sources s and taps j = -K/2..K/2."""
    return _plain(spread_inputs(tau_h, tau_l, P, nu0, dnu, nchan, beta,
                                chan0), K, _alpha(K, beta, alpha))


def _plain(x, K, alpha):
    """delay_spread_plain's grid of the checked inputs `x` (spread_inputs)
    with the KB shape `alpha`."""
    th, P, m0, z0, n = x["th"], x["P"], x["m0"], x["z0"], x["n"]
    dev = th.device
    S, B = th.shape
    r = P.shape[-1]
    cos, nsin = _carrier(x)
    taps = _taps(K, float(alpha), torch.device("cpu")).numpy()
    half = K // 2
    out = torch.zeros((B * n, 2 * r), dtype=torch.float64, device=dev)
    base = torch.arange(B, device=dev) * n
    # baselines per step: the (S, b, 2r) contributions stay near 2^23 values
    step = max(1, (1 << 22) // max(1, S * r))
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        Pb = (P[:, None, :] if P.dim() == 2
              else P[b0:b1].transpose(0, 1))                  # (S, b, r)
        X = torch.cat([Pb * cos[:, b0:b1, None],
                       Pb * nsin[:, b0:b1, None]], dim=-1)
        z = z0[:, b0:b1]
        m = m0[:, b0:b1].long()
        for jj, co in enumerate(taps):
            w = torch.full_like(z, float(co[0]))
            for c in co[1:].tolist():
                w = w * z + c
            idx = base[None, b0:b1] + torch.remainder(m + (jj - half), n)
            out.index_add_(0, idx.reshape(-1),
                           (w[..., None] * X).reshape(-1, 2 * r))
    return torch.complex(out[:, :r], out[:, r:]).reshape(B, n, r)


def kernel_args(tau_h, tau_l, P, nu0, dnu, nchan, beta=2.0, K=13,
                alpha=None, chan0=None, setup=None):
    """The arguments of one delay_spread launch on CUDA tensors: the
    set-up (bins, the sort unless `setup` is given, the (B, S) layouts,
    the zeroed grid) done, the launch not. A dict for launch()."""
    x = spread_inputs(tau_h, tau_l, P, nu0, dnu, nchan, beta, chan0)
    alpha = _alpha(K, beta, alpha)
    th, P, m0, n = x["th"], x["P"], x["m0"], x["n"]
    dev = th.device
    S, B = th.shape
    r = P.shape[-1]
    taps = _taps(K, float(alpha), dev)
    lib = _library()
    if K > lib.prisim_spread_max_taps() or \
            taps.shape[1] > lib.prisim_spread_max_coef():
        raise ValueError("delay_spread takes at most %d taps of %d "
                         "coefficients, got K=%d of %d"
                         % (lib.prisim_spread_max_taps(),
                            lib.prisim_spread_max_coef(), K, taps.shape[1]))
    m0T = m0.t().contiguous()                                    # (B, S)
    if setup is None:
        keys, perm = torch.sort(m0T, dim=1, stable=True)
    else:
        perm = setup[0].t()
        keys = torch.gather(m0T, 1, perm)
    return dict(th=th.t().contiguous(), tl=x["tl"].t().contiguous(),
                z0=x["z0"].t().contiguous(), keys=keys.contiguous(),
                perm=perm.to(torch.int32).contiguous(), P=P.contiguous(),
                p_bstride=S * r if P.dim() == 3 else 0, taps=taps, K=K,
                nu_c=x["nu_c"], S=S, B=B, r=r, n=n,
                grid=torch.zeros((B, n, r), dtype=torch.complex128,
                                 device=dev))


def launch(a):
    """Launch delay_spread on the arguments of kernel_args (adding into
    a["grid"]), count it, and return the grid."""
    if a["S"] == 0:
        return a["grid"]
    with torch.cuda.device(a["grid"].device):
        err = _library().prisim_delay_spread(
            a["th"].data_ptr(), a["tl"].data_ptr(), a["z0"].data_ptr(),
            a["keys"].data_ptr(), a["perm"].data_ptr(), a["P"].data_ptr(),
            a["p_bstride"], a["taps"].data_ptr(), a["K"],
            a["taps"].shape[1], a["nu_c"],
            torch.view_as_real(a["grid"]).data_ptr(), a["S"], a["B"],
            a["r"], a["n"], _SEG, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("delay_spread launch failed with cudaError_t %d"
                           % err)
    delay_spread_cuda.launches += 1
    return a["grid"]


def delay_spread_cuda(tau_h, tau_l, P, nu0, dnu, nchan, beta=2.0, K=13,
                      alpha=None, chan0=None, setup=None):
    """Kernel delay_spread: the grid (B, n, r) complex128 that
    delay_spread_plain returns, for CUDA tensors; the plain version for
    CPU tensors. `setup` (order, starts) from nufft_delay.
    _sorted_spread_setup on these delays' bins skips the kernel's sort
    (the plain version needs no sort).

    Two spans: "spread.sort", the bins and, on a card, the per-baseline
    sort, the kernel's (B, S) layouts and the zeroed grid (kernel_args);
    then "spread", the launch (or the plain spread), which counts the
    (source, baseline) pairs it spreads as spread.pairs."""
    dev = tau_h.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("delay_spread_cuda runs on CUDA or CPU tensors, got "
                         "%s" % dev)
    on_card = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
    with on_card:
        with tracing.span("spread.sort"):
            if dev.type == "cpu":
                a = spread_inputs(tau_h, tau_l, P, nu0, dnu, nchan, beta,
                                  chan0)
            else:
                a = kernel_args(tau_h, tau_l, P, nu0, dnu, nchan, beta=beta,
                                K=K, alpha=alpha, chan0=chan0, setup=setup)
        with tracing.span("spread"):
            tracing.count("spread.pairs", tau_h.shape[0] * tau_h.shape[1])
            if dev.type == "cpu":
                return _plain(a, K, _alpha(K, beta, alpha))
            return launch(a)


delay_spread_cuda.launches = 0
tracing.register_launches("delay_spread",
                          lambda: delay_spread_cuda.launches)
