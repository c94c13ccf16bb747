"""Wrapper of kernel K2, the hand-written CUDA banded spread (csrc/banded.cu).

K2 replaces the TPU kernel prisim_tpu/engine/nufft_banded.py::_sweep_kernel.
It is output-stationary: each block owns 32 rows x 64 columns of one
baseline's (R_max, 2r) delay rows and walks that baseline's source stream,
skipping tiles whose sources cannot reach its rows; sums are float64 (see
the note at the top of csrc/banded.cu).

`banded_spread_cuda` takes the arguments of
nufft_banded.banded_spread_plain. A CUDA tensor launches the kernel (or
raises); a CPU tensor runs the plain version, and only because it lies on
the CPU. `banded_spread_cuda.launches` counts kernel launches and nothing
else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_kernel_library
from . import nufft_banded as _nb

__all__ = ["banded_spread_cuda", "KERNEL_SOURCE", "TPU_KERNEL"]

KERNEL_SOURCE = "prisim_tpu_torch/csrc/banded.cu"
TPU_KERNEL = "prisim_tpu/engine/nufft_banded.py:319"

_TILE = 128            # sources per tile in the kernel (kST)


@functools.cache
def _library():
    """The K2 library, built or loaded, with its argument types bound."""
    lib = load_kernel_library("banded")
    fn = lib.prisim_banded_k2
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 4 + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(plan, u_h, u_l, P_r):
    if not all(isinstance(t, torch.Tensor) for t in (u_h, u_l, P_r)):
        raise TypeError("u_h, u_l and P_r must be torch.Tensors")
    S = P_r.shape[1] if P_r.dim() == 2 else -1
    if P_r.dim() != 2 or P_r.shape[0] != plan.rank or S < 1:
        raise ValueError("P_r must have shape (rank=%d, S_pad), got %s"
                         % (plan.rank, tuple(P_r.shape)))
    if P_r.dtype not in (torch.float32, torch.float64):
        raise TypeError("P_r must be float32 or float64, got %s" % P_r.dtype)
    for name, t in (("u_h", u_h), ("u_l", u_l)):
        if t.dtype != torch.float32:
            raise TypeError("%s must be float32, got %s" % (name, t.dtype))
        if t.numel() != plan.ndir * S:
            raise ValueError("%s must hold D*S_pad = %d values, got %s"
                             % (name, plan.ndir * S, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != P_r.device:
            raise ValueError("%s is on %s, P_r on %s"
                             % (name, t.device, P_r.device))


# K2's per-baseline tables and tap polynomials, in its argument order
_TABLES = (("blen_hi", torch.float32), ("blen_lo", torch.float32),
           ("d_of_b", torch.int32), ("blk_lo", torch.int32),
           ("n_blk", torch.int32), ("tap_w", torch.float64))


def banded_spread_cuda(plan, u_h, u_l, P_r):
    """K2 banded spread: float64 rows (B, R_max, 2r) of `plan`.

    u_h/u_l: float32 two-float u streams, D*S_pad values (_prep's
    (1, D*S_pad)); P_r (r, S_pad) float32 or float64 payload, on one
    device."""
    _check_inputs(plan, u_h, u_l, P_r)
    if P_r.device.type == "cpu":
        return _nb.banded_spread_plain(plan, u_h, u_l, P_r)
    if P_r.device.type != "cuda":
        raise ValueError("banded_spread_cuda runs on CUDA or CPU tensors, "
                         "got %s" % P_r.device)
    dev = P_r.device
    B, r, R, D = plan.nbl, plan.rank, plan.R_max, plan.ndir
    S = P_r.shape[1]
    tables = [plan.tensor(name, dev, dt) for name, dt in _TABLES]
    P64 = P_r.to(torch.float64).contiguous()
    urange = torch.empty((D, -(-S // _TILE), 2), dtype=torch.float32,
                         device=dev)
    out = torch.empty((B, R, 2 * r), dtype=torch.float64, device=dev)
    ivh, ivl = _nb._split(plan.consts["inv_ch"])
    nmh, nml = _nb._split(plan.consts["numid_c"])
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.prisim_banded_k2(
            u_h.data_ptr(), u_l.data_ptr(), P64.data_ptr(),
            *(t.data_ptr() for t in tables), urange.data_ptr(),
            out.data_ptr(), D, S, B, R, r, plan.K, plan.tap_w.shape[1],
            plan.G_blk,
            float(ivh), float(ivl), float(nmh), float(nml),
            float(plan.consts["inv_ch"]), stream)
    if err != 0:
        raise RuntimeError("K2 launch failed with cudaError_t %d" % err)
    banded_spread_cuda.launches += 1
    return out


banded_spread_cuda.launches = 0
