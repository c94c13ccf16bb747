"""Wrapper of kernel banded_prep (csrc/prep.cu): the banded engine's prep of
one source chunk in one pass.

The kernel rotates the chunk's celestial two-float source vectors,
subtracts the phase centre, writes the two-float u stream of every
direction with the unit-source check, and, where the truth beam is the
Airy dish's float64 pattern, the float64 payload P_r (r, S_pad) of node
fluxes times airy_beam_df through node2coef64. Its plain version is
nufft_banded.banded_prep_plain, the eager torch chain (observe.df_rotate3,
nufft_banded._prep, and the truth payload of make_coeff_fn_truth), which
make_banded_snapshot_fns takes for CPU tensors; on the TPU, XLA fused that
chain. The u streams, the vectors and ok are the chain's bit for bit, P_r
agrees to float64 rounding (see the note at the top of csrc/prep.cu).

`banded_prep_cuda` launches the kernel for CUDA tensors and raises for any
other. `banded_prep_cuda.launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from .._build import load_kernel_library
from ..beams.analytic import _J1_CHEB64, _airy_df_scale, _airy_tail_cheb

__all__ = ["banded_prep_cuda", "AiryPayload", "MAX_RANK", "KERNEL_SOURCE"]

KERNEL_SOURCE = "prisim_tpu_torch/csrc/prep.cu"
MAX_RANK = 32                    # the kernel's payload keeps r sums a thread

_P = ctypes.c_void_p
_D = ctypes.POINTER(ctypes.c_double)


class AiryPayload(NamedTuple):
    """The truth payload of a chunk for an Airy dish: P = (airy_beam_df at
    the nodes x flux_nodes) @ node2coef64."""
    diameter: float                  # m
    nu_nodes: np.ndarray             # (r,) host float64 node frequencies
    flux_nodes: torch.Tensor         # (S, r) float64
    node2coef64: torch.Tensor        # (r, r) float64


@functools.cache
def _library():
    """The prep library, built or loaded, with its argument types."""
    lib = load_kernel_library("prep")
    lib.prisim_banded_prep.argtypes = (
        [_P] * 8 + [ctypes.c_int] * 3 + [_P] * 9
        + [_D, ctypes.c_int, _D, ctypes.c_int, _D, ctypes.c_int, _P,
           ctypes.c_float, ctypes.c_float, _P])
    lib.prisim_banded_prep.restype = ctypes.c_int
    return lib


@functools.cache
def _series():
    """airy_beam_df's two Chebyshev series as ctypes float64 arrays."""
    j1, tail = np.asarray(_J1_CHEB64), np.asarray(_airy_tail_cheb())
    return ((ctypes.c_double * j1.size)(*j1.tolist()),
            (ctypes.c_double * tail.size)(*tail.tolist()))


def _check(named, dtype, shape, device):
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
        if t.dtype != dtype:
            raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != device:
            raise ValueError("%s is on %s, s_eq_hi on %s"
                             % (name, t.device, device))


def _check_inputs(plan, s_eq_hi, s_eq_lo, Mh, Ml, pch, pcl, airy):
    if not isinstance(s_eq_hi, torch.Tensor):
        raise TypeError("s_eq_hi must be a torch.Tensor")
    S = s_eq_hi.shape[0] if s_eq_hi.dim() == 2 else -1
    if S < 1:
        raise ValueError("s_eq_hi must have shape (S >= 1, 3), got %s"
                         % (tuple(s_eq_hi.shape),))
    dev = s_eq_hi.device
    f32 = torch.float32
    _check((("s_eq_hi", s_eq_hi), ("s_eq_lo", s_eq_lo)), f32, (S, 3), dev)
    _check((("Mh", Mh), ("Ml", Ml)), f32, (3, 3), dev)
    _check((("pch", pch), ("pcl", pcl)), f32, (3,), dev)
    if airy is None:
        return
    r = plan.rank
    if r > MAX_RANK:
        raise ValueError("the kernel's payload takes rank <= %d, got %d"
                         % (MAX_RANK, r))
    if np.shape(airy.nu_nodes) != (r,):
        raise ValueError("nu_nodes must have shape (%d,), got %s"
                         % (r, np.shape(airy.nu_nodes)))
    _check((("flux_nodes", airy.flux_nodes),), torch.float64, (S, r), dev)
    _check((("node2coef64", airy.node2coef64),), torch.float64, (r, r), dev)


def banded_prep_cuda(plan, s_eq_hi, s_eq_lo, Mh, Ml, pch, pcl, airy=None,
                     vectors=False):
    """The prep of one source chunk for `plan`, in one launch.

    s_eq_hi/s_eq_lo (S, 3) float32 celestial two-float source vectors;
    Mh/Ml (3, 3) and pch/pcl (3,) float32 two-float rotation and phase
    centre of the snapshot; airy an AiryPayload (or None: no payload);
    all contiguous, on one CUDA device. Returns (u_h, u_l (1, D*S_pad)
    float32, P_r (r, S_pad) float64 or None, ok 0-d bool tensor, and with
    `vectors` (sh, sl, seh, sel), the (S, 3) float32 rotated and
    phase-centred vectors, else None); S_pad is S rounded up to plan.T_s,
    and ok is False when a source vector is not unit."""
    from .nufft_banded import _PAD_U, _UNIT_U
    _check_inputs(plan, s_eq_hi, s_eq_lo, Mh, Ml, pch, pcl, airy)
    a = None if airy is None else _airy_df_scale(airy.nu_nodes,
                                                 airy.diameter)
    dev = s_eq_hi.device
    if dev.type != "cuda":
        raise ValueError("banded_prep_cuda runs on CUDA tensors, got %s"
                         % dev)
    S, D, r = s_eq_hi.shape[0], plan.ndir, plan.rank
    S_pad = -(-S // plan.T_s) * plan.T_s
    u_h = torch.empty((1, D * S_pad), dtype=torch.float32, device=dev)
    u_l = torch.empty_like(u_h)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    vecs = (tuple(torch.empty((S, 3), dtype=torch.float32, device=dev)
                  for _ in range(4)) if vectors else None)
    P_r = (None if airy is None else
           torch.empty((r, S_pad), dtype=torch.float64, device=dev))
    j1, tail = _series()
    optional = (vecs or (None,) * 4) + (
        (None,) * 2 if airy is None else (airy.flux_nodes, airy.node2coef64))
    with torch.cuda.device(dev):
        err = _library().prisim_banded_prep(
            *(t.data_ptr() for t in (s_eq_hi, s_eq_lo, Mh, Ml, pch, pcl,
                                     plan.tensor("dirs_hi", dev),
                                     plan.tensor("dirs_lo", dev))),
            S, S_pad, D, u_h.data_ptr(), u_l.data_ptr(), ok.data_ptr(),
            *(None if t is None else t.data_ptr() for t in optional),
            None if a is None else (ctypes.c_double * r)(*a.tolist()), r,
            j1, len(j1), tail, len(tail),
            None if P_r is None else P_r.data_ptr(), _UNIT_U, _PAD_U,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("banded_prep launch failed with cudaError_t %d"
                           % err)
    banded_prep_cuda.launches += 1
    return u_h, u_l, P_r, ok, vecs


banded_prep_cuda.launches = 0
tracing.register_launches("banded_prep", lambda: banded_prep_cuda.launches)
