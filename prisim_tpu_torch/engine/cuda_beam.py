"""Wrapper of kernel airy_amps (csrc/beam.cu): the beam-weighted fluxes of a
snapshot for a chromatic Airy dish, in one pass over the (S, C) table.

amps = where(s_z > 0, airy(s)^2 x flux, 0) with airy_beam's pattern
(beams/analytic.py), which engine/observe.py::_beam_and_flux otherwise
computes as about a hundred eager torch launches (the Clenshaw recurrence
of bessel_j1 alone takes three a coefficient), each over the whole table;
on the TPU, XLA fused that chain into one pass. The kernel follows the
chain operation for operation, each rounded on its own, so the amplitudes
are the chain's bit for bit about zenith (see the note at the top of
csrc/beam.cu). The channels' k D/2 and the unit axis are computed here
with airy_beam's own torch expressions.

`airy_amps_cuda` launches the kernel for CUDA tensors and raises for any
other; _beam_and_flux keeps the chain for CPU tensors and for every other
beam. `airy_amps_cuda.launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from .._build import load_kernel_library
from ..beams.analytic import _J1_CHEB, _airy_arg_scale, _unit_axis

__all__ = ["airy_amps_cuda", "KERNEL_SOURCE"]

KERNEL_SOURCE = "prisim_tpu_torch/csrc/beam.cu"

_P = ctypes.c_void_p
_CHEB = (ctypes.c_float * len(_J1_CHEB))(*_J1_CHEB)


@functools.cache
def _library():
    """The beam library, built or loaded, with its argument types."""
    lib = load_kernel_library("beam")
    lib.prisim_airy_amps.argtypes = ([_P] * 4 + [ctypes.c_int] * 2
                                     + [_P, _P, ctypes.c_int, _P])
    lib.prisim_airy_amps.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _axis(axis, device):
    """The unit axis as the chain normalizes it on `device`, as a ctypes
    array of 3 floats (one readback per axis and device)."""
    like = torch.empty((0, 3), dtype=torch.float32, device=device)
    return (ctypes.c_float * 3)(*_unit_axis(axis, like).tolist())


def _check_inputs(s, flux, freqs):
    named = (("s_enu_hi", s), ("flux", flux), ("freqs_f32", freqs))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
    S = s.shape[0] if s.dim() else -1
    C = freqs.shape[0] if freqs.dim() else -1
    for (name, t), shape in zip(named, ((S, 3), (S, C), (C,))):
        if t.dtype != torch.float32:
            raise TypeError("%s must be float32, got %s" % (name, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != s.device:
            raise ValueError("%s is on %s, s_enu_hi on %s"
                             % (name, t.device, s.device))


def airy_amps_cuda(s_enu_hi, flux, diameter, freqs_f32, axis=None):
    """(S, C) float32 amplitudes airy(s)^2 x flux of a dish of `diameter`
    (m) about `axis` (a 3-sequence; None: zenith), zero where s_z <= 0.

    s_enu_hi (S, 3) rotated ENU direction cosines, flux (S, C) and
    freqs_f32 (C,) (Hz) are contiguous float32 tensors on one device."""
    _check_inputs(s_enu_hi, flux, freqs_f32)
    if s_enu_hi.device.type != "cuda":
        raise ValueError("airy_amps_cuda runs on CUDA tensors, got %s"
                         % s_enu_hi.device)
    S, C = flux.shape
    out = torch.empty_like(flux)
    if S == 0 or C == 0:
        return out
    a = _airy_arg_scale(freqs_f32, diameter).contiguous()
    p = None if axis is None else _axis(tuple(float(v) for v in axis),
                                        s_enu_hi.device)
    with torch.cuda.device(s_enu_hi.device):
        err = _library().prisim_airy_amps(
            s_enu_hi.data_ptr(), flux.data_ptr(), a.data_ptr(),
            out.data_ptr(), S, C, p, _CHEB, len(_CHEB),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("airy_amps launch failed with cudaError_t %d"
                           % err)
    airy_amps_cuda.launches += 1
    return out


airy_amps_cuda.launches = 0
tracing.register_launches("airy_amps", lambda: airy_amps_cuda.launches)
