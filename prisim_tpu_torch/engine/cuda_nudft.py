"""Wrapper of kernel K1a, the hand-written CUDA NUDFT (csrc/nudft.cu).

K1a replaces the point-source mode of the TPU kernel
prisim_tpu/engine/pallas_nudft.py::_kernel. On the H100 it is meant to
be bound by float64 instruction issue (it runs at ~40% of that bound,
PERF.md): the phasors and the sum are float64, because an f32 chain
cannot meet the 2e-6 bar at the slice shape. The design evaluates each
phasor once per (source, baseline, step) into shared memory, leaving 6
FP64 instructions per complex multiply-add, and reuses every amplitude
load for several baselines (see the note at the top of csrc/nudft.cu).

`nudft_cuda` takes the arguments of engine.nudft.nudft_visibilities. A
CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version, and only because it lies on the CPU. `nudft_cuda.launches`
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_kernel_library
from .nudft import check_point_sources, choose_ql, nudft_visibilities

__all__ = ["nudft_cuda", "KERNEL_SOURCE", "TPU_KERNEL"]

KERNEL_SOURCE = "prisim_tpu_torch/csrc/nudft.cu"
TPU_KERNEL = "prisim_tpu/engine/pallas_nudft.py:54"

_SMEM_BUDGET = 96 * 1024       # bytes of shared memory per block
_MAX_ST = 32                   # sources per tile


@functools.cache
def _library():
    """The K1a library, built or loaded, with its argument types bound."""
    lib = load_kernel_library("nudft")
    fn = lib.prisim_nudft_k1a
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.prisim_nudft_k1a_smem.argtypes = [ctypes.c_int] * 3
    lib.prisim_nudft_k1a_smem.restype = ctypes.c_size_t
    return lib


def _check_inputs(seh, sel, blh, bll, amps, nchan):
    S, B = seh.shape[0], blh.shape[0]
    want = (("seh", seh, (S, 3)), ("sel", sel, (S, 3)),
            ("blh", blh, (B, 3)), ("bll", bll, (B, 3)),
            ("amps", amps, (S, nchan)))
    for name, t, shape in want:
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
        if t.dtype != torch.float32:
            raise TypeError("%s must be float32, got %s" % (name, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != seh.device:
            raise ValueError("%s is on %s, seh on %s"
                             % (name, t.device, seh.device))
    if S < 1 or B < 1 or nchan < 1:
        raise ValueError("empty NUDFT problem (S=%d, B=%d, nchan=%d)"
                         % (S, B, nchan))


def nudft_cuda(seh, sel, blh, bll, amps, grid_scalars, nchan, chan0=0,
               gradient=False, src_shape_sigma=None):
    """K1a NUDFT: complex64 (B, nchan) for point sources.

    seh/sel (S, 3), blh/bll (B, 3) and amps (S, nchan) are contiguous
    float32 tensors on one device; grid_scalars = freq_grid_scalars(nu0,
    dnu); chan0 offsets the channel grid."""
    check_point_sources(gradient, src_shape_sigma)
    nchan = int(nchan)
    _check_inputs(seh, sel, blh, bll, amps, nchan)
    if seh.device.type == "cpu":
        return nudft_visibilities(seh, sel, blh, bll, amps, grid_scalars,
                                  nchan, chan0=chan0)
    if seh.device.type != "cuda":
        raise ValueError("nudft_cuda runs on CUDA or CPU tensors, got %s"
                         % seh.device)
    Q, L = choose_ql(nchan)
    if L > 256:
        raise ValueError("K1a supports nchan <= 65536 (L <= 256), got "
                         "nchan=%d" % nchan)
    lib = _library()
    st = _MAX_ST
    while st > 1 and lib.prisim_nudft_k1a_smem(Q, L, st) > _SMEM_BUDGET:
        st //= 2
    g0h, g0l, gdh, gdl = (float(v) for v in grid_scalars)
    S, B = seh.shape[0], blh.shape[0]
    out = torch.empty((B, nchan), dtype=torch.complex64, device=seh.device)
    with torch.cuda.device(seh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.prisim_nudft_k1a(
            seh.data_ptr(), sel.data_ptr(), blh.data_ptr(), bll.data_ptr(),
            amps.data_ptr(), out.data_ptr(), S, B, nchan, Q, L, st,
            g0h, g0l, gdh, gdl, int(chan0), stream)
    if err != 0:
        raise RuntimeError("K1a launch failed with cudaError_t %d" % err)
    nudft_cuda.launches += 1
    return out


nudft_cuda.launches = 0
