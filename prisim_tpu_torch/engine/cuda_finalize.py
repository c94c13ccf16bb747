"""Wrapper of kernel phase_cubes (csrc/finalize.cu): the finalize's
re-phasing of the three visibility cubes and their transpose to the
container's order, in one pass on the card.

The kernel reads the (T, B, C) cubes skyvis, vis and noise that the
engines and the finalize leave on the card and writes them, each times the
phasor of vis.phase_centering, in (B, C, T) order: complex64 cubes with
the phasor of its complex64 branch (correctly rounded, where the host's
float32 cos and sin may be an ulp off), and, where a cube is complex128
(vis, after a gains file's complex128 gains), the three as complex128 with
its np.exp branch, as phase_centering makes them.
Its plain version is `phase_cubes_plain`, the same arithmetic in torch
(the twin the tests hold the kernel to); on the host the driver's path is
the transpose and vis.phase_centering itself, and on the TPU XLA fused
that chain. About zenith the kernel's complex64 cubes are the host's bit
for bit, elsewhere they agree to an ulp or two of |V| (see the note at the
top of csrc/finalize.cu).

`phase_cubes_cuda` launches the kernel for CUDA tensors and raises for
any other; `phase_cubes_cuda.launches` counts kernel launches and nothing
else.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import constants as CNST
from .. import tracing
from .._build import load_kernel_library

__all__ = ["phase_cubes_cuda", "phase_cubes_plain", "phase_cubes_exact",
           "KERNEL_SOURCE"]

KERNEL_SOURCE = "prisim_tpu_torch/csrc/finalize.cu"
_WIDE = {torch.complex64: False, torch.complex128: True}

_P = ctypes.c_void_p


@functools.cache
def _library():
    """The finalize library, built or loaded, with its argument types."""
    lib = load_kernel_library("finalize")
    lib.prisim_phase_cubes.argtypes = [_P] * 6 + [ctypes.c_double] + \
        [ctypes.c_int] * 4 + [_P]
    lib.prisim_phase_cubes.restype = ctypes.c_int
    return lib


def _widened(cubes):
    """The cubes as they are where all are complex64, else all complex128
    (numpy's promotion in phase_centering's product)."""
    if all(x.dtype == torch.complex64 for x in cubes):
        return list(cubes)
    return [x.to(torch.complex128) for x in cubes]


def _check(skyvis, vis, noise, path, freqs):
    if not isinstance(skyvis, torch.Tensor):
        raise TypeError("skyvis must be a torch.Tensor")
    if skyvis.dim() != 3:
        raise ValueError("skyvis must have shape (T, B, C), got %s"
                         % (tuple(skyvis.shape),))
    if (path is None) != (freqs is None):
        raise ValueError("path and freqs go together")
    T, B, C = skyvis.shape
    f64 = torch.float64
    want = [("skyvis", skyvis, _WIDE, (T, B, C)),
            ("vis", vis, _WIDE, (T, B, C)), ("noise", noise, _WIDE, (T, B, C))]
    if path is not None:
        want += [("path", path, (f64,), (B, T)),
                 ("freqs", freqs, (f64,), (C,))]
    for name, t, dtypes, shape in want:
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
        if t.dtype not in dtypes:
            raise TypeError("%s must be one of %s, got %s"
                            % (name, tuple(dtypes), t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != skyvis.device:
            raise ValueError("%s is on %s, skyvis on %s"
                             % (name, t.device, skyvis.device))


def phase_cubes_cuda(skyvis, vis, noise, path=None, freqs=None):
    """(3, B, C, T): skyvis, vis and noise ((T, B, C), complex64 or
    complex128) transposed and times phase_centering's phasor
    exp(-2 pi i path nu / c), in one launch; complex64 where all three are,
    else complex128 (the complex64 ones widened first, exactly).

    path (B, T) float64 is vis.phase_path's path difference (m) and freqs
    (C,) float64 the channels (Hz); both None transposes without phasing.
    All contiguous, on one CUDA device."""
    _check(skyvis, vis, noise, path, freqs)
    dev = skyvis.device
    if dev.type != "cuda":
        raise ValueError("phase_cubes_cuda runs on CUDA tensors, got %s"
                         % dev)
    cubes = _widened((skyvis, vis, noise))
    T, B, C = skyvis.shape
    out = torch.empty((3, B, C, T), dtype=cubes[0].dtype, device=dev)
    with torch.cuda.device(dev):
        err = _library().prisim_phase_cubes(
            *(x.data_ptr() for x in cubes), out.data_ptr(),
            None if path is None else path.data_ptr(),
            None if freqs is None else freqs.data_ptr(), CNST.c, T, B, C,
            int(_WIDE[out.dtype]), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("phase_cubes launch failed with cudaError_t %d"
                           % err)
    phase_cubes_cuda.launches += 1
    return out


phase_cubes_cuda.launches = 0
tracing.register_launches("phase_cubes", lambda: phase_cubes_cuda.launches)


def phase_cubes_plain(skyvis, vis, noise, path=None, freqs=None):
    """phase_cubes_cuda's arithmetic in torch, on any device, after the
    transpose to (3, B, C, T). Complex64 cubes: the cycle count
    path x (nu / c) in float64 less its rint, the angle 2 pi x rounded to
    float32, the phasor (cos, -sin) of that angle taken in float64 and
    rounded to float32, and the complex64 product. Complex128 (a cube is):
    the argument ((-2 pi path) nu) (1 / c), the phasor (cos, sin) and the
    complex128 product."""
    cubes = torch.stack(_widened((skyvis, vis, noise))).permute(0, 2, 3, 1)
    if path is None:
        return cubes.contiguous()
    if cubes.dtype == torch.complex128:
        y = (-2.0 * math.pi * path)[:, None, :] * freqs[None, :, None] * \
            (1.0 / CNST.c)
        return cubes * torch.complex(torch.cos(y), torch.sin(y))
    ang = _angle(path, freqs).double()
    return cubes * torch.complex(torch.cos(ang).float(),
                                 -torch.sin(ang).float())


def _angle(path, freqs):
    """(B, C, T) float32 2 pi (x - rint x), x = path nu / c in float64."""
    cyc = path[:, None, :] * (freqs / CNST.c)[None, :, None]
    cyc = cyc - torch.round(cyc)
    return (2.0 * math.pi * cyc).to(torch.float32)


def phase_cubes_exact(skyvis, vis, noise, path, freqs):
    """What phase_cubes_cuda rounds for complex64 cubes: the (3, B, C, T)
    complex128 product of the cubes and the exact phasor of its float32
    angle. The kernel and the twin land within an ulp or two of |V| of it,
    as does the host's phase_centering, whose float32 cos and sin are an
    ulp or two off."""
    ang = _angle(path, freqs).double()
    cubes = torch.stack([skyvis, vis, noise]).permute(0, 2, 3, 1)
    return cubes.to(torch.complex128) * torch.polar(torch.ones_like(ang),
                                                    -ang)
