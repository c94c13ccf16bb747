"""Wrapper of kernels K1a, K1b and K1c, the hand-written CUDA NUDFT
(csrc/nudft.cu).

They replace the three modes of the TPU kernel
prisim_tpu/engine/pallas_nudft.py::_kernel: point sources (K1a), the
gradient moments G_k = sum_s s_sky,k A w E (K1b, `gradient=True`) and the
gaussian weights of extended sources (K1c, `src_shape_sigma`); both may
be on in one launch. On the H100 they are meant to be bound by float64
instruction issue: the phasors and the sums are float64, because an f32
chain cannot meet the 2e-6 bar at the slice shape. All modes are
instances of one kernel, nudft_k1<kGrad, kExt>: phasors by float64
anchored rotations (a sincospi only at each chain's anchor and step), the
least MAC of each mode, several baselines per block, double-buffered
phasor tables, only the sources whose amplitudes are not all zero (in the
order `live_order` gives, through which s_sky and sigma are read too),
and the sources split across the grid so that the blocks fill whole
waves; the splits' float64 partial sums are added here in split order
(see the notes in csrc/nudft.cu).

`nudft_cuda` takes the arguments of engine.nudft.nudft_visibilities. A
CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version, and only because it lies on the CPU. The counts are of kernel
launches and nothing else: `nudft_cuda.launches` of K1a (point sources,
no moments), `launches_grad` of every launch with the moments (K1b) and
`launches_ext` of every launch with gaussian weights (K1c); a launch with
both adds one to each of the last two. `nudft_cuda.last_splits` is the
source splits of the last launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from .._build import load_kernel_library
from .nudft import ANCHOR, choose_ql, nudft_visibilities

__all__ = ["nudft_cuda", "live_order", "source_splits", "KERNEL_SOURCE",
           "TPU_KERNEL", "TPU_KERNEL_GRAD", "TPU_KERNEL_EXT"]

KERNEL_SOURCE = "prisim_tpu_torch/csrc/nudft.cu"
TPU_KERNEL = "prisim_tpu/engine/pallas_nudft.py:54"
TPU_KERNEL_GRAD = "prisim_tpu/engine/pallas_nudft.py:369"
TPU_KERNEL_EXT = "prisim_tpu/engine/pallas_nudft.py:142"

_GRAD, _EXT = 1, 2             # mode bits of the C interface (0: K1a)
_NAMES = {0: "K1a", _GRAD: "K1b", _EXT: "K1c", _GRAD | _EXT: "K1b+K1c"}
_MAX_SPLIT = 8                 # the most source splits


@functools.cache
def _library():
    """The NUDFT library, built or loaded, with its argument types bound."""
    lib = load_kernel_library("nudft")
    fn = lib.prisim_nudft_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.prisim_nudft_shape.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.prisim_nudft_shape.restype = ctypes.c_int
    return lib


@functools.cache
def _shape(mode, Q, L, device_index):
    """Baselines per block, channels per block and the blocks that fit on
    one SM at once of `mode` on the card `device_index`: they depend on
    nothing else, so the card is asked once."""
    shape = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        err = _library().prisim_nudft_shape(mode, Q, L, shape)
    if err != 0 or shape[2] < 1:
        raise RuntimeError("%s does not fit on an SM (Q=%d, L=%d)"
                           % (_NAMES[mode], Q, L))
    return tuple(shape)


def source_splits(blocks, slots, max_split=_MAX_SPLIT):
    """Number of source splits n <= max_split whose blocks * n fill the
    card's `slots` (SMs x blocks per SM) in the fullest last wave: the
    first n of the largest blocks * n / (waves * slots)."""
    best, best_eff = 1, -1.0
    for n in range(1, max_split + 1):
        waves = -(-blocks * n // slots)
        eff = blocks * n / (waves * slots)
        if eff > best_eff + 1e-12:
            best, best_eff = n, eff
    return best


def live_order(amps):
    """The order in which the kernels visit the sources: perm (int32, S)
    lists the sources whose amplitude rows are not all zero first, in their
    own order, then the others; n_live (int32, (1,)) counts the first. The
    kernels visit perm[:n_live] only and read every per-source input
    (directions, amplitudes, s_sky, sigma) through perm; the rows left
    out add exact zeros to every sum."""
    live = (amps != 0).any(dim=1)
    perm = torch.argsort((~live).to(torch.uint8), stable=True).to(
        torch.int32)
    return perm, live.sum(dtype=torch.int32).reshape(1)


def _launch(lib, mode, seh, sel, blh, bll, amps, s_sky, sigma, grid_scalars,
            nchan, chan0, Q, L, anchor):
    """One launch of `mode` on CUDA tensors: the splits' float64 partial
    sums, added in split order, as complex64 (1 or 4, B, nchan)."""
    dev = seh.device
    B = blh.shape[0]
    perm, n_live = live_order(amps)
    tracing.count_device("src.live", n_live)
    nb, tile, per_sm = _shape(mode, Q, L, dev.index)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = source_splits(-(-B // nb) * -(-nchan // tile), n_sm * per_sm)
    nout = 4 if mode & _GRAD else 1
    part = torch.empty((n_split, nout, B, nchan, 2), dtype=torch.float64,
                       device=dev)
    g0h, g0l, gdh, gdl = (float(v) for v in grid_scalars)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.prisim_nudft_launch(
        seh.data_ptr(), sel.data_ptr(), blh.data_ptr(), bll.data_ptr(),
        amps.data_ptr(), ptr(s_sky), ptr(sigma), perm.data_ptr(),
        n_live.data_ptr(), part.data_ptr(), B, nchan, Q, L, g0h, g0l, gdh,
        gdl, int(chan0), int(anchor), n_split, mode,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed with cudaError_t %d"
                           % (_NAMES[mode], err))
    nudft_cuda.last_splits = n_split
    tot = part.sum(dim=0)
    return torch.complex(tot[..., 0].float(), tot[..., 1].float())


def _check_inputs(seh, sel, blh, bll, amps, nchan, s_sky, sigma):
    S, B = seh.shape[0], blh.shape[0]
    want = [("seh", seh, (S, 3)), ("sel", sel, (S, 3)),
            ("blh", blh, (B, 3)), ("bll", bll, (B, 3)),
            ("amps", amps, (S, nchan))]
    if s_sky is not None:
        want.append(("s_sky", s_sky, (S, 3)))
    if sigma is not None:
        want.append(("src_shape_sigma", sigma, (S,)))
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
               src_shape_sigma=None, s_sky=None, gradient=False,
               anchor=ANCHOR):
    """NUDFT: complex64 (B, nchan), and with `gradient` also the complex64
    (3, B, nchan) moments.

    seh/sel (S, 3), blh/bll (B, 3) and amps (S, nchan) are contiguous
    float32 tensors on one device; grid_scalars = freq_grid_scalars(nu0,
    dnu); chan0 offsets the channel grid. src_shape_sigma (S,) (inf for a
    point source) turns on the gaussian weights (K1c) and `gradient` the
    moments (K1b); both need s_sky (S, 3), the rotated sky directions.
    `anchor` is the phasor chain length of every mode; the plain version
    follows the same chains."""
    nchan = int(nchan)
    if (gradient or src_shape_sigma is not None) and s_sky is None:
        raise ValueError("s_sky is required for gradient/extended mode")
    _check_inputs(seh, sel, blh, bll, amps, nchan, s_sky, src_shape_sigma)
    if seh.device.type == "cpu":
        return nudft_visibilities(seh, sel, blh, bll, amps, grid_scalars,
                                  nchan, chan0=chan0,
                                  src_shape_sigma=src_shape_sigma,
                                  s_sky=s_sky, gradient=gradient,
                                  anchor=anchor)
    if seh.device.type != "cuda":
        raise ValueError("nudft_cuda runs on CUDA or CPU tensors, got %s"
                         % seh.device)
    Q, L = choose_ql(nchan)
    if L > 256:
        raise ValueError("the NUDFT kernels support nchan <= 65536 "
                         "(L <= 256), got nchan=%d" % nchan)
    mode = (_GRAD if gradient else 0) | (
        _EXT if src_shape_sigma is not None else 0)
    with torch.cuda.device(seh.device):
        out = _launch(_library(), mode, seh, sel, blh, bll, amps, s_sky,
                      src_shape_sigma, grid_scalars, nchan, chan0, Q, L,
                      anchor)
    if mode == 0:
        nudft_cuda.launches += 1
    if mode & _GRAD:
        nudft_cuda.launches_grad += 1
    if mode & _EXT:
        nudft_cuda.launches_ext += 1
    return (out[0], out[1:]) if gradient else out[0]


nudft_cuda.launches = 0
nudft_cuda.launches_grad = 0
nudft_cuda.launches_ext = 0
nudft_cuda.last_splits = 0
tracing.register_launches("k1a", lambda: nudft_cuda.launches)
tracing.register_launches("k1b", lambda: nudft_cuda.launches_grad)
tracing.register_launches("k1c", lambda: nudft_cuda.launches_ext)
