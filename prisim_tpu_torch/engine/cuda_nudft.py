"""Wrapper of kernels K1a, K1b and K1c, the hand-written CUDA NUDFT
(csrc/nudft.cu).

They replace the three modes of the TPU kernel
prisim_tpu/engine/pallas_nudft.py::_kernel: point sources (K1a), the
gradient moments G_k = sum_s s_sky,k A w E (K1b, `gradient=True`) and the
gaussian weights of extended sources (K1c, `src_shape_sigma`); both may
be on in one launch. On the H100 they are meant to be bound by float64
instruction issue: the phasors and the sums are float64, because an f32
chain cannot meet the 2e-6 bar at the slice shape. K1a is its own kernel
(nudft_point_kernel): phasors by float64 anchored rotations (a sincospi
only at each chain's anchor and step), a 6-instruction MAC, 4 baselines
per block, double-buffered phasor tables, only the sources whose
amplitudes are not all zero, and the sources split across the grid so
that the blocks fill whole waves; the splits' float64 partial sums are
added here in split order. K1b and K1c are instances of the template
kernel, which evaluates each phasor by sincospi into shared memory (see
the notes in csrc/nudft.cu).

`nudft_cuda` takes the arguments of engine.nudft.nudft_visibilities. A
CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version, and only because it lies on the CPU. The counts are of kernel
launches and nothing else: `nudft_cuda.launches` of K1a (point sources,
no moments), `launches_grad` of every launch with the moments (K1b) and
`launches_ext` of every launch with gaussian weights (K1c); a launch with
both adds one to each of the last two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_kernel_library
from .nudft import ANCHOR, choose_ql, nudft_visibilities

__all__ = ["nudft_cuda", "KERNEL_SOURCE", "TPU_KERNEL", "TPU_KERNEL_GRAD",
           "TPU_KERNEL_EXT"]

KERNEL_SOURCE = "prisim_tpu_torch/csrc/nudft.cu"
TPU_KERNEL = "prisim_tpu/engine/pallas_nudft.py:54"
TPU_KERNEL_GRAD = "prisim_tpu/engine/pallas_nudft.py:369"
TPU_KERNEL_EXT = "prisim_tpu/engine/pallas_nudft.py:142"

_SMEM_BUDGET = 96 * 1024       # bytes of shared memory per block
_MAX_ST = 32                   # sources per tile
_GRAD, _EXT = 1, 2             # mode bits of the C interface
_MAX_SPLIT = 8                 # K1a's most source splits


@functools.cache
def _library():
    """The NUDFT library, built or loaded, with its argument types bound."""
    lib = load_kernel_library("nudft")
    fn = lib.prisim_nudft
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 4
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.prisim_nudft_smem.argtypes = [ctypes.c_int] * 4
    lib.prisim_nudft_smem.restype = ctypes.c_size_t
    pt = lib.prisim_nudft_point
    pt.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    pt.restype = ctypes.c_int
    lib.prisim_nudft_point_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.prisim_nudft_point_blocks_per_sm.restype = ctypes.c_int
    return lib


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


def _point_cuda(lib, seh, sel, blh, bll, amps, grid_scalars, nchan, chan0,
                Q, L, anchor):
    """K1a on CUDA tensors: the live sources first, the splits' float64
    partial sums, added in split order."""
    dev = seh.device
    B = blh.shape[0]
    live = (amps != 0).any(dim=1)
    perm = torch.argsort((~live).to(torch.uint8), stable=True).to(
        torch.int32)
    n_live = live.sum(dtype=torch.int32).reshape(1)
    per_sm = lib.prisim_nudft_point_blocks_per_sm(Q, L)
    if per_sm < 1:
        raise RuntimeError("K1a does not fit on an SM (Q=%d, L=%d)" % (Q, L))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = -(-B // 4) * -(-nchan // 1024)
    n_split = source_splits(blocks, n_sm * per_sm)
    part = torch.empty((n_split, B, nchan, 2), dtype=torch.float64,
                       device=dev)
    g0h, g0l, gdh, gdl = (float(v) for v in grid_scalars)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.prisim_nudft_point(
        seh.data_ptr(), sel.data_ptr(), blh.data_ptr(), bll.data_ptr(),
        amps.data_ptr(), perm.data_ptr(), n_live.data_ptr(), part.data_ptr(),
        B, nchan, Q, L, g0h, g0l, gdh, gdl, int(chan0), int(anchor), n_split,
        stream)
    if err != 0:
        raise RuntimeError("K1a launch failed with cudaError_t %d" % err)
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
    `anchor` is K1a's phasor chain length; the plain version follows the
    same chains."""
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
    lib = _library()
    if mode == 0:
        with torch.cuda.device(seh.device):
            out = _point_cuda(lib, seh, sel, blh, bll, amps, grid_scalars,
                              nchan, chan0, Q, L, anchor)
        nudft_cuda.launches += 1
        return out
    st = _MAX_ST
    while st > 1 and lib.prisim_nudft_smem(Q, L, st, mode) > _SMEM_BUDGET:
        st //= 2
    g0h, g0l, gdh, gdl = (float(v) for v in grid_scalars)
    S, B = seh.shape[0], blh.shape[0]
    dev = seh.device
    out = torch.empty((B, nchan), dtype=torch.complex64, device=dev)
    gout = (torch.empty((3, B, nchan), dtype=torch.complex64, device=dev)
            if gradient else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.prisim_nudft(
            seh.data_ptr(), sel.data_ptr(), blh.data_ptr(), bll.data_ptr(),
            amps.data_ptr(), ptr(s_sky), ptr(src_shape_sigma),
            out.data_ptr(), ptr(gout), S, B, nchan, Q, L, st,
            g0h, g0l, gdh, gdl, int(chan0), mode, stream)
    if err != 0:
        raise RuntimeError("NUDFT kernel (mode %d) launch failed with "
                           "cudaError_t %d" % (mode, err))
    if mode & _GRAD:
        nudft_cuda.launches_grad += 1
    if mode & _EXT:
        nudft_cuda.launches_ext += 1
    return (out, gout) if gradient else out


nudft_cuda.launches = 0
nudft_cuda.launches_grad = 0
nudft_cuda.launches_ext = 0
