"""Wrapper of kernel K2, the hand-written CUDA banded spread (csrc/banded.cu).

K2 replaces the TPU kernel prisim_tpu/engine/nufft_banded.py::_sweep_kernel.
A worklist built on the card lists, for each item (baseline, block of 64
delay rows), the tiles of 128 sources that can reach it; one block per
item walks its list, staging each tile's u streams and payload slab in
shared memory by bulk asynchronous copies, and sums the taps' products on
the FP64 tensor cores (mma.sync m16n8k8) in float64, one writer per output
value (see the note at the top of csrc/banded.cu), and adds its sums into
the caller's rows. Only the items with a tile get a block. Sources whose
payload is all zero (below the horizon) add nothing and are skipped.

`banded_spread_cuda` takes the arguments of
nufft_banded.banded_spread_plain and, optionally, the rows to add into. A
CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version, and only because it lies on the CPU.
`banded_spread_cuda.launches` counts spread launches and nothing else (a
call whose sources reach no row launches none);
`banded_spread_cuda.last_counts` keeps the per-item tile counts of the
last call. `banded_worklist_cuda` is the worklist alone, held
against nufft_banded.banded_worklist_plain.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from .._build import load_kernel_library
from . import nufft_banded as _nb

__all__ = ["banded_spread_cuda", "banded_worklist_cuda", "KERNEL_SOURCE",
           "TPU_KERNEL"]

KERNEL_SOURCE = "prisim_tpu_torch/csrc/banded.cu"
TPU_KERNEL = "prisim_tpu/engine/nufft_banded.py:319"

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_MAX_SPLIT = 8         # most splits of an item's tile list
_PITCH = _nb.K2_TILE + 2   # doubles per payload row of a tile (kPitch)


@functools.cache
def _library():
    """The K2 library, built or loaded, with its argument types bound."""
    lib = load_kernel_library("banded")
    lib.prisim_banded_k2_count.argtypes = ([_P] * 9 + [_I] * 6
                                           + [_D, _P])
    lib.prisim_banded_k2_fill.argtypes = [_P] * 8 + [_I] * 5 + [_D, _P]
    lib.prisim_banded_k2.argtypes = ([_P] * 16 + [_I] * 7 + [_F] * 4
                                     + [_I, _I, _P])
    lib.prisim_banded_k2_blocks_per_sm.argtypes = [_I, _I]
    lib.prisim_banded_k2_blocks_per_sm.restype = ctypes.c_int
    for fn in (lib.prisim_banded_k2_count, lib.prisim_banded_k2_fill,
               lib.prisim_banded_k2):
        fn.restype = ctypes.c_int
    for fn in (lib.prisim_banded_k2_rows_per_item, lib.prisim_banded_k2_tile,
               lib.prisim_banded_k2_pitch):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    if (lib.prisim_banded_k2_rows_per_item() != _nb.K2_ROWS
            or lib.prisim_banded_k2_tile() != _nb.K2_TILE
            or lib.prisim_banded_k2_pitch() != _PITCH):
        raise RuntimeError("csrc/banded.cu and the wrapper disagree on "
                           "K2_ROWS/K2_TILE/the payload pitch")
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


def _check_rows(plan, rows, dev):
    """rows, checked as the (B, R_max, 2r) contiguous float64 array on
    `dev` that the spread adds into."""
    want = (plan.nbl, plan.R_max, 2 * plan.rank)
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.float64:
        raise TypeError("rows must be a float64 torch.Tensor")
    if tuple(rows.shape) != want or not rows.is_contiguous():
        raise ValueError("rows must be contiguous with shape %s, got %s"
                         % (want, tuple(rows.shape)))
    if rows.device != dev:
        raise ValueError("rows is on %s, P_r on %s" % (rows.device, dev))


def _tiled(plan, u_h, u_l, P_r):
    """Streams padded to whole tiles (u = 3 and zero payload past S; a
    no-op for _prep's output, whose S_pad is a multiple of the tile), the
    payload in float64, and the live flags (S_t,) uint8 of the sources
    whose payload is not all zero. Each is contiguous and 16-byte
    aligned, as the kernel's bulk copies need."""
    D, S = plan.ndir, P_r.shape[1]
    S_t = -(-S // _nb.K2_TILE) * _nb.K2_TILE
    P64 = P_r.to(torch.float64)
    uh, ul = u_h.reshape(D, S), u_l.reshape(D, S)
    if S_t != S:
        uh = torch.nn.functional.pad(uh, (0, S_t - S), value=_nb._PAD_U)
        ul = torch.nn.functional.pad(ul, (0, S_t - S))
        P64 = torch.nn.functional.pad(P64, (0, S_t - S))
    live = (P64 != 0).any(dim=0).to(torch.uint8)

    def aligned(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    return aligned(uh), aligned(ul), aligned(P64), live, S_t


def _tile_major(P64):
    """The payload (r, S_t) as K2 copies it: (S_t / K2_TILE, r, _PITCH)
    float64, tile by tile, each row padded with zeros to _PITCH."""
    r, S_t = P64.shape
    n_t = S_t // _nb.K2_TILE
    P_t = torch.zeros((n_t, r, _PITCH), dtype=torch.float64, device=P64.device)
    P_t[:, :, :_nb.K2_TILE] = P64.reshape(r, n_t, _nb.K2_TILE).transpose(0, 1)
    return P_t


def _tables(plan, dev):
    return [plan.tensor(name, dev, dt) for name, dt in (
        ("blen_hi", torch.float32), ("blen_lo", torch.float32),
        ("d_of_b", torch.int32), ("blk_lo", torch.int32),
        ("n_blk", torch.int32))]


def spread_splits(n_live, longest, slots, max_split=_MAX_SPLIT):
    """How many blocks share each item's tile list: the n <= max_split
    whose estimated time, the waves of n_live * n blocks over the card's
    `slots` (SMs x blocks per SM) times the longest share ceil(longest /
    n) in tiles, beats every smaller n's by more than 10%; 1 when the
    live items fill the card."""
    best, best_t = 1, -(-n_live // slots) * longest
    for n in range(2, max_split + 1):
        t = -(-n_live * n // slots) * -(-longest // n)
        if t < 0.9 * best_t:
            best, best_t = n, t
    return best


def _worklist(lib, plan, uh, live, S_t, stream):
    """Passes 1-3 on the card: (urange, counts, offsets, tiles) and the
    host ints (live items, longest list), read back in the span
    k2.worklist, which counts k2.tiles (the listed tiles), k2.items (every
    item, B * n_rb) and k2.items_live (the items with a tile)."""
    dev = uh.device
    B, D, K = plan.nbl, plan.ndir, plan.K
    n_rb = -(-plan.R_max // _nb.K2_ROWS)
    inv_ch = float(plan.consts["inv_ch"])
    tabs = [t.data_ptr() for t in _tables(plan, dev)]
    urange = torch.empty((D, S_t // _nb.K2_TILE, 2), dtype=torch.float32,
                         device=dev)
    counts = torch.empty((B * n_rb,), dtype=torch.int32, device=dev)
    err = lib.prisim_banded_k2_count(
        uh.data_ptr(), live.data_ptr(), *tabs, urange.data_ptr(),
        counts.data_ptr(), D, S_t, B, n_rb, K, plan.G_blk, inv_ch, stream)
    if err != 0:
        raise RuntimeError("K2 worklist count failed with cudaError_t %d"
                           % err)
    offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    with tracing.span("k2.worklist"):
        total, n_live, longest = torch.stack(
            [counts.sum(), (counts > 0).sum(), counts.max()]).tolist()
        tracing.count("k2.tiles", total)
        tracing.count("k2.items", B * n_rb)
        tracing.count("k2.items_live", n_live)
    tiles = torch.empty((max(total, 1),), dtype=torch.int32, device=dev)
    err = lib.prisim_banded_k2_fill(
        urange.data_ptr(), *tabs, offsets.data_ptr(), tiles.data_ptr(), S_t,
        B, n_rb, K, plan.G_blk, inv_ch, stream)
    if err != 0:
        raise RuntimeError("K2 worklist fill failed with cudaError_t %d" % err)
    return urange, counts, offsets, tiles[:total], (n_live, longest)


def banded_worklist_cuda(plan, u_h, u_l, P_r):
    """K2's worklist of these inputs: (urange, counts, offsets, tiles) as
    nufft_banded.banded_worklist_plain returns them; the plain version on
    CPU tensors."""
    _check_inputs(plan, u_h, u_l, P_r)
    uh, _, _, live, S_t = _tiled(plan, u_h, u_l, P_r)
    if P_r.device.type == "cpu":
        return _nb.banded_worklist_plain(plan, uh.reshape(-1), live)
    with torch.cuda.device(P_r.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _worklist(_library(), plan, uh, live, S_t, stream)[:4]


def banded_spread_cuda(plan, u_h, u_l, P_r, rows=None):
    """K2 banded spread: float64 rows (B, R_max, 2r) of `plan`, added into
    `rows` and returned.

    u_h/u_l: float32 two-float u streams, D*S_pad values (_prep's
    (1, D*S_pad)); P_r (r, S_pad) float32 or float64 payload, on one
    device. rows: a contiguous (B, R_max, 2r) float64 tensor on that
    device, to which this call's rows are added (the same float64 sum as
    rows + banded_spread_plain(...)); None: zeros, so that the result is
    this call's rows alone. Counts the sources whose payload is not all
    zero as src.live."""
    _check_inputs(plan, u_h, u_l, P_r)
    if rows is not None:
        _check_rows(plan, rows, P_r.device)
    if P_r.device.type == "cpu":
        if tracing.recording():
            tracing.count_device("src.live", (P_r != 0).any(dim=0).sum())
        out = _nb.banded_spread_plain(plan, u_h, u_l, P_r)
        return out if rows is None else rows.add_(out)
    if P_r.device.type != "cuda":
        raise ValueError("banded_spread_cuda runs on CUDA or CPU tensors, "
                         "got %s" % P_r.device)
    dev = P_r.device
    B, r, R = plan.nbl, plan.rank, plan.R_max
    if rows is None:
        rows = torch.zeros((B, R, 2 * r), dtype=torch.float64, device=dev)
    uh, ul, P64, live, S_t = _tiled(plan, u_h, u_l, P_r)
    if tracing.recording():
        tracing.count_device("src.live", live.sum())
    ivh, ivl = _nb._split(plan.consts["inv_ch"])
    nmh, nml = _nb._split(plan.consts["numid_c"])
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _, counts, offsets, tiles, (n_live, longest) = _worklist(
            lib, plan, uh, live, S_t, stream)
        banded_spread_cuda.last_counts = counts
        banded_spread_cuda.last_splits = 0
        if n_live == 0:            # no source of this call reaches a row
            return rows
        per_sm = lib.prisim_banded_k2_blocks_per_sm(r, plan.K)
        if per_sm < 1:
            raise RuntimeError("K2 does not fit on an SM (r=%d, K=%d)"
                               % (r, plan.K))
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        n_cols = -(-2 * r // 64)
        n_split = spread_splits(n_live * n_cols, longest, n_sm * per_sm)
        # the splits' partial rows, sized to the live items
        partial = None if n_split == 1 else torch.empty(
            (n_split, n_live, _nb.K2_ROWS, 2 * r), dtype=torch.float64,
            device=dev)
        # the items with the longest lists first, so that the tail is
        # short; the n_live items with a tile lead
        order = torch.argsort(counts, descending=True, stable=True).to(
            torch.int32)
        tabs = [t.data_ptr() for t in _tables(plan, dev)]
        tap_w = plan.tensor("tap_w", dev, torch.float64)
        P_t = _tile_major(P64)
        err = lib.prisim_banded_k2(
            uh.data_ptr(), ul.data_ptr(), P_t.data_ptr(), live.data_ptr(),
            *tabs, tap_w.data_ptr(), order.data_ptr(), counts.data_ptr(),
            offsets.data_ptr(), tiles.data_ptr(), rows.data_ptr(),
            None if partial is None else partial.data_ptr(), S_t, B, R, r,
            plan.K, tap_w.shape[1], plan.G_blk, float(ivh), float(ivl),
            float(nmh), float(nml), n_live, n_split, stream)
        if err != 0:
            raise RuntimeError("K2 launch failed with cudaError_t %d" % err)
    banded_spread_cuda.launches += 1
    banded_spread_cuda.last_splits = n_split
    return rows


banded_spread_cuda.launches = 0
banded_spread_cuda.last_counts = None
banded_spread_cuda.last_splits = None
tracing.register_launches("k2", lambda: banded_spread_cuda.launches)
