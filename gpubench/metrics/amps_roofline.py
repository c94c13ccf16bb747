"""amps_roofline: kernel airy_amps's share, in %, of its roofline in the
direct engine's snapshots: the least time these inputs need over the
summed device time of the kernel's launches in one whole simulation (the
window's first, under torch.profiler). Moves vis_rate.

The least bytes of a snapshot, at the HBM peak: the flux rows of the
sources above the horizon read once (the reference's geometry at that
LST; the kernel reads no other row), the (S, C) float32 amplitudes
written once, the rotated directions (S, 3) and the channels' factor (C,)
read once. Its operations (about a hundred float32 ones a live entry, none
fused) are not counted, so the share says how close the pass comes to
moving only what it must."""

from gpubench.peaks import HBM_BPS

LAYER = "engine snapshots: engine/observe with engine/nufft_banded or engine/nudft"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "vis_rate"
KERNELS = r"airy_amps_kernel"


def snapshot_bound_s(live, n_src, n_chan):
    """The kernel's least time for one snapshot."""
    nbytes = live * n_chan * 4 + n_src * n_chan * 4 + n_src * 12 + n_chan * 4
    return nbytes / HBM_BPS


def read(info):
    tr = info.trace
    if tr is None or info.cell["expect_engine"] != "direct":
        return None
    t = tr.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    ref = info.ref
    live = ref.live_counts(info.profiled["lst_init"])
    bound = sum(snapshot_bound_s(int(n), ref.nsrc, ref.nchan) for n in live)
    return 100.0 * bound / t
