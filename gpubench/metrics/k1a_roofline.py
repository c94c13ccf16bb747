"""k1a_roofline: kernel K1a's share, in %, of its roofline in the direct
engine's snapshots: the least time these inputs need over the summed
device time of the K1a launches of one whole simulation (the window's
first, under torch.profiler). Moves vis_rate.

The work is the benchmark's own count, copied from chip_smoke.py's
`nudft_bound`: each snapshot's sources above the horizon (the reference's
geometry at that LST; the other rows of the amplitudes are zero) times
the baselines times the channels, 10 float64 operations a term (A w, two
multiplies, and 4 FMAs into the accumulators, an FMA as 2) at the FP64
peak; each live amplitude row read once, the two-float source and
baseline vectors read once, the complex64 output written once, at the HBM
peak."""

from gpubench.peaks import FP64_FLOPS, bound_s

LAYER = "kernel K1a: engine/cuda_nudft -> csrc/nudft.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "vis_rate"
KERNELS = r"nudft_k1<false, ?false>"
FLOPS_PER_TERM = 10


def snapshot_bound_s(live, n_src, n_bl, n_chan):
    """K1a's least time for one snapshot."""
    flops = float(FLOPS_PER_TERM) * live * n_bl * n_chan
    nbytes = live * n_chan * 4 + n_src * 24 + n_bl * 24 + n_bl * n_chan * 8
    return bound_s(flops, nbytes, FP64_FLOPS)


def read(info):
    tr = info.trace
    if tr is None or info.cell["expect_engine"] != "direct":
        return None
    t = tr.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    ref = info.ref
    live = ref.live_counts(info.profiled["lst_init"])
    bound = sum(snapshot_bound_s(int(n), ref.nsrc, ref.nbl, ref.nchan)
                for n in live)
    return 100.0 * bound / t
