"""spread_roofline: kernel delay_spread's share, in %, of its roofline in
the sorted route's snapshots: the least time these inputs need over the
summed device time of the delay_spread launches of one whole simulation
(the window's first, under torch.profiler). Moves vis_rate.

The work is the benchmark's own count, copied from chip_smoke.py's
`spread_bound`: each live (source, baseline) pair of a snapshot (the
sources above the horizon at that LST, by the reference's geometry, times
the baselines; the others carry no payload and are not spread) costs
4 K r float64 operations of the K taps' complex products (an FMA as 2) at
the FP64 tensor-core peak, and 2 K (ncoef - 1) of the tap polynomials at
the FP64 peak; the carrier's sincos is not counted. Bytes at the HBM
peak: the two-float delays of each pair, the float64 payload (live x r)
read once, the complex128 grid (B x n x r, n = beta C) written once.
K = 13 taps of 13 coefficients and beta = 2 are the engine's defaults; r
is the configuration's processing.nufft_rank. The count is the same
whatever implements the spread."""

from gpubench.peaks import FP64_FLOPS, FP64_TC_FLOPS, HBM_BPS

LAYER = "engine snapshots: engine/nufft_delay -> csrc/spread.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "vis_rate"
KERNELS = r"delay_spread_kernel"
TAPS = 13
NCOEF = 13
BETA = 2


def snapshot_bound_s(live, n_bl, n_chan, rank):
    """delay_spread's least time for one snapshot."""
    pairs = float(live) * n_bl
    t_ops = (pairs * 4 * TAPS * rank / FP64_TC_FLOPS
             + pairs * 2 * TAPS * (NCOEF - 1) / FP64_FLOPS)
    nbytes = pairs * 8 + live * rank * 8 + n_bl * BETA * n_chan * rank * 16
    return max(t_ops, nbytes / HBM_BPS)


def read(info):
    tr = info.trace
    if tr is None or info.cell["expect_engine"] != "sorted":
        return None
    t = tr.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    from gpubench import harness
    rank = int(harness.load_config(info.cell["config"])["sections"]
               ["processing"]["nufft_rank"])
    ref = info.ref
    live = ref.live_counts(info.profiled["lst_init"])
    bound = sum(snapshot_bound_s(int(n), ref.nbl, ref.nchan, rank)
                for n in live)
    return 100.0 * bound / t
