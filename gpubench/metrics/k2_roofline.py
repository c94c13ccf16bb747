"""k2_roofline: kernel K2's share, in %, of its roofline in the banded
engine: the least time these inputs need over the summed device time of
csrc/banded.cu's kernels (the tile u-ranges, the worklist and the spread)
in one whole simulation (the window's first, under torch.profiler): its
snapshots and the gate's banded snapshot. Moves vis_rate.

The work is the benchmark's own count, as chip_smoke.py's `k2_bound`
prices it: 2r (2K + 1) float64 operations (the K taps' product, an FMA as
2, and the carrier) for every valid (baseline, source) pair at the FP64
tensor-core peak, and the u streams, the payload and the output rows
moved once. The valid pairs are the sources above the horizon at each
snapshot (the reference's geometry; the others' payload is zero) times
the swept baselines: every live source reaches every swept baseline,
whose row range the plan sizes to hold all directions. The plan's sizes
(rank, taps, directions, rows, source chunks) are read from the plan the
driver built; no counter the kernel fills is read."""

from gpubench.peaks import FP64_TC_FLOPS, bound_s

LAYER = "kernel K2: engine/cuda_banded -> csrc/banded.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "vis_rate"
KERNELS = r"\b(banded_k2_kernel|tile_urange_kernel|worklist_kernel)\b"


def snapshot_bound_s(live, plan):
    """K2's least time for one banded snapshot (all its source chunks)."""
    r, K = plan["rank"], plan["K"]
    pairs = float(live) * plan["nbl"]
    pay = 8 if plan["truth"] else 4
    chunk_bytes = (2 * plan["ndir"] * plan["src_chunk"] * 4
                   + r * plan["src_chunk"] * pay
                   + plan["nbl"] * plan["R_max"] * 2 * r * 8)
    return bound_s(pairs * 2 * r * (2 * K + 1),
                   plan["n_chunks"] * chunk_bytes, FP64_TC_FLOPS)


def read(info):
    tr, plan = info.trace, info.plan
    if tr is None or plan is None:
        return None
    t = tr.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    live = info.ref.live_counts(info.profiled["lst_init"])
    # the gate spreads snapshot 0 once more
    bound = sum(snapshot_bound_s(int(n), plan) for n in live) \
        + snapshot_bound_s(int(live[0]), plan)
    return 100.0 * bound / t
