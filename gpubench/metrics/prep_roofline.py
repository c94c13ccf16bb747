"""prep_roofline: kernel banded_prep's share, in %, of its roofline in the
banded engine: the least time the prep's work needs over the summed device
time of the kernel's launches in one whole simulation (the window's first,
under torch.profiler): a prep of every source chunk in each snapshot and
in the gate's banded snapshot. Moves vis_rate.

The least bytes of a chunk of S sources padded to S_pad, at the HBM peak:
the two-float u streams written once (8 B x directions x S_pad), the
two-float source vectors read once (24 B x S) and, on the truth-amps path,
the float64 payload rows written once (8 B x rank x S_pad) and the float64
node fluxes read once (8 B x S x rank). Its operations (about 50 float32
ones a source and direction, and the Airy series in float64) are not
counted. The sizes are the plan's (directions, rank, source chunks, truth
amps), read from the plan the driver built, and the cell's accumulations;
no counter the kernel fills is read."""

from gpubench.peaks import HBM_BPS

LAYER = "engine snapshots: engine/observe with engine/nufft_banded or engine/nudft"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "vis_rate"
KERNELS = r"\bbanded_prep_kernel\b"


def chunk_bytes(plan):
    """The least bytes of one chunk's prep; the driver's chunks are whole
    tiles, so S_pad = S = the plan's src_chunk."""
    S, D, r = plan["src_chunk"], plan["ndir"], plan["rank"]
    payload = 16 * r if plan["truth"] else 0
    return S * (8 * D + 24 + payload)


def read(info):
    tr, plan = info.trace, info.plan
    if tr is None or plan is None:
        return None
    t = tr.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    # the cell's snapshots and the gate's
    preps = plan["n_chunks"] * (info.cell["n_acc"] + 1)
    return 100.0 * preps * chunk_bytes(plan) / HBM_BPS / t
