"""snap_idle_share: the share, in %, of the snapshots' wall time in which
no operation ran on the card: 100 (1 - busy within the program's
"snapshot" spans / their summed wall time), busy the union of the device
events of the window's first simulation (torch.profiler), the spans
recorded on the same host clock. The launch overhead and host work inside
the snapshots, apart from the gate, the inputs and the finalize around
them. Moves vis_rate."""

from gpubench import spans

LAYER = "engine snapshots: engine/observe with engine/nufft_banded or engine/nudft"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "vis_rate"


def read(info):
    tr, dev = spans.of(info), info.trace
    if tr is None or dev is None or not dev.ops:
        return None
    snaps = sorted((r["start_ns"] / 1e9, r["end_ns"] / 1e9)
                   for r in tr.snapshots())
    wall = sum(b - a for a, b in snaps)
    if wall <= 0:
        return None
    busy = sum(max(0.0, min(b, d) - max(a, c))
               for a, b in snaps for c, d in dev.busy)
    return 100.0 * (1.0 - busy / wall)
