"""sort_ms: milliseconds of the card's stream in the sorted route's bins
and per-baseline sort of one snapshot: the `device_ms` of the program's
"spread.sort" spans (the folded bins, the sort of each baseline's sources
by bin, the kernel's layouts and the zeroed grid) of each "snapshot" span
under the route's "snapshots" span, summed over its blocks of baselines,
the mean over the snapshots of the window's first simulation. Nothing
where the spans are absent (a checkout older than them). Moves
vis_rate."""

from gpubench import spans

LAYER = "engine snapshots: engine/nufft_delay -> csrc/spread.cu"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    per_snap = []
    for outer in tr.named("snapshots"):
        for snap in tr.below(outer, "snapshot"):
            sorts = tr.below(snap, "spread.sort")
            if sorts and all("device_ms" in r for r in sorts):
                per_snap.append(sum(r["device_ms"] for r in sorts))
    return sum(per_snap) / len(per_snap) if per_snap else None
