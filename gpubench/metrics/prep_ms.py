"""prep_ms: milliseconds of the card's stream in the banded prep of one
snapshot: the `device_ms` of the program's "prep" spans under each
"snapshot" span (the rotation, the u streams, the payload: _chunk and
_prep), which CUDA events the recorder puts on the stream at each span's
edges measure (the kernels the prep launched, and any idle between them),
summed over the source chunks, the mean over the banded snapshots of the
window's first simulation; the gate's chunks are not snapshots. Nothing
where the banded engine does not run. Moves vis_rate."""

from gpubench import spans

LAYER = "engine snapshots: engine/observe with engine/nufft_banded or engine/nudft"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    per_snap = []
    for snap in tr.snapshots():
        preps = tr.below(snap, "prep")
        if preps and all("device_ms" in r for r in preps):
            per_snap.append(sum(r["device_ms"] for r in preps))
    return sum(per_snap) / len(per_snap) if per_snap else None
