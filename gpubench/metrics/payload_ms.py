"""payload_ms: milliseconds of the card's stream in the banded payload
that torch computes, a snapshot: the `device_ms` of the program's
"prep.payload" spans under each "snapshot" span (a source chunk's
spectral coefficients of the beam-weighted fluxes, the node model through
the torch beam chain, and their rows as K2 takes them: `_chunk` in
engine/nufft_banded.py, where no kernel computed the payload), summed over
the source chunks, the mean over the snapshots of the window's first
simulation that have such spans; the gate's chunks are not snapshots.
Nothing where the program has no such span (a checkout without it), where
the banded prep's kernel computed the payload (the Airy cells), or where
the banded engine does not run. Moves vis_rate."""

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
        pays = tr.below(snap, "prep.payload")
        if pays and all("device_ms" in r for r in pays):
            per_snap.append(sum(r["device_ms"] for r in pays))
    return sum(per_snap) / len(per_snap) if per_snap else None
