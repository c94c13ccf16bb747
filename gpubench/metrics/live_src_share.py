"""live_src_share: the share, in %, of the source rows a snapshot rotates
and weights (the program's counter src.processed) whose amplitude or
payload row is not all zero (src.live: K1a's live_order, K2's live
flags), summed over the snapshots of the window's first simulation. The
rows below the horizon are the rest: a horizon cut before the prep or the
beam lifts it toward 100. Moves vis_rate."""

from gpubench import spans

LAYER = "engine snapshots: engine/observe with engine/nufft_banded or engine/nudft"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    snaps = tr.snapshots()
    done = sum(tr.total(s, "src.processed") for s in snaps)
    live = sum(tr.total(s, "src.live") for s in snaps)
    return 100.0 * live / done if done and live else None
