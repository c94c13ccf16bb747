"""k2_item_share: the share, in %, of kernel K2's worklist items (baseline,
block of 64 delay rows) that have a tile to spread, in the banded
snapshots of the window's first simulation: the program's counters
k2.items_live over k2.items (B x n_rb a launch, every item the worklist
counts), summed below the snapshots' k2.worklist spans (the gate's are
none of them). K2 gives a block to the live items alone, so the rest of
the grid is work it does not run. Nothing where the program counts no
k2.items (a program older than the counter) or runs no K2. Moves
vis_rate."""

from gpubench import spans

LAYER = "kernel K2: engine/cuda_banded -> csrc/banded.cu"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    live = items = 0
    for snap in tr.snapshots():
        for wl in tr.below(snap, "k2.worklist"):
            live += tr.total(wl, "k2.items_live")
            items += tr.total(wl, "k2.items")
    return 100.0 * live / items if items else None
