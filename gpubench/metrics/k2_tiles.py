"""k2_tiles: the tiles of 128 sources that kernel K2's worklist lists in
one banded snapshot (the program's counter k2.tiles, the host ints the
worklist already reads back, summed over the snapshot's launches), the
mean over the banded snapshots of the window's first simulation. Each
listed tile is a staged copy and a pass of the tensor cores, so fewer is
less work for the same rows. Moves vis_rate."""

from gpubench import spans

LAYER = "kernel K2: engine/cuda_banded -> csrc/banded.cu"
UNIT = "tiles"
SOURCE = "program_counter"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    tiles = [tr.total(s, "k2.tiles") for s in tr.snapshots()
             if tr.below(s, "k2.worklist")]
    return sum(tiles) / len(tiles) if tiles else None
