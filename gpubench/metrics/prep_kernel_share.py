"""prep_kernel_share: the share, in %, of the source rows the banded
snapshots prepare (the program's counter src.processed in their "prep"
spans) whose prep launched the banded_prep kernel (engine/cuda_prep: the
rotation, the u streams and the truth payload of a source chunk in one
pass; the launch counter's delta over the prep span), summed over the
snapshots of the window's first simulation; the gate's chunks are not
snapshots. 100 where every chunk's prep took the kernel; nothing where
none did (a program without the kernel) or the banded engine does not
run. Moves vis_rate."""

from gpubench import spans

LAYER = "engine snapshots: engine/observe with engine/nufft_banded or engine/nudft"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    done = kernel = 0
    for snap in tr.snapshots():
        for prep in tr.below(snap, "prep"):
            rows = tr.total(prep, "src.processed")
            done += rows
            if prep["launches"].get("banded_prep"):
                kernel += rows
    return 100.0 * kernel / done if done and kernel else None
