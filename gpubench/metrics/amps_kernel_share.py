"""amps_kernel_share: the share, in %, of the source rows a snapshot rotates
and weights (the program's counter src.processed) in the snapshots whose
beam x flux launched the airy_amps kernel (engine/cuda_beam: one pass of
beam x flux for a plain Airy dish; the launch counter's delta over the
snapshot's beam_flux spans), summed over the snapshots of the window's
first simulation. 100 where every snapshot's beam x flux took the kernel;
nothing where none did (a program without the kernel, or a beam the kernel
does not compute). Moves vis_rate."""

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
        rows = tr.total(snap, "src.processed")
        done += rows
        if any(r["launches"].get("airy_amps")
               for r in tr.below(snap, "beam_flux")):
            kernel += rows
    return 100.0 * kernel / done if done and kernel else None
