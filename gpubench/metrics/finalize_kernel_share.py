"""finalize_kernel_share: the share, in %, of the visibilities the
finalize brings to the host (the program's counter finalize.vis, B x C x T
of each simulation, in its "finalize.post" span) whose finalize.post
launched the phase_cubes kernel (engine/cuda_finalize: the three cubes
re-phased and transposed on the card before one copy to the host; the
launch counter's delta over the span), summed over the window's first
simulation. 100 where the card finalized every cube; nothing where no
finalize took the kernel (a program without it, or the host finalize).
Moves vis_rate."""

from gpubench import spans

LAYER = "driver._finalize_simulation: host finalize"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    done = kernel = 0
    for post in tr.named("finalize.post"):
        n = post["counts"].get("finalize.vis", 0)
        done += n
        if post["launches"].get("phase_cubes"):
            kernel += n
    return 100.0 * kernel / done if done and kernel else None
