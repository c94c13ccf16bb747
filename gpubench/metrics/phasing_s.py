"""phasing_s: seconds of the finalize's second step, the program's span
"finalize.post" (gains, the VisibilitySet, phasing and projection), in the
window's first simulation (recorded while torch.profiler runs). With
noise_s it splits finalize_s. Moves vis_rate."""

from gpubench import spans

LAYER = "driver._finalize_simulation: host finalize"
UNIT = "s"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    return spans.span_seconds(info, "finalize.post")
