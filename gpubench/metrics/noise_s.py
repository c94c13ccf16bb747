"""noise_s: seconds of the finalize's first step, the program's span
"finalize.noise" (Tsys, the noise rms and the noise draw), in the window's
first simulation (recorded while torch.profiler runs). With phasing_s it
splits finalize_s. Moves vis_rate."""

from gpubench import spans

LAYER = "driver._finalize_simulation: host finalize"
UNIT = "s"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    return spans.span_seconds(info, "finalize.noise")
