"""plan_s: seconds of the banded engine's set-up, the program's span
"plan" (driver.banded_engine: the plan, the spatial sort, the Chebyshev
projection and the snapshot functions), in the window's first simulation
(recorded while torch.profiler runs); nothing where the banded engine does
not run. Moves vis_rate."""

from gpubench import spans

LAYER = "driver.banded_engine: banded plan and snapshot functions"
UNIT = "s"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    return spans.span_seconds(info, "plan")
