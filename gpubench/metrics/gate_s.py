"""gate_s: seconds of the banded engine's shared-amps gate (snapshot 0
through the banded engine and through K1a): from the banded engine's plan
line to the driver's phase line "banded shared-amps gate", on the host
clock as the lines print, the mean over the window's simulations; nothing
where the banded engine does not run. Moves vis_rate."""

LAYER = "driver banded gate"
UNIT = "s"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    return info.phase_mean("gate")
