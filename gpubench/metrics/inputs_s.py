"""inputs_s: seconds of driver.prepare_simulation (the host builders of
layout, baselines, schedule and sky, and their upload): from the start of
each simulation to the driver's phase line "inputs built and on ...", on
the host clock as the line prints, the mean over the window's
simulations. Moves vis_rate."""

LAYER = "driver.prepare_simulation: host builders and upload"
UNIT = "s"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    return info.phase_mean("inputs")
