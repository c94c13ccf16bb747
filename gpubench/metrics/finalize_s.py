"""finalize_s: seconds of driver._finalize_simulation without a product:
from "visibilities computed + transferred" to "gains, container,
phasing, projection" (the phases "Tsys, rms and noise" and "gains,
container, phasing, projection"), on the host clock as the lines print,
the mean over the window's simulations. Moves vis_rate."""

LAYER = "driver._finalize_simulation: host finalize"
UNIT = "s"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    return info.phase_mean("noise", "post")
