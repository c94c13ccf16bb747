"""snap_ms: milliseconds a snapshot of the engine (engine/observe with
engine/nufft_banded or engine/nudft, and the transfer): the driver's
phase from "inputs built" to "visibilities computed + transferred", less
the gate, over the accumulations, on the host clock as the lines print,
the mean over the window's simulations. Moves vis_rate."""

LAYER = "engine snapshots: engine/observe with engine/nufft_banded or engine/nudft"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    vis = info.phase_mean("vis")
    if vis is None:
        return None
    gate = info.phase_mean("gate") or 0.0
    return (vis - gate) / int(info.cell["n_acc"]) * 1e3
