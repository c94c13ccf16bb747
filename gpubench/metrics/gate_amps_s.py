"""gate_amps_s: seconds of the card's stream in the banded gate's
full-channel beam times flux: the `device_ms` of the program's
"gate.amps" spans (one a source chunk of snapshot 0, around
`_beam_and_flux` in the gate of engine/nufft_banded.py: the torch beam
chain, or one airy_amps launch for a plain Airy dish) of the window's
first simulation, summed, over 1000. Nothing where the program has no
such span (a checkout without it) or the banded engine does not run.
Moves vis_rate."""

from gpubench import spans

LAYER = "driver banded gate"
UNIT = "s"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    amps = tr.named("gate.amps")
    if not amps or not all("device_ms" in r for r in amps):
        return None
    return sum(r["device_ms"] for r in amps) / 1e3
