"""beam_gevals: the rate, in 1e9 a second, at which the torch beam chain
evaluated the beam on the card in the banded engine: the program's
counter beam.evals (sources x frequencies that `_beam_and_flux` in
engine/observe.py sent through the torch chain, counted from the shapes)
in the "prep.payload" spans (the node model's beam at the rank's nodes)
and the "gate.amps" spans (the gate's full-channel beam) of the window's
first simulation, over those spans' `device_ms`. Nothing where the
program counts no beam.evals there (a checkout without the counter, or a
beam that a kernel computes) or the spans have no stream times. Moves
vis_rate."""

from gpubench import spans

LAYER = "engine snapshots: engine/observe with engine/nufft_banded or engine/nudft"
UNIT = "1e9/s"
SOURCE = "program_counter"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    recs = tr.named("prep.payload") + tr.named("gate.amps")
    evals = sum(tr.total(r, "beam.evals") for r in recs)
    if not evals or not all("device_ms" in r for r in recs):
        return None
    ms = sum(r["device_ms"] for r in recs)
    return evals / (ms / 1e3) / 1e9 if ms > 0 else None
