"""nufft_snap_ms: milliseconds of the card's stream a snapshot of the
sorted delay-space NUFFT route: the `device_ms` of the program's
"snapshot" spans under its "snapshots" span (beam x flux, projection, and
each block of baselines' delays, bins and sort, delay_spread and FFT
post), which CUDA events the recorder puts on the stream at each span's
edges measure, the mean over the snapshots of the window's first
simulation; the gate's direct snapshot 0 is not one of them. Nothing
where the route does not run. Moves vis_rate."""

from gpubench import spans

LAYER = "engine snapshots: engine/nufft_delay -> csrc/spread.cu"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    ms = [s["device_ms"] for outer in tr.named("snapshots")
          for s in tr.below(outer, "snapshot") if "device_ms" in s]
    return sum(ms) / len(ms) if ms else None
