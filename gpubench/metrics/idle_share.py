"""idle_share: the share, in %, of one whole simulation's wall time (the
first of the window, under torch.profiler with CPU and CUDA activity) in
which no operation ran on the card: 100 (1 - busy / wall), busy the union
of the device events' intervals. Moves vis_rate."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "vis_rate"


def read(info):
    tr = info.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
