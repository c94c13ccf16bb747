"""Where the time goes in the banded engine on one CUDA card.

    python3 profile_banded.py

Runs chip_smoke.py's banded slice (HERA-37, 1024 channels, nside-64 sky,
4 accumulations, engine: auto, products saved) three times: a warm-up, an
unprofiled run for the wall-clock and a run under torch.profiler; then one
north-star snapshot (chip_smoke.py's north-star configuration) after a
warm-up, under torch.profiler. For each profiled run it prints the wall
time, the device events by name, the device busy time and the idle share.

Only device events (kernels, copies, fills) are counted. key_averages()
also lists every kernel under the aten op that launched it, so summing
its self device times counts a kernel twice. The busy time is the union
of the device events' intervals, and the idle share is 1 - busy / wall.
"""

import os
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

N_ROWS = 20


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_report(label, prof, wall_s):
    """Print the device events of `prof` by name, their busy time and the
    idle share over `wall_s`; return (busy ms, summed ms, idle share)."""
    by_name = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name][0] += b - a
        by_name[e.name][1] += 1
    if not spans:
        raise SystemExit("%s: the profiler recorded no device events" % label)
    busy_ms = busy_us(spans) / 1e3
    sum_ms = sum(v[0] for v in by_name.values()) / 1e3
    idle = 1.0 - busy_ms / (wall_s * 1e3)
    print("%s: wall %.4f s, device busy %.4f ms (union of %d device events; "
          "their durations sum to %.4f ms), idle share %.4f"
          % (label, wall_s, busy_ms, len(spans), sum_ms, idle))
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in rows[:N_ROWS]:
        print("  %12.4f ms %6.2f%% %6d x  %s"
              % (us / 1e3, 100.0 * us / 1e3 / busy_ms, n, name[:100]))
    rest = sum(v[0] for _, v in rows[N_ROWS:]) / 1e3
    if rest:
        print("  %12.4f ms in %d other names" % (rest, len(rows) - N_ROWS))
    return busy_ms, sum_ms, idle


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def main():
    if not torch.cuda.is_available():
        print("profile_banded: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from prisim_tpu_torch.driver import (banded_engine, prepare_simulation,
                                         run_simulation)
    from prisim_tpu_torch.engine.observe import schedule_tensors
    cuda = torch.device("cuda", 0)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "profile_banded")
    parms = cs.slice_parms(root, cs.importable("h5py"), "auto", "banded")

    def slice_run(verbose):
        return run_simulation(parms, verbose=verbose, save=True, device=cuda)

    slice_run(False)
    _, wall = timed(lambda: slice_run(True))
    print("banded slice: wall %.4f s unprofiled" % wall)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: slice_run(True))
    device_report("banded slice, profiled", prof, wall)

    ns = cs.northstar_parms()
    sim = prepare_simulation(ns, cuda)
    plan, run = banded_engine(ns, sim)
    Mh, Ml, pch, pcl = (x[0] for x in schedule_tensors(
        sim.obs, sim.inst.latitude, cuda))
    timed(lambda: run(Mh, Ml, pch, pcl))
    _, wall = timed(lambda: run(Mh, Ml, pch, pcl))
    print("north-star snapshot: wall %.4f s unprofiled" % wall)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: run(Mh, Ml, pch, pcl))
    device_report("north-star snapshot, profiled", prof, wall)
    print("peak device memory %.4f GB"
          % (torch.cuda.max_memory_allocated() / 1e9))
    return 0


if __name__ == "__main__":
    sys.exit(main())
