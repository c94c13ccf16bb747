"""Where the time goes in the banded engine on one CUDA card.

    python3 profile_banded.py
    python3 profile_banded.py --phase-clocks
    python3 profile_banded.py --k1a-anchors

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

With --phase-clocks the kernels are built with PRISIM_PHASE_CLOCKS (a
library of their own): thread 0 of every block of K2 and K1a adds the
clock64() cycles of each phase of its block into a device counter. The
script runs K2 on the banded slice's snapshot 0 and on each north-star
source chunk, and K1a on the slice's snapshot 0, and prints each phase's
share of the cycles. The counters cost time themselves: the shares say
where a block spends its time, not what the kernel takes.

With --k1a-anchors it times K1a (CUDA events, mean of 3 runs after a
warm-up) on the slice's snapshot 0 at each phasor chain length of
ANCHORS, and prints each one's error against the float64 golden on
chip_smoke.py's 16 baselines: the measurement that sets nudft.ANCHOR.
"""

import ctypes

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


K2_PHASES = ("set-up and first copies", "wait for the tile's copies",
             "bin and compact the hits", "taps", "products (DMMA) and barrier",
             "write the rows")
K1A_PHASES = ("first tile's phasors", "next tile's phasors", "MACs",
              "barrier", "write the partial sums")


def clock_report(label, lib, phases, fn, n=3):
    """Run fn() once, zero the counters, run it n times and print each
    phase's share of the summed block cycles."""
    buf = (ctypes.c_ulonglong * 8)()
    lib.prisim_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.prisim_phase_clocks.restype = ctypes.c_int
    fn()
    torch.cuda.synchronize()
    if lib.prisim_phase_clocks(buf) != 0:
        raise SystemExit("reading the phase clocks failed")
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    if lib.prisim_phase_clocks(buf) != 0:
        raise SystemExit("reading the phase clocks failed")
    total = sum(buf[i] for i in range(len(phases)))
    if total == 0:
        raise SystemExit("%s: no phase cycles counted" % label)
    print("%s: %.4e block cycles over %d launches" % (label, total, n))
    for i, name in enumerate(phases):
        print("  %6.2f%%  %s" % (100.0 * buf[i] / total, name))


ANCHORS = (4, 8, 16, 32)


def k1a_anchors(cs, cuda):
    from prisim_tpu_torch.driver import prepare_simulation
    from prisim_tpu_torch.engine import cuda_nudft, observe
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "profile_banded")
    sim = prepare_simulation(cs.slice_parms(root, False, "direct", "anchors"),
                             cuda)
    inst = sim.inst
    Mh, Ml, pch, pcl = (x[0] for x in observe.schedule_tensors(
        sim.obs, inst.latitude, cuda))
    seh, sel, amps, _ = observe.snapshot_nudft_inputs(
        inst, sim.sky, Mh, Ml, pch, pcl, sim.beam_fn)
    args = (seh, sel, inst.bl_hi, inst.bl_lo, amps, inst.grid_scalars(),
            inst.nchan)
    pick, lens = cs.golden_pick(inst)
    pk = torch.as_tensor(pick, device=cuda)
    coherent = float(amps.abs().sum(dim=0).max())
    for anchor in ANCHORS:
        ms = cs.cuda_time_ms(
            lambda: cuda_nudft.nudft_cuda(*args, anchor=anchor))
        v = cuda_nudft.nudft_cuda(*args, anchor=anchor)
        print("K1a anchor %d: %.4f ms" % (anchor, ms))
        cs.k1a_vs_golden("  anchor %d" % anchor, inst, seh, sel, amps, v[pk],
                         pick, lens, coherent)
    return 0


def phase_clocks(cs, cuda):
    from prisim_tpu_torch.driver import banded_engine, prepare_simulation
    from prisim_tpu_torch.engine import cuda_banded, cuda_nudft, observe
    from prisim_tpu_torch.engine.observe import schedule_tensors
    lib2, lib1 = cuda_banded._library(), cuda_nudft._library()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "profile_banded")
    parms = cs.slice_parms(root, False, "auto", "clocks")
    sim = prepare_simulation(parms, cuda)
    plan, run = banded_engine(parms, sim)
    sched = schedule_tensors(sim.obs, sim.inst.latitude, cuda)
    Mh, Ml, pch, pcl = (x[0] for x in sched)
    prep = run.prep_chunk(0, Mh, Ml, pch, pcl)[:3]
    clock_report("K2, banded slice snapshot 0", lib2, K2_PHASES,
                 lambda: cuda_banded.banded_spread_cuda(plan, *prep))
    seh, sel, amps, _ = observe.snapshot_nudft_inputs(
        sim.inst, sim.sky, Mh, Ml, pch, pcl, sim.beam_fn)
    inst = sim.inst
    clock_report("K1a, slice snapshot 0", lib1, K1A_PHASES,
                 lambda: cuda_nudft.nudft_cuda(
                     seh, sel, inst.bl_hi, inst.bl_lo, amps,
                     inst.grid_scalars(), inst.nchan))
    del sim, prep, seh, sel, amps
    ns = cs.northstar_parms()
    sim = prepare_simulation(ns, cuda)
    plan, run = banded_engine(ns, sim)
    Mh, Ml, pch, pcl = (x[0] for x in schedule_tensors(
        sim.obs, sim.inst.latitude, cuda))
    preps = [run.prep_chunk(c, Mh, Ml, pch, pcl)[:3]
             for c in range(run.n_chunks)]

    def spreads():
        for prep in preps:
            cuda_banded.banded_spread_cuda(plan, *prep)

    clock_report("K2, north-star snapshot (%d chunks)" % run.n_chunks, lib2,
                 K2_PHASES, spreads, n=1)
    return 0


def main():
    if not torch.cuda.is_available():
        print("profile_banded: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if "--k1a-anchors" in sys.argv[1:]:
        return k1a_anchors(cs, torch.device("cuda", 0))
    if "--phase-clocks" in sys.argv[1:]:
        os.environ["PRISIM_KERNEL_DEFINES"] = "PRISIM_PHASE_CLOCKS"
        return phase_clocks(cs, torch.device("cuda", 0))
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
