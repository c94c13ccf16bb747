"""Where the time goes in the banded engine on one CUDA card.

    python3 profile_banded.py
    python3 profile_banded.py --phase-clocks
    python3 profile_banded.py --k1-anchors
    python3 profile_banded.py --k1-shapes
    python3 profile_banded.py --sorted

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

With --sorted it does the same for the sorted route (processing.engine:
nufft, nufft_spread: sorted; kernel delay_spread): the slice run, saved
as NPZ, and one north-star snapshot of simulate_snapshot_nufft_jit.

With --phase-clocks the kernels are built with PRISIM_PHASE_CLOCKS (a
library of their own): thread 0 of every block of K2 and of the NUDFT
kernel adds the clock64() cycles of each phase of its block into a
device counter. The script runs K2 on the banded slice's snapshot 0 and
on each north-star source chunk, K1a and K1b on the slice's snapshot 0,
and K1c on snapshot 0 of the DSM slice and of the north-star DSM
snapshot (chip_smoke.py's DSM FITS maps), and prints each phase's share
of the cycles. The counters cost time themselves: the shares say where
a block spends its time, not what the kernel takes.

With --k1-shapes it builds the NUDFT kernels once for each entry of
K1_SHAPES, from a copy of csrc/ under build/profile_banded/ whose
nudft.cu has those block shapes of K1b and K1c written into its Shape<>
specialisations, and prints each build's ptxas report and the times
(CUDA events, mean of 3 runs after a warm-up) of K1b on the slice's
snapshot 0 and of K1c on the DSM slice's and the north-star DSM
snapshot's, each checked against a second launch and, on the slices,
against its plain version: the measurement that set the shapes in
csrc/nudft.cu, and K1c's weight's share of its time.

With --k1-anchors it times K1a and K1b on the slice's snapshot 0 and K1c
on the DSM slice's (CUDA events, mean of 3 runs after a warm-up) at each
phasor chain length of ANCHORS, and prints each one's error against the
float64 golden on chip_smoke.py's 16 baselines (visibilities; for K1b
also the planes): the measurement that sets nudft.ANCHOR.
"""

import ctypes
import os
import re
import shutil
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gpubench.harness import _union

N_ROWS = 20


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    return sum((b - a for a, b in _union(intervals)), 0.0)


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
K1_PHASES = ("first tile's phasors", "next tile's phasors", "MACs",
             "barrier", "write the partial sums")
# The builds that --k1-shapes compares: K1b's and K1c's (baselines per
# block, channels per thread, sources per tile, blocks per SM). The first
# is csrc/nudft.cu's own. K1b takes 2 x 2, 4 x 2 and 2 x 4 at 8, 16 and
# 32 sources a tile; K1c None is its own shape with unit weights (a wrong
# answer: the time it saves is the weight's share).
K1B_OWN, K1C_OWN = (2, 2, 32, 2), (4, 4, 8, 2)
K1_SHAPES = ((K1B_OWN, K1C_OWN),
             ((2, 2, 16, 2), (4, 4, 12, 2)),
             ((2, 2, 8, 2), (4, 2, 8, 2)),
             ((4, 2, 8, 1), (4, 4, 8, 1)),
             ((4, 2, 16, 1), (4, 4, 16, 1)),
             ((4, 2, 32, 1), None),
             ((2, 4, 8, 1), K1C_OWN),
             ((2, 4, 16, 1), K1C_OWN),
             ((2, 4, 32, 1), K1C_OWN))
WEIGHT_LINE = "aw *= static_cast<double>(expf(-__fmul_rn(alpha, k2[j])));"


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


def k1_anchors(cs, cuda):
    from prisim_tpu_torch.driver import prepare_simulation
    from prisim_tpu_torch.engine import cuda_nudft
    from prisim_tpu_torch.engine.nudft import nudft_reference_f64
    sim = prepare_simulation(cs.slice_parms(_root(), False, "direct",
                                            "anchors"), cuda)
    args, sh, _ = snapshot0(sim, cuda)
    cases = [("K1a", sim.inst, args, {}),
             ("K1b", sim.inst, args, dict(s_sky=sh, gradient=True))]
    dsm, = dsm_sims(cs, cuda, nsides=(64,))
    dargs, dsh, sigma = snapshot0(dsm, cuda)
    cases.append(("K1c", dsm.inst, dargs, dict(s_sky=dsh,
                                               src_shape_sigma=sigma)))
    for label, inst, a, kw in cases:
        pick, lens = cs.golden_pick(inst)
        pk = torch.as_tensor(pick, device=cuda)
        blh, bll = inst.bl_hi[pk], inst.bl_lo[pk]
        gold = nudft_reference_f64(cs.joined(a[0], a[1]), cs.joined(blh, bll),
                                   a[4], inst.freqs, **kw)
        gold = gold if kw.get("gradient") else (gold,)
        for anchor in ANCHORS:
            ms = cs.cuda_time_ms(
                lambda: cuda_nudft.nudft_cuda(*a, anchor=anchor, **kw))
            out = cuda_nudft.nudft_cuda(*a, anchor=anchor, **kw)
            out = out if kw.get("gradient") else (out,)
            errs = [cs.rel_err(o[..., pk, :], g, float(g.abs().max()))[0]
                    for o, g in zip(out, gold)]
            print("%s anchor %d: %.4f ms; vs f64 golden (%d bl) %s"
                  % (label, anchor, ms, len(pick),
                     " ".join("%.4e" % e for e in errs)), flush=True)
    return 0


def _root():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "profile_banded")


def snapshot0(sim, cuda):
    """NUDFT arguments of snapshot 0 of `sim`, and its s_sky and sigma."""
    from prisim_tpu_torch.engine import observe
    inst = sim.inst
    Mh, Ml, pch, pcl = (x[0] for x in observe.schedule_tensors(
        sim.obs, inst.latitude, cuda))
    seh, sel, amps, sh = observe.snapshot_nudft_inputs(
        inst, sim.sky, Mh, Ml, pch, pcl, sim.beam_fn)
    return ((seh, sel, inst.bl_hi, inst.bl_lo, amps, inst.grid_scalars(),
             inst.nchan), sh, sim.sky.src_shape_sigma)


def dsm_sims(cs, cuda, nsides=(64, 256)):
    """The DSM slice and the north-star DSM snapshot of chip_smoke.py, on
    maps written under build/profile_banded/."""
    from prisim_tpu_torch.driver import prepare_simulation
    prefix = os.path.join(_root(), "dsm")
    for nside in nsides:
        cs.write_dsm_fits(prefix, nside)
    cat = {"DSM_file_prefix": prefix}
    out = []
    if 64 in nsides:
        out.append(prepare_simulation(cs.slice_parms(
            _root(), False, "auto", "dsm", skyparm={"model": "dsm",
                                                    "nside": 64},
            catalog=cat), cuda))
    if 256 in nsides:
        out.append(prepare_simulation(cs.northstar_parms(
            skyparm={"model": "dsm", "nside": 256}, catalog=cat), cuda))
    return out


def phase_clocks(cs, cuda):
    from prisim_tpu_torch.driver import banded_engine, prepare_simulation
    from prisim_tpu_torch.engine import cuda_banded, cuda_nudft
    from prisim_tpu_torch.engine.observe import schedule_tensors
    lib2, lib1 = cuda_banded._library(), cuda_nudft._library()
    parms = cs.slice_parms(_root(), False, "auto", "clocks")
    sim = prepare_simulation(parms, cuda)
    plan, run = banded_engine(parms, sim)
    sched = schedule_tensors(sim.obs, sim.inst.latitude, cuda)
    Mh, Ml, pch, pcl = (x[0] for x in sched)
    prep = run.prep_chunk(0, Mh, Ml, pch, pcl)[:3]
    clock_report("K2, banded slice snapshot 0", lib2, K2_PHASES,
                 lambda: cuda_banded.banded_spread_cuda(plan, *prep))
    args, sh, _ = snapshot0(sim, cuda)
    clock_report("K1a, slice snapshot 0", lib1, K1_PHASES,
                 lambda: cuda_nudft.nudft_cuda(*args))
    clock_report("K1b, slice snapshot 0", lib1, K1_PHASES,
                 lambda: cuda_nudft.nudft_cuda(*args, s_sky=sh,
                                               gradient=True))
    del sim, prep, args, sh
    for label, dsm in zip(("K1c, DSM slice snapshot 0",
                           "K1c, north-star DSM snapshot"),
                          dsm_sims(cs, cuda)):
        args, sh, sigma = snapshot0(dsm, cuda)
        clock_report(label, lib1, K1_PHASES,
                     lambda: cuda_nudft.nudft_cuda(
                         *args, s_sky=sh, src_shape_sigma=sigma), n=1)
        del dsm, args, sh, sigma
        torch.cuda.empty_cache()
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


def k1_variant(csrc, i, k1b, k1c):
    """A copy of `csrc` under build/profile_banded/ whose nudft.cu has the
    K1b and K1c shapes of K1_SHAPES[i]."""
    text = (csrc / "nudft.cu").read_text()
    for head, shape in (("Shape<true, kExt>", k1b),
                        ("Shape<false, true>", k1c or K1C_OWN)):
        text, n = re.subn(
            r"(struct %s \{[^\n]*\n  static constexpr int )[^;]*;"
            % re.escape(head),
            r"\g<1>NB = %d, CPT = %d, ST = %d, kMinBlocks = %d;" % shape,
            text)
        if n != 1:
            raise SystemExit("csrc/nudft.cu has no one struct %s" % head)
    if k1c is None:
        if WEIGHT_LINE not in text:
            raise SystemExit("csrc/nudft.cu has no K1c weight line")
        text = text.replace(WEIGHT_LINE, "")
    out = Path(_root()) / "k1-shapes" / str(i)
    shutil.copytree(csrc, out, dirs_exist_ok=True)
    (out / "nudft.cu").write_text(text)
    return out


def k1_shapes(cs, cuda):
    """Each build of K1_SHAPES: its ptxas report and the times of its K1b
    and K1c, each against a second launch and, on the slices, against its
    plain version."""
    from prisim_tpu_torch import _build
    from prisim_tpu_torch.driver import prepare_simulation
    from prisim_tpu_torch.engine import cuda_nudft
    from prisim_tpu_torch.engine.nudft import nudft_visibilities

    def outputs(fn):
        out = fn()
        return out if isinstance(out, tuple) else (out,)

    sim = prepare_simulation(cs.slice_parms(_root(), False, "direct", "k1"),
                             cuda)
    args, sh, _ = snapshot0(sim, cuda)
    cases = [("K1b, slice snapshot 0", args, dict(s_sky=sh, gradient=True))]
    for label, dsm in zip(("K1c, DSM slice snapshot 0",
                           "K1c, north-star DSM snapshot"),
                          dsm_sims(cs, cuda)):
        dargs, dsh, sigma = snapshot0(dsm, cuda)
        cases.append((label, dargs, dict(s_sky=dsh, src_shape_sigma=sigma)))
    plain = [outputs(lambda: nudft_visibilities(*a, **kw))
             if "slice" in label else None for label, a, kw in cases]
    del sim, dsm
    own = _build.CSRC
    try:
        for i, (k1b, k1c) in enumerate(K1_SHAPES):
            _build.CSRC = k1_variant(own, i, k1b, k1c)
            _build._LOADED.pop("nudft", None)
            cuda_nudft._library.cache_clear()
            cuda_nudft._shape.cache_clear()
            cuda_nudft._library()
            print("=== build %d: K1b %s, K1c %s" % (
                i, "%d x %d, %d sources a tile, %d blocks per SM" % k1b,
                "unit weights" if k1c is None else
                "%d x %d, %d sources a tile, %d blocks per SM" % k1c))
            print(_build.build_info("nudft")["report"].strip())
            for (label, a, kw), want in zip(cases, plain):
                out = outputs(lambda: cuda_nudft.nudft_cuda(*a, **kw))
                same = all(torch.equal(x, y) for x, y in zip(out, outputs(
                    lambda: cuda_nudft.nudft_cuda(*a, **kw))))
                ms = cs.cuda_time_ms(lambda: cuda_nudft.nudft_cuda(*a, **kw))
                line = "%s: %.4f ms, %d splits, second launch %s" % (
                    label, ms, cuda_nudft.nudft_cuda.last_splits,
                    "bit-identical" if same else "DIFFERS")
                if want is not None:
                    line += ", vs plain " + " ".join(
                        "%.4e" % (float((k - p).abs().max())
                                  / float(p.abs().max()))
                        for k, p in zip(out, want))
                print(line, flush=True)
    finally:
        _build.CSRC = own
    return 0


def sorted_route(cs, cuda):
    """The sorted route's slice run and one north-star snapshot, each
    after a warm-up, unprofiled and under torch.profiler."""
    from prisim_tpu_torch.driver import prepare_simulation, run_simulation
    from prisim_tpu_torch.engine import nufft_delay as nd
    from prisim_tpu_torch.engine.observe import schedule_tensors
    proc = {"nufft_spread": "sorted"}
    parms = cs.slice_parms(_root(), False, "nufft", "sorted",
                           processing=proc,
                           save_formats={"fmt": "none", "npz": True})

    def slice_run(verbose):
        return run_simulation(parms, verbose=verbose, save=True, device=cuda)

    slice_run(False)
    _, wall = timed(lambda: slice_run(True))
    print("sorted slice: wall %.4f s unprofiled" % wall)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: slice_run(True))
    device_report("sorted slice, profiled", prof, wall)

    ns = cs.northstar_parms(processing=dict(proc, engine="nufft"))
    sim = prepare_simulation(ns, cuda)
    Mh, Ml, pch, pcl = (x[0] for x in schedule_tensors(
        sim.obs, sim.inst.latitude, cuda))
    pinvQ, Q = nd.chebyshev_projection(sim.freqs, cs.SORTED_RANK)

    def snap():
        return nd.simulate_snapshot_nufft_jit(sim.inst, sim.sky, Mh, Ml, pch,
                                              pcl, sim.beam_fn, pinvQ, Q)

    torch.cuda.reset_peak_memory_stats()
    timed(snap)
    _, wall = timed(snap)
    print("north-star sorted snapshot: wall %.4f s unprofiled" % wall)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(snap)
    device_report("north-star sorted snapshot, profiled", prof, wall)
    print("peak device memory %.4f GB"
          % (torch.cuda.max_memory_allocated() / 1e9))
    return 0


def main():
    if not torch.cuda.is_available():
        print("profile_banded: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if "--k1-anchors" in sys.argv[1:]:
        return k1_anchors(cs, torch.device("cuda", 0))
    if "--k1-shapes" in sys.argv[1:]:
        return k1_shapes(cs, torch.device("cuda", 0))
    if "--sorted" in sys.argv[1:]:
        return sorted_route(cs, torch.device("cuda", 0))
    if "--phase-clocks" in sys.argv[1:]:
        os.environ["PRISIM_KERNEL_DEFINES"] = "PRISIM_PHASE_CLOCKS"
        return phase_clocks(cs, torch.device("cuda", 0))
    from prisim_tpu_torch.driver import (banded_engine, prepare_simulation,
                                         run_simulation)
    from prisim_tpu_torch.engine.observe import schedule_tensors
    cuda = torch.device("cuda", 0)
    parms = cs.slice_parms(_root(), cs.importable("h5py"), "auto", "banded")

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
