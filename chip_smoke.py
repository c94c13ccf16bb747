"""Smoke run of the PyTorch/CUDA port (prisim_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the NUDFT kernels K1a, K1b and K1c (csrc/nudft.cu, instances of
one kernel), K2 (csrc/banded.cu), delay_spread (csrc/spread.cu),
airy_amps (csrc/beam.cu), banded_prep (csrc/prep.cu) and phase_cubes
(csrc/finalize.cu) with nvcc (sm_90a), the six builds started together,
then:

1. K1a phase: K1a and its plain PyTorch version on the card at the slice's
   snapshot shape (HERA-37 non-redundant: 666 baselines x 1024 channels x
   49,152 nside-64 sources, the inputs of snapshot 0), and the float64
   golden on 16 baselines from the shortest to the longest. Prints both
   error normalizations (max|V| and the coherent flux scale
   max_c sum_s |A|), the times (CUDA events, warmed up, mean of 3 runs,
   plain and kernel alternated) and K1a's bound on these inputs.
2. Direct slice phase: run_simulation(parms, device="cuda", save=True)
   with processing.engine: direct and 4 accumulations; checks the output
   and that K1a ran once per accumulation.
3. K2 phase at the slice shape, with the banded engine as the driver
   builds it (truth amps, rank 32): K2 against its plain version on the
   same prep outputs of snapshot 0, the banded snapshot against K1a
   through the engine's gate (both normalizations and the amps-space
   residual), the times of K2 and its plain version, K2's work items
   (live (baseline, 64-row block) items and (item, tile) entries of its
   worklist), the valid (baseline, source) pairs and K2's bound.
4. Banded slice phase: run_simulation with processing.engine: auto, which
   is the banded engine on a card; checks that the gate passed with no
   demotion, the K2 and K1a launch counts, the output, and that snapshot 0
   equals the gate's banded snapshot.
5. North-star snapshot phase: HERA-331 redundant (630 baselines), 1024
   channels, nside-256 uniform sky (786,432 sources, 3 source chunks), the
   telescope and band of prisim_tpu/examples/simparms/hera331_northstar.yaml,
   cut to one accumulation and no products: the gate against K1a over
   630 x 1024 x 786,432; K2 against its plain version on the first source
   chunk, and both times; each chunk's work items and valid pairs; the K2
   time and bound per snapshot; K1a over all 630 baselines as the gate
   runs it (time and bound), and against the f64 golden on 16 of them.
6. K1b phase: the gradient moments at the slice shape on snapshot 0's
   inputs, K1b against its plain version (all baselines) and against the
   f64 golden (16 baselines) for the visibilities (both normalizations)
   and the three planes (max|dG| / max|G|), two launches bit-identical,
   and both times.
7. K1c phase: the same shape on a DSM FITS map that this script writes
   with the port's write_bintable (nside 64, every pixel given the
   pixel-resolution gaussian shape of the DSM reader, sigma_uv ~ 53): K1c
   against its plain version and the golden, the weight's range, two
   launches bit-identical, both times; and one K1b + K1c launch on a few
   thousand of those sources, against its plain version and the golden,
   twice bit-identical.
8. Gradient slice phase: run_simulation with processing.gradient_mode:
   baseline and engine: auto, 4 accumulations, products saved; checks that
   the run took the direct engine (K1b 4 launches, K2 none), the gradient
   cube (3, 666, 1024, 4), and that snapshot 0 equals the K1b phase's.
9. DSM slice phase: run_simulation with skyparm.model: dsm on that FITS
   map, engine: auto, 4 accumulations, products saved; K1c 4 launches, K2
   none, snapshot 0 equals the K1c phase's.
10. North-star K1c phase: hera331_northstar.yaml's telescope, array and
   band on a DSM FITS map at nside 256 (786,432 shaped sources), one
   accumulation: K1c's time over 630 x 1024 x 786,432 and its bound, two
   launches bit-identical, and K1c against its plain version and the
   golden on 16 baselines over all sources.
11. North-star K1b phase: the same array and band on the nside-256
   uniform sky with processing.gradient_mode: baseline, one snapshot:
   K1b's time over 630 x 1024 x 786,432 and its bound, two launches
   bit-identical, and K1b (visibilities and planes) against its plain
   version and the golden on 16 baselines over all sources.

Then the beams, their routes and the polarization routes, each run with
the kernel counts set to 0 just before it and read just after (its
wall-clock, K1a and K2 launches and the engine that ran are printed; for a
polarization run, also each component's):

a. Beams: every branch of the dispatcher (each telescope id, each shape
   with and without a ground plane, the MWA tile steered without and with
   delay/gain errors, apertures with and without a feed, a steered dipole
   array) on the card at snapshot 0's 49,152 slice directions x 1024
   channels, against the same torch code on the CPU, and twice on the
   card, bit-identical.
b. BASELINE config #2 (MWA-128 catalog) at full size, as
   benchmarks/bench_configs.config2 builds it: 8,128 baselines x 256
   channels x 10 accumulations, mwa_dipole, the 4,096-source catalog
   (51 above the default 10 Jy flux_min), NPZ products; with engine auto
   (whether the banded gate passed, and its readings) and engine direct,
   and the difference of the two runs; then the same pair with
   skyparm.flux_min: 0 (every catalog source), without products.
c. Phased-array track: config #2's array, band and catalog seen by a
   steered MWA tile, 4 accumulations of 3,600 s: snapshot 1 equals a
   1-accumulation run at its LST and differs from snapshot 0; two runs
   with delay/gain errors (4 realizations) are bit-identical.
d. External beam at config #4's width: the north star's array and band on
   its nside-256 sky with an nside-64 chromatic HEALPix beam that this
   script writes (the pattern of bench_configs._write_synthetic_feko), 2
   of its 100 accumulations; each snapshot split into host weights, device
   beam and K1a; snapshot 0 against K1a on the host ExternalBeam.evaluate
   beam over 128 channels.
e. Sky sectors: the slice with processing.n_sky_sectors: 3 on engine
   auto, each sector on the banded engine without the truth beam; their
   sum against the full run.
f. Full polarization at full size: config #2 with beam.pol: full (default
   feeds), engine auto, no products but the combined 4-pol UVFITS (~1 GB):
   each of the XX, YY and XY component runs (its engine, the gate's
   readings in both normalizations, its K1a/K2 launches and wall-clock);
   the sign-indefinite XY component on engine direct against the banded
   one (the gate's 2e-6 of the coherent scale); simvis_fullpol.uvfits read
   back with load_uvfits and read_fits (XX, YY, XY = YX, equal to the
   returned cubes); the Mueller weights of snapshot 0 on the card against
   the CPU (1e-6 of max) and |B_XY| <= sqrt(B_XX B_YY).
g. Dual polarization on the HERA-37 slice with array.redundant (63 unique
   of 666 baselines), beam.pol: XY, engine auto, save_formats fmt fits +
   uvfits, save_redundant: X against Y (a circular dish, 1e-7 of max|V|),
   each feed's simvis.fits read back with load_fits equal to its run,
   each simvis.uvfits on all 666 baselines (each a unique baseline's
   rows), the combined 2-pol and 4-pol UVFITS (cross-pols flagged zeros);
   then each product's writer timed alone.

Then the analysis stack, chunked runs and the diagnosis section:

h. BASELINE config #3 at full size (as benchmarks/bench_configs.config3
   builds it, saved as the native FITS product in place of HDF5: the card
   machine has no h5py): HERA-37 redundant (63 baselines), 256 ch x
   390.625 kHz, nside-128 USM sky, 10 x 60 s, engine auto (its engine,
   gate readings, K1a/K2 launches, wall-clock); then tools.delay_ps on the
   FITS file with CLEAN on the card (the time of each step); CLEAN's
   iteration counts and stop rules per cube, its identity res + cc *
   kernel = inp on the card (1e-5 of max|inp| per spectrum), CLEAN on the
   CPU on the same lag cubes, and delay_ps on the CPU on the same file
   (P(k) within 1e-6 of max, z and kprll equal).
i. BASELINE config #5 at full size (bench_configs.config5): a 16 x 32 grid
   at 7 m (512 antennas, 976 unique baselines) x 128 ch x 8 acc, 1,024
   sources, unit beam; engine.observe.simulate_drift on the card (K1a, one
   launch an accumulation), 512 triad classes, closure phases, 4 days of
   0.01 jitter binned by a median, cpds_ft and xcpdps_full (the time of
   each step and P's shape); K1a against its plain version on
   accumulation 0 (2e-6 of max|V|).
j. Chunked runs on the slice cut to 256 ch x 2 acc, engine auto:
   pp.n_chunks: 2 with key freq and with key time against the run
   unchunked (2e-6 of the coherent scale; each chunk's noise rms within 1%
   of the radiometer rms; the chunks' draws differ); resume with
   _part_1.npz deleted (part 0 untouched, the merge equal to the first);
   diagnosis.jax_profile (a torch.profiler trace) and
   diagnosis.resource_monitor (rows with device bytes where psutil
   imports, else ImportError before any compute).

Then the device mesh, the tools and the example:

k. Mesh on the card: the slice cut to 2 accumulations on 4 shards that
   all sit on the one card, devices=[cuda:0] * 4 (torch.cuda.device_count()
   printed): the direct engine with pp.key freq (1, 4), bl (4, 1), src
   (1, 1, 4) and pp.mesh_axes [2, 2], each against the one-device direct
   run in both normalizations (bl/chan shards 1e-6 of max|V|, src shards
   2e-6 of the coherent scale), K1a launching once per shard and
   accumulation; engine auto on the banded (4, 1) 'bl' mesh: the mesh
   gate's readings, K2 launches (the gate's 1 + one per shard and
   accumulation), against the one-device banded run (2e-6 of the coherent
   scale); each run timed (the shards run one after another on one card:
   no scaling); the host synchronizations inside one K1a and one K2
   launch (torch.cuda's sync debug mode); tools.mesh_check on the 4
   entries.
l. Tools and BASELINE config #4: bench_configs._write_synthetic_feko's
   pattern (8 frequencies, 100-200 MHz) written by this script, then
   tools.feko_to_healpix to FITS (nside 64, spline), timed; config #4 at
   full width (HERA-331 redundant, 630 bl x 1024 ch x nside-256 USM) on
   that beam through run_simulation, accumulations cut from 100 to 4,
   saved as native FITS, with phase d's per-snapshot split; on that
   product convert to NPZ and UVFITS (read back), update_noise to FITS on
   the card twice with one seed (bit-identical, rms against the
   radiometer rms), replicate 4 realizations; expand_redundant_file on
   phase g's redundant FITS product (63 -> 666 baselines); list_sims and
   grep_sims over the phases' project directories.
m. The example: examples.full_pipeline.main(device="cuda") with its UVFITS
   round trip.

Then the delay-space NUFFT with the sorted spread (kernel delay_spread):

n. The sorted route at the slice (engine nufft, nufft_spread sorted, rank
   32: the fractional bandwidth is 0.67): delay_spread against its plain
   version on snapshot 0's inputs (1e-12 of max|grid|), the times of the
   kernel alone, its plain version, the wrapper's set-up, the bins and
   sort, and the whole snapshot, and its bound; run_simulation with 4
   accumulations and NPZ products (its gate in both normalizations,
   passing at 1e-4 of max|V| with no demotion; delay_spread 4 launches and
   K1a 1; snapshot 0 against phase 1's K1a snapshot at 2e-6 of the
   coherent scale; the wall-clock); then one north-star snapshot (630 bl x
   1024 ch x 786,432 sources, no products) timed beside phase 5's banded
   snapshot and K1a launch, against K1a on 16 baselines from the shortest
   to the longest (1e-4 of max|V|), the kernel's time and bound there, and
   the kernel against its plain version on those 16 baselines, and that
   snapshot's stream ms by the spans inside it (beam_flux, project, and
   the blocks' delays, spread.sort, spread, post) beside the snapshot
   span's own: a check of the spans on the card.
o. The sorted route on the mesh: the slice cut to 2 accumulations on
   devices=[cuda:0] * 4 with pp.key freq (1, 4), bl (4, 1), src (1, 1, 4)
   and pp.mesh_axes [2, 2], each against the one-device sorted run (2e-6
   of the coherent scale: each shard fits its own sub-band's float32
   basis, as the reference's mesh does, and src shards add complex64
   partials),
   delay_spread launching once per shard and accumulation, K1a once (the
   gate), each run timed.

Then the north-star main path end to end:

p. run_simulation(device="cuda", save=True) on the sections of
   prisim_tpu/examples/simparms/hera331_northstar.yaml, built as a dict
   (northstar_run_parms): HERA-331 redundant (630 baselines) x 1024
   channels x nside-256 USM (786,432 sources) x all 100 accumulations,
   processing at its defaults (engine auto: the banded engine and its
   gate), the product as native FITS in a temporary directory under
   build/chip_smoke/. Prints the engine (a demotion fails the phase), the
   K2 and K1a launches (failing unless a launch per source chunk and
   snapshot, the gate's included, and the gate's K1a calls), the
   wall-clock split by the driver's phase lines (set-up, gate, snapshots,
   finalize, product write) and the peak device memory; snapshots 0 and 99
   against K1a on the model amps as the gate runs it, phased as the run
   phases them (2e-6 of the coherent scale), and, as readings only,
   against K1a on the float32 amps and the float64 golden on 16 baselines
   in both normalizations beside the north star's 1e-6; the FITS product
   read back with load_fits, equal to the returned run.
q. Kernel airy_amps (csrc/beam.cu), run right after the K1a phase: the
   slice's beam (HERA's Airy dish about its default, zenith orientation)
   times flux by the kernel against the torch chain it replaces
   (engine/observe._beam_and_flux with the same beam, without .airy) on
   the card, at the direct cells' snapshot shapes, 786,432 x 1024
   (hera331.direct) and 196,608 x 256 (hera37.direct): seeded directions
   over the sphere with zenith, x < 1e-6, s_z = 0, below the horizon and
   x = 8 rows, and seeded fluxes with a zero row; the two tables equal bit
   for bit, one launch each; both times and the kernel's least-bytes
   bound. The direct and banded slice runs then count its launches: one
   per accumulation, and one for the banded gate's source chunk.
r. Kernel banded_prep (csrc/prep.cu), run right after the north-star
   phase: the banded engine's prep (rotation, u streams of every
   direction, the float64 Airy truth payload) by the kernel against the
   torch chain it replaces (nufft_banded.banded_prep_plain) on the card,
   on the arguments run.prep_args gives for every source chunk of
   snapshot 0, at the slice (49,152 sources in one chunk) and at the
   north star (3 chunks of 262,144 sources x 384 directions x rank 32):
   u streams, ok and vectors bit for bit, the payload to 1e-13 of max|P|
   with the same zeros; the times of a snapshot's preps, kernel and
   chain, and the kernel's least-bytes bound and share. The banded slice
   run counts its launches (one a chunk and snapshot, the gate's
   included), and the north-star phase those of its gate and one
   snapshot; the kernels line gives their sum, the main path's own
   launches, and leaves out this phase's comparisons and timing loops.
s. Kernel phase_cubes (csrc/finalize.cu), run right after phase q: the
   finalize's re-phasing and transpose of the three cubes by the kernel
   against the host path it replaces (the transpose and
   vis.phase_centering's complex64 branch) at the north-star cells'
   630 x 1024 x 25 and hera37.direct's 63 x 256 x 10 (T = 25, 10), on
   seeded cubes with baselines up to 876 m and an off-zenith centre:
   within 2 float32 ulps of |V| of the exact product of the cubes and
   their float32 angle's phasor and 4 of the host path's (whose float32
   cos and sin are an ulp or two off), one launch each; the kernel's time
   against its least bytes (three cubes read and written at 3.35 TB/s),
   the host path's time, and the cubes' one copy to the host (its GB/s).
   The direct and banded slice runs count its launches: one a finalize.

After the phases it prints the card's name and power limit, the roofline
share (bound / time, against the H100 data-sheet peaks) of K1a, K1b, K1c,
K2, delay_spread, airy_amps, banded_prep and phase_cubes at the slice and
the north star (airy_amps and phase_cubes at the cells' shapes), and the
kernels line: each
kernel's launches in its slice run (K1a and K2 also in phases k-m's and
p's runs, K1a and delay_spread in phases n-o's, airy_amps in the direct
and banded slice runs, banded_prep in the banded slice run and phase
5's gate and snapshot, phase_cubes in the direct and banded slice runs),
error against its plain version, time, plain time, bound (from this run's
inputs) and library time (null: no single PyTorch call computes any of
them).

Exits non-zero on any failure, and without a CUDA card. The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gpubench.peaks import FP64_FLOPS, FP64_TC_FLOPS, HBM_BPS, bound_s

BAR = 2e-6            # max|dV| / max|V|, the f32 engines' bar
GATE_TOL = 2e-6       # banded gate: max|dV| / max_c sum_s |A|
# K2 vs its plain version, max|d rows| / max|rows|: both sum in float64
# (readings 2.2e-15 to 2.8e-15 at the slice and the north star), where an
# f32 sum would read ~1e-7
ROWS_BAR = 1e-12
GRAD_BAR = 5e-6       # K1b planes vs the golden, max|dG| / max|G|
EXT_BAR = 3e-6        # K1c vs the golden, max|dV| / max|V|
# K1b and K1c vs their plain version, max|dV| / max|V| (and max|dG| /
# max|G|): both sum in float64 from the same float32 weights, so they agree
# to the complex64 rounding of the output; an f32 sum would read ~1e-6
PLAIN_BAR = 1e-7
N_GOLDEN_BL = 16
# banded_prep's payload vs the torch chain's, max|dP| / max|P|: both
# float64, the node-to-coefficient sums in another order
PREP_BAR = 1e-13
N_TIMED = 3
# airy_amps's (sources, channels) in the direct cells' snapshots:
# hera331.direct (nside 256 x 1024 ch) and hera37.direct (nside 128 x 256)
AIRY_SHAPES = ((786432, 1024), (196608, 256))
# phase_cubes's (T, B, C) cubes: the north-star cells (630 x 1024 x 25)
# and hera37.direct (63 x 256 x 10)
FINALIZE_SHAPES = ((25, 630, 1024), (10, 63, 256))
# phase_cubes off zenith: the largest difference of a real or imaginary
# part, in float32 ulps of |V|, from the exact product of the cubes and
# their float32 angle's phasor; the host path's float32 cos and sin are an
# ulp or two off that product, so kernel and host agree within twice it
FINALIZE_ULPS = 2.0
# float64 operations per (source, baseline, channel) term, an FMA as 2:
# K1a A w (2 multiplies) and 4 FMAs into the accumulators; K1b 3 moments
# of 2 FMAs more each; K1c one multiply by the weight more
K1A_FLOPS, K1B_FLOPS, K1C_FLOPS = 10, 22, 11


def bound(flops, nbytes, peak):
    """gpubench.peaks.bound_s in milliseconds, and what sets it:
    {"bound_ms", "bound_by"}."""
    t = bound_s(flops, nbytes, peak)
    return dict(bound_ms=t * 1e3,
                bound_by="operations" if flops / peak >= t else "bytes")


def nudft_bound(amps, B, flops_per_term, out_planes=1, extra_bytes=0):
    """A NUDFT kernel's bound on these amplitudes (S, C): the terms of the
    sources whose amplitudes are not all zero (the others add nothing and
    are not needed), each amplitude row of theirs read once, the float32
    two-float source and baseline vectors read once, the complex64
    outputs written once. Also returns the live source count."""
    S, C = amps.shape
    live = int((amps != 0).any(dim=1).sum())
    nbytes = live * C * 4 + S * 24 + B * 24 + out_planes * B * C * 8
    return dict(bound(float(flops_per_term) * live * B * C,
                      nbytes + extra_bytes, FP64_FLOPS), live=live)


def k2_bound(plan, u_h, P_r, pairs):
    """K2's bound for one launch: 2r (2K + 1) float64 operations per valid
    (baseline, source) pair (the K taps' product, an FMA as 2, and the
    carrier), at the FP64 tensor-core peak (the least time); the u streams
    and the payload read once, the (B, R_max, 2r) float64 rows written
    once."""
    r, K = plan.rank, plan.K
    nbytes = (2 * u_h.numel() * 4 + P_r.numel() * P_r.element_size()
              + plan.nbl * plan.R_max * 2 * r * 8)
    return bound(float(pairs) * 2 * r * (2 * K + 1), nbytes, FP64_TC_FLOPS)


def worklist_line(label, pairs):
    """Print K2's live work items of its last launch, the splits of their
    lists, and the valid pairs."""
    from prisim_tpu_torch.engine.cuda_banded import banded_spread_cuda
    from prisim_tpu_torch.engine.nufft_banded import K2_ROWS
    counts = banded_spread_cuda.last_counts
    n = counts.numel()
    live = int((counts > 0).sum())
    total = int(counts.sum())
    print("%s K2 work items: %d (baseline, %d-row block) items, %d live "
          "(%.4f), %d (item, tile) entries (%.4f tiles per live item, "
          "longest %d), lists split %d ways; valid (baseline, source) pairs "
          "%d" % (label, n, K2_ROWS, live, live / n, total,
                  total / max(live, 1), int(counts.max()),
                  banded_spread_cuda.last_splits, pairs))


def slice_parms(rootdir, have_h5py, engine, simid, **sections):
    """The slice: HERA-37 all pairs, 1024 channels, an nside-64 sky, 4
    accumulations; `sections` update the parameter sections."""
    from prisim_tpu_torch.config import load_parms
    p = {
        "dirstruct": {"rootdir": rootdir, "project": "chip_smoke",
                      "simid": simid},
        "telescope": {"id": "hera", "latitude": -30.7224, "Trx": 100.0},
        "array": {"layout": "HERA-37", "redundant": False},
        "antenna": {"shape": "dish", "size": 14.0},
        "bandpass": {"freq": 150e6, "freq_resolution": 97656.25,
                     "nchan": 1024},
        "obsparm": {"obs_mode": "drift", "n_acc": 4, "t_acc": 60.0},
        "skyparm": {"model": "usm", "nside": 64},
        "processing": {"engine": engine},
        "save_formats": {"fmt": "HDF5" if have_h5py else "none",
                         "npz": True},
    }
    for sec, val in sections.items():
        p[sec] = dict(p.get(sec, {}), **val)
    return load_parms(p)


def northstar_parms(**sections):
    """hera331_northstar.yaml's telescope, array and band, cut to one
    accumulation and no products; `sections` update the sections."""
    from prisim_tpu_torch.config import load_parms
    p = {
        "telescope": {"id": "hera", "latitude": -30.7224,
                      "longitude": 21.4278, "A_eff": 154.0, "eff_Q": 0.96,
                      "Trx": 100.0},
        "array": {"layout": "HERA-331", "redundant": True},
        "antenna": {"shape": "dish", "size": 14.0},
        "bandpass": {"freq": 150e6, "freq_resolution": 97656.25,
                     "nchan": 1024},
        "obsparm": {"obs_mode": "drift", "n_acc": 1, "t_acc": 60.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "usm", "nside": 256},
        "processing": {"engine": "nufft"},
        "save_formats": {"fmt": "none", "npz": False},
    }
    for sec, val in sections.items():
        p[sec] = dict(p.get(sec, {}), **val)
    return load_parms(p)


def write_dsm_fits(prefix, nside, seed=0):
    """A DSM-format FITS map for `nside`, written with the port's writer to
    '<prefix>_150.0_MHz_nside_<nside>.fits', the file that
    catalog.DSM_file_prefix: <prefix> names: temperatures 100-110 K (a
    near-uniform diffuse sky, where max|V| sits far below the coherent
    scale) and temperature spectral indices -2.55 +- 0.05 at 150 MHz, from
    `seed`. Returns the prefix."""
    from prisim_tpu_torch.catalogs import write_dsm_fits as write
    npix = 12 * nside * nside
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    write("%s_150.0_MHz_nside_%d.fits" % (prefix, nside),
          100.0 + 10.0 * rng.rand(npix), -2.55 + 0.05 * rng.randn(npix))
    return prefix


def cuda_time_ms(fn, n=N_TIMED, warm=True):
    """Mean ms of fn() over n runs, after one warm-up unless fn() has just
    run, by CUDA events."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def importable(name):
    try:
        __import__(name)
        return True
    except ImportError:
        return False


def golden_pick(inst):
    """N_GOLDEN_BL baselines from the shortest to the longest, and the
    lengths of all."""
    from prisim_tpu_torch import twofloat as tf
    lens = np.linalg.norm(tf.join_f64(inst.bl_hi, inst.bl_lo), axis=1)
    order = np.argsort(lens)
    return (order[np.linspace(0, len(lens) - 1, N_GOLDEN_BL).round()
                  .astype(int)], lens)


def k1a_vs_golden(label, inst, seh, sel, amps, v_k, pick, lens, coherent):
    """K1a's visibilities v_k of baselines `pick` against the float64
    golden on the same inputs; prints both normalizations and returns
    (golden, max|dV| / max|V|)."""
    from prisim_tpu_torch import twofloat as tf
    from prisim_tpu_torch.engine.nudft import nudft_reference_f64
    dev = seh.device
    bl64 = torch.as_tensor(tf.join_f64(inst.bl_hi, inst.bl_lo)[pick],
                           device=dev)
    s64 = torch.as_tensor(tf.join_f64(seh, sel), device=dev)
    gold = nudft_reference_f64(s64, bl64, amps, inst.freqs)
    g_abs = float((v_k.to(torch.complex128) - gold).abs().max())
    g_rel_v = g_abs / float(gold.abs().max())
    print("%s vs f64 golden (%d bl, %.1f-%.1f m): max|dV|=%.4e  "
          "/max|V|=%.4e  /max_c sum_s|A|=%.4e"
          % (label, len(pick), lens[pick[0]], lens[pick[-1]], g_abs,
             g_rel_v, g_abs / coherent))
    return gold, g_rel_v


def kernel_phase(sim, cuda):
    from prisim_tpu_torch.engine import cuda_nudft, observe
    from prisim_tpu_torch.engine.nudft import nudft_visibilities
    inst, sky = sim.inst, sim.sky
    Mh, Ml, pch, pcl = observe.schedule_tensors(sim.obs, inst.latitude,
                                                 cuda)
    seh, sel, amps, _ = observe.snapshot_nudft_inputs(
        inst, sky, Mh[0], Ml[0], pch[0], pcl[0], sim.beam_fn)
    args = (seh, sel, inst.bl_hi, inst.bl_lo, amps, inst.grid_scalars(),
            inst.nchan)
    S, B, C = seh.shape[0], inst.nbl, inst.nchan
    print("kernel phase: S=%d sources x B=%d baselines x C=%d channels"
          % (S, B, C))
    v_k = cuda_nudft.nudft_cuda(*args)
    torch.cuda.synchronize()
    v_p = nudft_visibilities(*args)
    torch.cuda.synchronize()
    assert v_k.shape == (B, C) and bool(torch.isfinite(v_k).all())
    coherent = float(amps.abs().sum(dim=0).max())
    d = (v_k - v_p).abs()
    max_abs = float(d.max())
    rel_v = max_abs / float(v_p.abs().max())
    rel_c = max_abs / coherent
    print("K1a vs plain (all %d bl): max|dV|=%.4e  /max|V|=%.4e  "
          "/max_c sum_s|A|=%.4e" % (B, max_abs, rel_v, rel_c))

    pick, lens = golden_pick(inst)
    pk = torch.as_tensor(pick, device=cuda)
    gold, g_rel_v = k1a_vs_golden("K1a", inst, seh, sel, amps, v_k[pk],
                                  pick, lens, coherent)
    p_abs = float((v_p[pk].to(torch.complex128) - gold).abs().max())
    print("plain vs f64 golden: /max|V|=%.4e  /max_c sum_s|A|=%.4e"
          % (p_abs / float(gold.abs().max()), p_abs / coherent))
    if not (rel_v < BAR and g_rel_v < BAR):
        raise SystemExit("K1a disagrees: vs plain %.3e, vs golden %.3e "
                         "(bar %.0e)" % (rel_v, g_rel_v, BAR))

    # times: plain, kernel, kernel, plain (one call, one card)
    t_plain = cuda_time_ms(lambda: nudft_visibilities(*args))
    t_k = cuda_time_ms(lambda: cuda_nudft.nudft_cuda(*args))
    t_k2 = cuda_time_ms(lambda: cuda_nudft.nudft_cuda(*args))
    t_plain2 = cuda_time_ms(lambda: nudft_visibilities(*args))
    ms_k = 0.5 * (t_k + t_k2)
    ms_p = 0.5 * (t_plain + t_plain2)
    macs = float(S) * B * C
    print("K1a   time: %.4f ms (runs %.4f, %.4f) = %.4e s, %.4e complex MAC/s"
          % (ms_k, t_k, t_k2, ms_k / 1e3, macs / (ms_k / 1e3)))
    print("plain time: %.4f ms (runs %.4f, %.4f) = %.4e s, %.4e complex MAC/s"
          % (ms_p, t_plain, t_plain2, ms_p / 1e3, macs / (ms_p / 1e3)))
    bd = nudft_bound(amps, B, K1A_FLOPS)
    print("K1a bound: %.4f ms (%s; %d of %d sources above the horizon)"
          % (bd["bound_ms"], bd["bound_by"], bd["live"], S))
    return dict(v0=v_k.cpu().numpy(), max_abs_err=max_abs, ms=ms_k,
                plain_ms=ms_p, bound_ms=bd["bound_ms"],
                bound_by=bd["bound_by"], golden_rel=g_rel_v)


def airy_rows(S, freqs, diameter, dev, seed=0):
    """S float32 direction cosines over the sphere and (S, C) float32
    fluxes in [0.5, 20), seeded, with the rows airy_amps must get right
    first: zenith (x = 0), x < 1e-6 off zenith, s_z = 0 exactly, below the
    horizon, x = a sin(t) = 8 at the middle channel; row 5 has zero
    flux."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s = torch.randn((S, 3), generator=g, dtype=torch.float64, device=dev)
    s = s / s.norm(dim=1, keepdim=True)
    a = 2.0 * np.pi * float(freqs[len(freqs) // 2]) / 299792458.0 \
        * (0.5 * diameter)
    st = 8.0 / a
    s[:5] = torch.tensor([[0.0, 0.0, 1.0], [1e-9, 0.0, 1.0],
                          [0.6, 0.8, 0.0], [0.3, -0.4, -np.sqrt(0.75)],
                          [st, 0.0, np.sqrt(1.0 - st * st)]],
                         dtype=torch.float64, device=dev)
    flux = torch.rand((S, len(freqs)), generator=g, device=dev) * 19.5 + 0.5
    flux[5] = 0.0
    return s.float().contiguous(), flux.contiguous()


def airy_bound(s, C):
    """airy_amps's least bytes for one table, at HBM_BPS: the flux rows of
    the sources above the horizon read once, the (S, C) float32 table
    written once, the directions (S, 3) and the channels' factor (C,) read
    once (the gpubench metric amps_roofline's count)."""
    S = s.shape[0]
    live = int((s[:, 2] > 0).sum())
    return dict(bound(0.0, live * C * 4 + S * C * 4 + S * 12 + C * 4, 1.0),
                live=live)


def airy_amps_phase(beam_fn, freqs, dev, shapes=AIRY_SHAPES):
    """Phase q: kernel airy_amps against the torch chain it replaces, with
    the slice's beam (beam_fn, which must carry .airy about zenith) at
    each (S, C) of `shapes` (C channels spread over `freqs`); the tables
    must be equal bit for bit. Returns the kernels line's numbers of the
    first shape and each shape's time and bound."""
    from prisim_tpu_torch.engine import cuda_beam
    from prisim_tpu_torch.engine.observe import _beam_and_flux
    dish = getattr(beam_fn, "airy", None)
    assert dish is not None, "the slice's beam is no plain Airy dish"
    dia, axis = dish
    assert axis is None or (abs(axis[0]) < 1e-12 and abs(axis[1]) < 1e-12
                            and axis[2] > 0), axis

    def chain(d, f):            # the same beam, without .airy
        return beam_fn(d, f)

    freqs = np.asarray(freqs, np.float64)
    rows = []
    for S, C in shapes:
        pick = np.linspace(0, len(freqs) - 1, C).round().astype(int)
        f = torch.as_tensor(freqs[pick], dtype=torch.float32, device=dev)
        s, flux = airy_rows(S, freqs[pick], dia, dev)

        def kernel():
            return cuda_beam.airy_amps_cuda(s, flux, dia, f, axis=axis)

        def plain():
            return _beam_and_flux(s, flux, f, chain)

        want = plain()
        n0 = cuda_beam.airy_amps_cuda.launches
        got = kernel()
        sync(dev)
        assert cuda_beam.airy_amps_cuda.launches == n0 + 1
        assert got.shape == (S, C) and got.dtype == torch.float32
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        same = bool(torch.equal(got, want))
        print("airy_amps vs the torch chain, %d x %d (%.1f m dish, axis "
              "%s): max|d| = %.4e of max|amps| %.4e, %s"
              % (S, C, dia, axis, err, scale,
                 "bit-identical" if same else "NOT bit-identical"))
        if not same:
            raise SystemExit("airy_amps differs from the torch chain at "
                             "%d x %d: max|d| = %.3e" % (S, C, err))
        assert scale > 0 and not bool(got[[2, 3, 5]].any())
        assert torch.equal(got[0], flux[0])             # zenith: pattern 1
        del want, got
        # times: kernel, plain, plain, kernel (one call, one card)
        t_k = cuda_time_ms(kernel)
        t_p = cuda_time_ms(plain)
        t_p2 = cuda_time_ms(plain)
        t_k2 = cuda_time_ms(kernel)
        bd = airy_bound(s, C)
        ms_k, ms_p = 0.5 * (t_k + t_k2), 0.5 * (t_p + t_p2)
        print("airy_amps time %.4f ms (runs %.4f, %.4f), torch chain %.4f ms "
              "(runs %.4f, %.4f); bound %.4f ms (%s; %d of %d sources above "
              "the horizon)" % (ms_k, t_k, t_k2, ms_p, t_p, t_p2,
                                bd["bound_ms"], bd["bound_by"], bd["live"],
                                S))
        rows.append(dict(bd, shape=(S, C), ms=ms_k, plain_ms=ms_p,
                         max_abs_err=err))
        del s, flux
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return dict(rows[0], shapes=rows)


def prep_bound(plan, args, airy):
    """banded_prep's least bytes for one chunk's prep, at HBM_BPS: the u
    streams written once (8 B a direction and padded source), the source
    vectors read once (24 B a source) and, with the truth payload, the
    payload rows written and the node fluxes read once (8 B each a rank and
    source); the gpubench metric prep_roofline's count."""
    S = args[1].shape[0]
    S_pad = -(-S // plan.T_s) * plan.T_s
    nbytes = 8 * plan.ndir * S_pad + 24 * S
    if airy is not None:
        nbytes += 8 * plan.rank * (S_pad + S)
    return nbytes


def banded_prep_phase(label, parms, dev):
    """Phase r: kernel banded_prep against the torch chain it replaces
    (nufft_banded.banded_prep_plain) on the inputs of every source chunk of
    the banded engine's snapshot 0 as the driver builds it for `parms`
    (spatially sorted, the truth payload of its Airy dish): the u streams,
    ok and the rotated and centred vectors equal bit for bit, the payload
    to PREP_BAR of max|P| with the same zeros, one launch a chunk; the
    times of a snapshot's preps (kernel, chain, chain, kernel) and the
    kernel's least-bytes bound. Returns the kernels line's numbers."""
    from prisim_tpu_torch.driver import banded_engine, prepare_simulation
    from prisim_tpu_torch.engine import cuda_prep
    from prisim_tpu_torch.engine import nufft_banded as nb
    from prisim_tpu_torch.engine.observe import schedule_tensors
    sim = prepare_simulation(parms, dev)
    plan, run = banded_engine(parms, sim)
    Mh, Ml, pch, pcl = (x[0] for x in schedule_tensors(
        sim.obs, sim.inst.latitude, dev))
    calls = [run.prep_args(c, Mh, Ml, pch, pcl) for c in range(run.n_chunks)]
    del sim
    if any(airy is None for _, airy in calls):
        raise SystemExit("%s prep: the engine computes no Airy payload in "
                         "the prep (truth=%s, rank %d)"
                         % (label, run.truth, plan.rank))
    n0 = cuda_prep.banded_prep_cuda.launches
    worst = 0.0
    for c, (args, airy) in enumerate(calls):
        got = cuda_prep.banded_prep_cuda(*args, airy=airy, vectors=True)
        want = nb.banded_prep_plain(*args, airy=airy, vectors=True)
        sync(dev)
        same = (all(torch.equal(g, w) for g, w in zip(
            got[:2] + got[4], want[:2] + want[4]))
            and bool(got[3]) == bool(want[3]))
        zeros = bool(torch.equal(got[2] == 0, want[2] == 0))
        scale = float(want[2].abs().max())
        err = float((got[2] - want[2]).abs().max())
        worst = max(worst, err)
        print("%s prep chunk %d of %d (%d sources, %d directions, rank %d): "
              "u streams, ok and vectors %s; payload max|dP| = %.4e of "
              "max|P| %.4e, zeros %s; ok %s"
              % (label, c, len(calls), args[1].shape[0], plan.ndir,
                 plan.rank, "bit-identical" if same else "NOT bit-identical",
                 err, scale, "equal" if zeros else "DIFFER", bool(got[3])))
        if not (same and zeros and err <= PREP_BAR * scale and bool(got[3])):
            raise SystemExit("%s prep: banded_prep differs from the torch "
                             "chain at chunk %d" % (label, c))
        del got, want
    assert cuda_prep.banded_prep_cuda.launches == n0 + len(calls)

    def kernel():
        for args, airy in calls:
            cuda_prep.banded_prep_cuda(*args, airy=airy)

    def plain():
        for args, airy in calls:
            nb.banded_prep_plain(*args, airy=airy)

    # times: kernel, plain, plain, kernel (one call, one card)
    t_k = cuda_time_ms(kernel)
    t_p = cuda_time_ms(plain)
    t_p2 = cuda_time_ms(plain)
    t_k2 = cuda_time_ms(kernel)
    bd = bound(0.0, sum(prep_bound(plan, a, airy) for a, airy in calls), 1.0)
    ms_k, ms_p = 0.5 * (t_k + t_k2), 0.5 * (t_p + t_p2)
    print("%s banded_prep time %.4f ms a snapshot (runs %.4f, %.4f; %d "
          "chunks), torch chain %.4f ms (runs %.4f, %.4f); bound %.4f ms "
          "(%s), share %.1f%%" % (label, ms_k, t_k, t_k2, len(calls), ms_p,
                                 t_p, t_p2, bd["bound_ms"], bd["bound_by"],
                                 100.0 * bd["bound_ms"] / ms_k))
    del calls
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(bd, ms=ms_k, plain_ms=ms_p, max_abs_err=worst,
                launches=cuda_prep.banded_prep_cuda.launches - n0)


def ulps(got, want):
    """The largest difference of a real or imaginary part of two complex
    arrays, in float32 ulps of |want|."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.maximum(np.abs(got.real - want.real), np.abs(got.imag - want.imag))
    return float((d / np.spacing(np.abs(want).astype(np.float32))).max())


def phase_cubes_bound(T, B, C):
    """phase_cubes's least bytes at HBM_BPS: the three (T, B, C) complex64
    cubes read once and written once, the (B, T) path and the (C,) channel
    factors read once."""
    return bound(0.0, 6 * 8 * T * B * C + 8 * B * T + 8 * C, 1.0)


def copy_to_host_ms(out):
    """Host ms of the finalize's one copy of the kernel's result `out` to
    the host (out.cpu(), into fresh memory as every simulation's is)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out.cpu()
    return (time.perf_counter() - t0) * 1e3


def finalize_phase(dev, shapes=FINALIZE_SHAPES):
    """Phase s: kernel phase_cubes against the host path it replaces (the
    transpose of the three cubes and vis.phase_centering's complex64
    branch) at each (T, B, C) of `shapes`: seeded cubes, baselines up to
    876 m, an off-zenith centre (hundreds of cycles); the cubes within
    FINALIZE_ULPS of the exact product and twice it of the host path's,
    one launch; the kernel's time (kernel, kernel) against
    its least bytes, the host path's time, and the one copy of the three
    cubes to the host (its GB/s). Returns the kernels line's numbers of the first shape and
    each shape's."""
    import dataclasses
    from prisim_tpu_torch.engine import cuda_finalize
    from prisim_tpu_torch.vis import VisibilitySet, phase_centering, \
        phase_path
    center = np.atleast_2d([62.5, 131.0])
    rows = []
    for T, B, C in shapes:
        g = torch.Generator(device=dev).manual_seed(T + B + C)
        cubes = [torch.complex(
            torch.randn((T, B, C), generator=g, device=dev),
            torch.randn((T, B, C), generator=g, device=dev))
            for _ in range(3)]
        rng = np.random.RandomState(B)
        bl = rng.uniform(-1.0, 1.0, (B, 3)) * [1.0, 1.0, 0.02]
        bl *= 876.0 / np.linalg.norm(bl, axis=1).max()
        zen = np.tile([90.0, 270.0], (T, 1))
        vs = VisibilitySet(baselines=bl, labels=np.zeros((B, 2), str),
                           freqs=100e6 + 97656.25 * np.arange(C) * (1024 // C),
                           lst=40.0 + 0.25 * np.arange(T),
                           latitude=-30.7224, phase_center=zen)
        path = torch.as_tensor(phase_path(vs, center, "altaz"), device=dev)
        nu = torch.as_tensor(vs.freqs, device=dev)

        def kernel():
            return cuda_finalize.phase_cubes_cuda(*cubes, path=path,
                                                  freqs=nu)

        def host():
            bct = [np.ascontiguousarray(np.transpose(x.cpu().numpy(),
                                                     (1, 2, 0)))
                   for x in cubes]
            return phase_centering(dataclasses.replace(
                vs, skyvis=bct[0], vis=bct[1], vis_noise=bct[2]),
                center, "altaz")

        n0 = cuda_finalize.phase_cubes_cuda.launches
        out = kernel()
        got = out.cpu().numpy()
        assert cuda_finalize.phase_cubes_cuda.launches == n0 + 1
        t0 = time.perf_counter()
        want = host()
        host_ms = (time.perf_counter() - t0) * 1e3
        exact = cuda_finalize.phase_cubes_exact(*cubes, path=path,
                                                freqs=nu).cpu().numpy()
        names = ("skyvis", "vis", "vis_noise")
        errs = [ulps(a, e) for a, e in zip(got, exact)]
        host_errs = [ulps(getattr(want, n), e) for n, e in zip(names, exact)]
        apart = [ulps(a, getattr(want, n)) for a, n in zip(got, names)]
        err = max(float(np.abs(a - getattr(want, n)).max())
                  for a, n in zip(got, names))
        print("phase_cubes, %d x %d x %d (T x B x C), off zenith, ulps of "
              "|V| (skyvis, vis, noise) from the exact product: kernel %s "
              "(bar %.1f), host path %s; kernel vs host path %s (bar %.1f), "
              "max|d| = %.4e"
              % (T, B, C, ", ".join("%.3f" % x for x in errs), FINALIZE_ULPS,
                 ", ".join("%.3f" % x for x in host_errs),
                 ", ".join("%.3f" % x for x in apart), 2 * FINALIZE_ULPS,
                 err))
        if max(errs) > FINALIZE_ULPS or max(apart) > 2 * FINALIZE_ULPS:
            raise SystemExit("phase_cubes differs from the host path at "
                             "%d x %d x %d: %s ulps from the exact product, "
                             "%s from the host's" % (T, B, C, errs, apart))
        del got, want, exact
        t_k = cuda_time_ms(kernel)
        t_k2 = cuda_time_ms(kernel)
        copy_ms = copy_to_host_ms(out)
        nbytes = out.numel() * out.element_size()
        bd = phase_cubes_bound(T, B, C)
        ms_k = 0.5 * (t_k + t_k2)
        print("phase_cubes time %.4f ms (runs %.4f, %.4f), bound %.4f ms "
              "(%s), share %.1f%%; the host path %.2f ms; the copy to the "
              "host of %.1f MB %.3f ms (%.2f GB/s)"
              % (ms_k, t_k, t_k2, bd["bound_ms"], bd["bound_by"],
                 100.0 * bd["bound_ms"] / ms_k, host_ms, nbytes / 1e6,
                 copy_ms, nbytes / copy_ms / 1e6))
        rows.append(dict(bd, shape=(T, B, C), ms=ms_k, plain_ms=host_ms,
                         max_abs_err=err, ulps=max(errs),
                         host_ulps=max(host_errs), copy_ms=copy_ms))
        del cubes, out
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return dict(rows[0], shapes=rows)


def phased_snapshot0(vs, parms, v0, t=0):
    """Snapshot `t` (default 0) `v0` (B, C), phased as run_simulation
    phases its run."""
    from prisim_tpu_torch.vis import VisibilitySet, phase_centering
    ph = parms["phasing"]
    one = VisibilitySet(baselines=vs.baselines, labels=vs.labels,
                        freqs=vs.freqs, lst=vs.lst[t:t + 1],
                        skyvis=np.asarray(v0)[:, :, None],
                        latitude=vs.latitude,
                        phase_center=vs.pointing_center[t:t + 1],
                        phase_center_coords="altaz")
    return phase_centering(one, np.atleast_2d(ph["center"]),
                           ph["coords"]).skyvis[:, :, 0]


def check_products(vs, outdir, have_h5py):
    with np.load(os.path.join(outdir, "simdata", "simvis.npz")) as f:
        assert np.array_equal(f["skyvis_freq"], vs.skyvis)
    if have_h5py:
        from prisim_tpu_torch.io import load_hdf5
        back = load_hdf5(os.path.join(outdir, "simdata", "simvis.hdf5"))
        assert np.array_equal(back.skyvis, vs.skyvis)


def gate_report(label, gate):
    """Print the gate's numbers in both normalizations; fail past GATE_TOL
    of the coherent scale, on ok=False or on a model residual > 1e-4."""
    direct0, banded0, ok, resid, coherent = gate
    dmax = float(np.abs(banded0 - direct0).max())
    vmax = float(np.abs(direct0).max())
    print("%s gate (banded vs K1a): max|dV|=%.4e  /max|V|=%.4e  "
          "/max_c sum_s|A|=%.4e  (max|V|=%.4e, max_c sum_s|A|=%.4e), "
          "ok=%s, amps-space model residual=%.4e"
          % (label, dmax, dmax / vmax, dmax / coherent, vmax, coherent, ok,
             resid))
    if not (ok and dmax / max(vmax, coherent) <= GATE_TOL and resid <= 1e-4):
        raise SystemExit("%s gate failed" % label)
    return dmax


def k2_phase(parms, cuda):
    """K2 against its plain version on snapshot 0's prep outputs, the
    gate, and the times, at the slice shape."""
    from prisim_tpu_torch.driver import banded_engine, prepare_simulation
    from prisim_tpu_torch.engine.cuda_banded import banded_spread_cuda
    from prisim_tpu_torch.engine.nufft_banded import (banded_pair_count,
                                                      banded_spread_plain)
    from prisim_tpu_torch.engine.observe import schedule_tensors
    sim = prepare_simulation(parms, cuda)
    plan, run = banded_engine(parms, sim)
    print("K2 phase: %d bl -> %d swept rows, D=%d directions, rank %d, "
          "R_max=%d, n_blk max %d mean %.2f, S=%d in %d chunk(s), truth=%s"
          % (plan.nbl_full, plan.nbl, plan.ndir, plan.rank, plan.R_max,
             plan.n_blk_max, plan.consts["n_blk_mean"],
             sim.sky.flux.shape[0], run.n_chunks, run.truth))
    Mh, Ml, pch, pcl = (x[0] for x in schedule_tensors(
        sim.obs, sim.inst.latitude, cuda))
    u_h, u_l, P_r, ok = run.prep_chunk(0, Mh, Ml, pch, pcl)
    rows_k = banded_spread_cuda(plan, u_h, u_l, P_r)
    torch.cuda.synchronize()
    rows_p = banded_spread_plain(plan, u_h, u_l, P_r)
    torch.cuda.synchronize()
    assert bool(ok) and bool(torch.isfinite(rows_k).all())
    if not torch.equal(rows_k, banded_spread_cuda(plan, u_h, u_l, P_r)):
        raise SystemExit("K2 is not deterministic: two launches differ")
    print("K2 twice on the same inputs: bit-identical")
    max_abs = float((rows_k - rows_p).abs().max())
    rel = max_abs / float(rows_p.abs().max())
    print("K2 vs plain: max|d rows|=%.4e  /max|rows|=%.4e" % (max_abs, rel))
    if not rel <= ROWS_BAR:
        raise SystemExit("K2 disagrees with its plain version: %.3e" % rel)
    pairs = banded_pair_count(plan, u_h, u_l, P_r)
    worklist_line("slice", pairs)
    bd = k2_bound(plan, u_h, P_r, pairs)
    gate_report("slice", run.gate_fn(Mh, Ml, pch, pcl))
    t_plain = cuda_time_ms(lambda: banded_spread_plain(plan, u_h, u_l, P_r))
    t_k = cuda_time_ms(lambda: banded_spread_cuda(plan, u_h, u_l, P_r))
    t_k2 = cuda_time_ms(lambda: banded_spread_cuda(plan, u_h, u_l, P_r))
    t_plain2 = cuda_time_ms(lambda: banded_spread_plain(plan, u_h, u_l, P_r))
    t_snap = cuda_time_ms(lambda: run(Mh, Ml, pch, pcl))
    ms_k, ms_p = 0.5 * (t_k + t_k2), 0.5 * (t_plain + t_plain2)
    print("K2    time: %.4f ms (runs %.4f, %.4f) per snapshot"
          % (ms_k, t_k, t_k2))
    print("plain time: %.4f ms (runs %.4f, %.4f) per snapshot"
          % (ms_p, t_plain, t_plain2))
    print("banded snapshot (prep + K2 + post): %.4f ms" % t_snap)
    print("K2 bound: %.4f ms (%s)" % (bd["bound_ms"], bd["bound_by"]))
    return dict(max_abs_err=max_abs, ms=ms_k, plain_ms=ms_p, **bd)


def host_spatial_order(s_eq_hi, s_eq_lo, nside=512):
    """spatial_order as the plan made it on the host: the directions
    copied to the host, numpy's permutation, uploaded; every row counted
    as the host's."""
    from prisim_tpu_torch import twofloat as tf
    from prisim_tpu_torch.engine import nufft_banded as nb
    perm = nb.spatial_permutation(tf.join_f64(s_eq_hi, s_eq_lo), nside)
    return torch.as_tensor(perm, device=s_eq_hi.device), int(perm.size)


def plan_phase(dev, parms=None, repeats=3):
    """Phase t: the banded plan's per-source work on the card against the
    host, at the north star (786,432 sources of the precessed nside-256
    sky): the card's spatial order against numpy's permutation (positions
    that differ, rows whose pixel the host gave), the truth path's node
    fluxes against generate_spectrum at the nodes in the host's order
    (largest difference in float64 ulps), and banded_engine's wall on the
    card path and on the host path (numpy's order, host node fluxes, host
    gather, upload), `repeats` of each in turn, with one snapshot of
    each compared. Returns the numbers; a permutation that differs, or
    snapshots that differ by more than 1e-6 of max|V|, fails the phase."""
    from prisim_tpu_torch import driver as drv
    from prisim_tpu_torch import twofloat as tf
    from prisim_tpu_torch.engine import nufft_banded as nb
    from prisim_tpu_torch.engine.nufft_delay import chebyshev_node_model
    from prisim_tpu_torch.engine.observe import schedule_tensors
    parms = parms or northstar_parms()
    sim = drv.prepare_simulation(parms, dev)
    sky, S = sim.sky, int(sim.sky.s_eq_hi.shape[0])
    sync(dev)
    t0 = time.perf_counter()
    perm, n_host = nb.spatial_order(sky.s_eq_hi, sky.s_eq_lo)
    sync(dev)
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = nb.spatial_permutation(tf.join_f64(sky.s_eq_hi, sky.s_eq_lo))
    host_ms = (time.perf_counter() - t0) * 1e3
    differ = int((perm.cpu().numpy() != host).sum())
    print("plan phase: %d sources, spatial order on %s %.2f ms (%d rows' "
          "pixels from the host), numpy %.2f ms; positions that differ: %d"
          % (S, dev.type, card_ms, n_host, host_ms, differ))
    if differ:
        raise SystemExit("plan phase: the card's spatial order differs from "
                         "the host's at %d positions" % differ)
    rank, node_model, truth, plan_kw = drv._banded_settings(parms, sim)
    nodes = chebyshev_node_model(sim.freqs, rank).nu_nodes
    want = sim.skymodel.generate_spectrum(nodes)
    got = truth["flux_nodes"](perm).cpu().numpy()
    d = np.abs(got - want[host])
    ulps = float((d / np.spacing(np.abs(want[host]))).max())
    print("plan phase: node fluxes (%d x %d float64) on %s against "
          "generate_spectrum: max %.1f ulps, %.4f%% of them not bit-equal"
          % (S, rank, dev.type, ulps, 100.0 * float((d > 0).mean())))
    del got, d, perm

    def card():
        return drv.banded_engine(parms, sim)

    def host_path():
        saved = nb.spatial_order
        nb.spatial_order = host_spatial_order
        try:
            fl = sim.skymodel.generate_spectrum(nodes)
            return drv.banded_engine(parms, sim, settings=(
                rank, node_model, dict(truth, flux_nodes=fl), plan_kw))
        finally:
            nb.spatial_order = saved

    walls = {"card": [], "host": []}
    snaps = {}
    sched = schedule_tensors(sim.obs, sim.inst.latitude, dev)
    for i in range(repeats):
        for key, fn in (("card", card), ("host", host_path)):
            snaps.pop(key, None)
            sync(dev)
            t0 = time.perf_counter()
            _, run = fn()
            sync(dev)
            walls[key].append(time.perf_counter() - t0)
            if i == repeats - 1:
                snaps[key] = run(*(a[0] for a in sched))[0].cpu().numpy()
            del run
    vc, vh = snaps["card"], snaps["host"]
    dv = float(np.abs(vc - vh).max() / np.abs(vh).max())
    wall = {k: float(np.median(v)) for k, v in walls.items()}
    print("plan phase: banded_engine wall, median of %d: card path %.3f s "
          "(%s), host path %.3f s (%s); snapshot 0 card vs host plan: "
          "max|dV|/max|V| = %.3e (%s)"
          % (repeats, wall["card"], ", ".join("%.3f" % w for w in
                                              walls["card"]),
             wall["host"], ", ".join("%.3f" % w for w in walls["host"]),
             dv, "bit-exact" if dv == 0 else "not bit-exact"))
    if dv > 1e-6:
        raise SystemExit("plan phase: the card plan's snapshot differs from "
                         "the host plan's by %.3e of max|V|" % dv)
    return dict(S=S, differ=differ, n_host=n_host, ulps=ulps,
                order_ms=card_ms, numpy_order_ms=host_ms, wall=wall,
                walls=walls, snap_err=dv)


def northstar_phase(cuda):
    """One north-star snapshot through the banded engine and its gate; K2
    against its plain version on the first source chunk, and K1a against
    the f64 golden on N_GOLDEN_BL baselines, at this shape."""
    from prisim_tpu_torch.driver import banded_engine, prepare_simulation
    from prisim_tpu_torch.engine import cuda_banded, cuda_nudft, cuda_prep
    from prisim_tpu_torch.engine.nufft_banded import (banded_pair_count,
                                                      banded_spread_plain)
    from prisim_tpu_torch.engine.observe import (schedule_tensors,
                                                 snapshot_nudft_inputs)
    p0 = cuda_prep.banded_prep_cuda.launches
    parms = northstar_parms()
    t0 = time.time()
    sim = prepare_simulation(parms, cuda)
    plan, run = banded_engine(parms, sim)
    torch.cuda.synchronize()
    print("north-star phase: %d bl -> %d swept rows, D=%d directions, rank "
          "%d, R_max=%d, n_blk max %d mean %.2f, S=%d in %d chunks of %d, "
          "truth=%s (set-up %.2f s)"
          % (plan.nbl_full, plan.nbl, plan.ndir, plan.rank, plan.R_max,
             plan.n_blk_max, plan.consts["n_blk_mean"],
             sim.sky.flux.shape[0], run.n_chunks, run.src_chunk, run.truth,
             time.time() - t0))
    Mh, Ml, pch, pcl = (x[0] for x in schedule_tensors(
        sim.obs, sim.inst.latitude, cuda))
    n1 = cuda_nudft.nudft_cuda.launches
    n2 = cuda_banded.banded_spread_cuda.launches
    t0 = time.time()
    gate = run.gate_fn(Mh, Ml, pch, pcl)
    print("north-star gate: %.2f s, K1a launches %d, K2 launches %d"
          % (time.time() - t0, cuda_nudft.nudft_cuda.launches - n1,
             cuda_banded.banded_spread_cuda.launches - n2))
    gate_report("north-star", gate)
    v, ok = run(Mh, Ml, pch, pcl)
    n_prep = cuda_prep.banded_prep_cuda.launches - p0
    print("north-star banded_prep launches, gate and one snapshot: %d (one "
          "a source chunk: %d expected)" % (n_prep, 2 * run.n_chunks))
    assert n_prep == 2 * run.n_chunks, n_prep
    assert bool(ok) and v.shape == (plan.nbl_full, 1024)
    assert bool(torch.isfinite(v).all())
    d0 = float(np.abs(v.cpu().numpy() - gate[1]).max()
               / np.abs(gate[1]).max())
    print("north-star snapshot vs the gate's banded snapshot: "
          "max|dV|/max|V| = %.3e" % d0)
    assert d0 <= 1e-6, d0
    del v, gate

    # K2 against its plain version on chunk 0: rows past shared memory
    # (R_max x 2r doubles per baseline) and the tile skip at nside 256
    preps = [run.prep_chunk(c, Mh, Ml, pch, pcl) for c in range(run.n_chunks)]
    u_h, u_l, P_r, ok0 = preps[0]
    rows_k = cuda_banded.banded_spread_cuda(plan, u_h, u_l, P_r)
    torch.cuda.synchronize()
    t0 = time.time()
    rows_p = banded_spread_plain(plan, u_h, u_l, P_r)
    torch.cuda.synchronize()
    print("north-star plain K2 on chunk 0: %.2f s" % (time.time() - t0))
    assert bool(ok0) and bool(torch.isfinite(rows_k).all())
    k2_abs = float((rows_k - rows_p).abs().max())
    k2_rel = k2_abs / float(rows_p.abs().max())
    print("north-star K2 vs plain (chunk 0 of %d, %d sources, %d rows x "
          "R_max %d): max|d rows|=%.4e  /max|rows|=%.4e"
          % (run.n_chunks, run.src_chunk, plan.nbl, plan.R_max, k2_abs,
             k2_rel))
    if not k2_rel <= ROWS_BAR:
        raise SystemExit("north-star K2 disagrees with its plain version: "
                         "%.3e" % k2_rel)
    del rows_k, rows_p
    pairs = []
    for c, (u_h, u_l, P_r, _) in enumerate(preps):
        cuda_banded.banded_spread_cuda(plan, u_h, u_l, P_r)
        pairs.append(banded_pair_count(plan, u_h, u_l, P_r))
        worklist_line("north-star chunk %d:" % c, pairs[-1])
    bds = [k2_bound(plan, u_h, P_r, n)
           for (u_h, _, P_r, _), n in zip(preps, pairs)]
    k2_bd = dict(bound_ms=sum(b["bound_ms"] for b in bds),
                 bound_by="/".join(sorted({b["bound_by"] for b in bds})))

    def spreads():
        for u_h, u_l, P_r, _ in preps:
            cuda_banded.banded_spread_cuda(plan, u_h, u_l, P_r)

    # times: plain, kernel, plain on chunk 0 (the plain version ran just
    # above, so it is warm); then K2 and the banded snapshot per snapshot
    t_p = cuda_time_ms(lambda: banded_spread_plain(plan, *preps[0][:3]),
                       n=1, warm=False)
    t_k0 = cuda_time_ms(lambda: cuda_banded.banded_spread_cuda(
        plan, *preps[0][:3]))
    t_p2 = cuda_time_ms(lambda: banded_spread_plain(plan, *preps[0][:3]),
                        n=1, warm=False)
    t_k = cuda_time_ms(spreads)
    t_snap = cuda_time_ms(lambda: run(Mh, Ml, pch, pcl))
    print("north-star chunk 0: K2 %.4f ms, plain %.4f ms (runs %.4f, %.4f)"
          % (t_k0, 0.5 * (t_p + t_p2), t_p, t_p2))
    print("north-star K2 time: %.4f ms per snapshot (%d chunks); banded "
          "snapshot (prep + K2 + post): %.4f ms" % (t_k, run.n_chunks, t_snap))
    print("north-star K2 bound: %.4f ms per snapshot (%s; %d valid pairs)"
          % (k2_bd["bound_ms"], k2_bd["bound_by"], sum(pairs)))
    del preps
    torch.cuda.empty_cache()

    # K1a over all baselines and sources, as the gate runs it, and against
    # the f64 golden on N_GOLDEN_BL baselines
    inst = sim.inst
    seh, sel, amps, _ = snapshot_nudft_inputs(inst, sim.sky, Mh, Ml, pch,
                                              pcl, sim.beam_fn)
    args = (seh, sel, inst.bl_hi, inst.bl_lo, amps, inst.grid_scalars(),
            inst.nchan)
    t0 = time.time()
    v_k = cuda_nudft.nudft_cuda(*args)
    torch.cuda.synchronize()
    print("north-star K1a first launch (%d bl x %d ch x %d sources): %.2f s"
          % (inst.nbl, inst.nchan, seh.shape[0], time.time() - t0))
    assert v_k.shape == (inst.nbl, inst.nchan)
    assert bool(torch.isfinite(v_k).all())
    k1a_ms = cuda_time_ms(lambda: cuda_nudft.nudft_cuda(*args), n=2,
                          warm=False)
    k1a_bd = nudft_bound(amps, inst.nbl, K1A_FLOPS)
    print("north-star K1a time: %.4f ms per launch = %.4e complex MAC/s; "
          "bound %.4f ms (%s; %d of %d sources above the horizon)"
          % (k1a_ms, float(seh.shape[0]) * inst.nbl * inst.nchan
             / (k1a_ms / 1e3), k1a_bd["bound_ms"], k1a_bd["bound_by"],
             k1a_bd["live"], seh.shape[0]))
    pick, lens = golden_pick(inst)
    pk = torch.as_tensor(pick, device=cuda)
    coherent = float(amps.abs().sum(dim=0).max())
    _, g_rel_v = k1a_vs_golden("north-star K1a", inst, seh, sel, amps,
                               v_k[pk], pick, lens, coherent)
    if not g_rel_v < BAR:
        raise SystemExit("north-star K1a disagrees with the golden: %.3e "
                         "(bar %.0e)" % (g_rel_v, BAR))
    return dict(k2_ms=t_k, k2_bound=k2_bd, k1a_ms=k1a_ms, k1a_bound=k1a_bd,
                snap_ms=t_snap, prep_launches=n_prep)


def joined(hi, lo):
    """The float64 value of a two-float pair of tensors, on their device."""
    from prisim_tpu_torch import twofloat as tf
    return torch.as_tensor(tf.join_f64(hi, lo), device=hi.device)


def rel_err(a, b, scale):
    """max|a - b| / scale, and max|a - b|."""
    d = float((a.to(torch.complex128) - b.to(torch.complex128)).abs().max())
    return d / scale, d


def timed_pair(kernel, plain):
    """(kernel ms, plain ms, the four runs): plain, kernel, kernel, plain,
    by CUDA events in one call."""
    t_p = cuda_time_ms(plain)
    t_k = cuda_time_ms(kernel)
    t_k2 = cuda_time_ms(kernel)
    t_p2 = cuda_time_ms(plain)
    return 0.5 * (t_k + t_k2), 0.5 * (t_p + t_p2), (t_p, t_k, t_k2, t_p2)


def mode_phase(label, sim, cuda, gradient, shaped):
    """K1b (`gradient`) or K1c (`shaped`) on snapshot 0's inputs of `sim`:
    against the plain version on all baselines and the f64 golden on
    N_GOLDEN_BL of them, then both times. Returns the kernel's outputs
    and its numbers for the kernels line."""
    from prisim_tpu_torch import twofloat as tf
    from prisim_tpu_torch.engine import cuda_nudft, observe
    from prisim_tpu_torch.engine.nudft import (nudft_reference_f64,
                                               nudft_visibilities)
    inst, sky = sim.inst, sim.sky
    Mh, Ml, pch, pcl = observe.schedule_tensors(sim.obs, inst.latitude,
                                                 cuda)
    seh, sel, amps, sh = observe.snapshot_nudft_inputs(
        inst, sky, Mh[0], Ml[0], pch[0], pcl[0], sim.beam_fn)
    sigma = sky.src_shape_sigma if shaped else None
    args = (seh, sel, inst.bl_hi, inst.bl_lo, amps, inst.grid_scalars(),
            inst.nchan)
    kw = dict(s_sky=sh, src_shape_sigma=sigma, gradient=gradient)
    S, B, C = seh.shape[0], inst.nbl, inst.nchan
    print("%s phase: S=%d sources x B=%d baselines x C=%d channels%s"
          % (label, S, B, C, "" if sigma is None else
             ", sigma_uv %.4f-%.4f" % (float(sigma.min()),
                                       float(sigma.max()))))
    if shaped:
        from prisim_tpu_torch.engine.nudft import ext_alpha, ext_chan_scale
        up = amps.abs().sum(dim=1) > 0
        alpha = ext_alpha(sh[up], sigma[up], inst.bl_hi, inst.bl_lo)
        k2 = ext_chan_scale(inst.grid_scalars(), C, device=cuda)
        print("%s weight over the %d sources above the horizon x %d "
              "baselines x %d channels: %.6f to %.6f" % (
                  label, int(up.sum()), B, C,
                  float(torch.exp(-alpha.max() * k2.max())),
                  float(torch.exp(-alpha.min() * k2.min()))))
    out_k = cuda_nudft.nudft_cuda(*args, **kw)
    again = cuda_nudft.nudft_cuda(*args, **kw)
    torch.cuda.synchronize()
    out_p = nudft_visibilities(*args, **kw)
    torch.cuda.synchronize()
    if not gradient:
        out_k, again, out_p = (out_k,), (again,), (out_p,)
    assert out_k[0].shape == (B, C)
    assert all(bool(torch.isfinite(x).all()) for x in out_k)
    if not all(torch.equal(x, y) for x, y in zip(out_k, again)):
        raise SystemExit("%s is not deterministic: two launches differ"
                         % label)
    print("%s twice on the same inputs: bit-identical (%d source splits)"
          % (label, cuda_nudft.nudft_cuda.last_splits))
    coherent = float(amps.abs().sum(dim=0).max())
    vmax = float(out_p[0].abs().max())
    rel_v, max_abs = rel_err(out_k[0], out_p[0], vmax)
    print("%s vs plain (all %d bl): max|dV|=%.4e  /max|V|=%.4e  "
          "/max_c sum_s|A|=%.4e" % (label, B, max_abs, rel_v,
                                    max_abs / coherent))
    rels = [rel_v]
    if gradient:
        gmax = float(out_p[1].abs().max())
        rel_g, g_abs = rel_err(out_k[1], out_p[1], gmax)
        print("%s planes vs plain: max|dG|=%.4e  /max|G|=%.4e  "
              "(max|G|=%.4e)" % (label, g_abs, rel_g, gmax))
        rels.append(rel_g)
        max_abs = max(max_abs, g_abs)

    pick, lens = golden_pick(inst)
    pk = torch.as_tensor(pick, device=cuda)
    bl64 = torch.as_tensor(tf.join_f64(inst.bl_hi, inst.bl_lo)[pick],
                           device=cuda)
    gold = nudft_reference_f64(joined(seh, sel), bl64, amps, inst.freqs, **kw)
    gold = gold if gradient else (gold,)
    gv = float(gold[0].abs().max())
    g_rel_v, g_abs = rel_err(out_k[0][pk], gold[0], gv)
    p_rel_v, _ = rel_err(out_p[0][pk], gold[0], gv)
    print("%s vs f64 golden (%d bl, %.1f-%.1f m): max|dV|=%.4e  "
          "/max|V|=%.4e  /max_c sum_s|A|=%.4e  (plain: /max|V|=%.4e)"
          % (label, len(pick), lens[pick[0]], lens[pick[-1]], g_abs,
             g_rel_v, g_abs / coherent, p_rel_v))
    bars = [(g_rel_v, EXT_BAR if shaped else BAR)]
    if gradient:
        gg = float(gold[1].abs().max())
        g_rel_g, _ = rel_err(out_k[1][:, pk], gold[1], gg)
        p_rel_g, _ = rel_err(out_p[1][:, pk], gold[1], gg)
        print("%s planes vs f64 golden: max|dG|/max|G|=%.4e  (plain: "
              "%.4e)" % (label, g_rel_g, p_rel_g))
        bars.append((g_rel_g, GRAD_BAR))
    if not (all(r < PLAIN_BAR for r in rels)
            and all(r < bar for r, bar in bars)):
        raise SystemExit("%s disagrees: vs plain %s (bar %.0e), vs golden "
                         "%s" % (label, rels, PLAIN_BAR, bars))
    ms_k, ms_p, runs = timed_pair(
        lambda: cuda_nudft.nudft_cuda(*args, **kw),
        lambda: nudft_visibilities(*args, **kw))
    macs = float(S) * B * C
    print("%s   time: %.4f ms (runs %.4f, %.4f) = %.4e complex MAC/s"
          % (label, ms_k, runs[1], runs[2], macs / (ms_k / 1e3)))
    print("plain time: %.4f ms (runs %.4f, %.4f)" % (ms_p, runs[0], runs[3]))
    bd = (nudft_bound(amps, B, K1B_FLOPS, out_planes=4, extra_bytes=S * 12)
          if gradient else nudft_bound(amps, B, K1C_FLOPS,
                                       extra_bytes=S * 16))
    print("%s bound: %.4f ms (%s; %d of %d sources above the horizon)"
          % (label, bd["bound_ms"], bd["bound_by"], bd["live"], S))
    return dict(out=[x.cpu().numpy() for x in out_k], max_abs_err=max_abs,
                ms=ms_k, plain_ms=ms_p, bound_ms=bd["bound_ms"],
                bound_by=bd["bound_by"])


def both_modes_small(sim, cuda, n_src=4096, n_bl=32):
    """One K1b + K1c launch on the first n_src sources above the horizon
    and n_bl baselines of snapshot 0 of `sim` (a shaped sky), against its
    plain version and the golden."""
    from prisim_tpu_torch.engine import cuda_nudft, observe
    from prisim_tpu_torch.engine.nudft import (nudft_reference_f64,
                                               nudft_visibilities)
    inst, sigma = sim.inst, sim.sky.src_shape_sigma
    Mh, Ml, pch, pcl = observe.schedule_tensors(sim.obs, inst.latitude,
                                                 cuda)
    seh, sel, amps, sh = observe.snapshot_nudft_inputs(
        inst, sim.sky, Mh[0], Ml[0], pch[0], pcl[0], sim.beam_fn)
    up = torch.nonzero(amps.abs().sum(dim=1) > 0)[:n_src, 0]
    args = (seh[up].contiguous(), sel[up].contiguous(),
            inst.bl_hi[:n_bl].contiguous(), inst.bl_lo[:n_bl].contiguous(),
            amps[up].contiguous(), inst.grid_scalars(), inst.nchan)
    kw = dict(s_sky=sh[up].contiguous(), src_shape_sigma=sigma[up].contiguous(),
              gradient=True)
    (vk, gk) = cuda_nudft.nudft_cuda(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(
            (vk, gk), cuda_nudft.nudft_cuda(*args, **kw))):
        raise SystemExit("K1b+K1c is not deterministic: two launches differ")
    (vp, gp) = nudft_visibilities(*args, **kw)
    gv, gg = nudft_reference_f64(joined(args[0], args[1]),
                                 joined(args[2], args[3]), args[4],
                                 inst.freqs, **kw)
    rv = rel_err(vk, vp, float(gv.abs().max()))[0]
    rg = rel_err(gk, gp, float(gg.abs().max()))[0]
    gv_r = rel_err(vk, gv, float(gv.abs().max()))[0]
    gg_r = rel_err(gk, gg, float(gg.abs().max()))[0]
    print("K1b+K1c (%d sources x %d bl x %d ch, two launches "
          "bit-identical): vs plain /max|V|=%.4e /max|G|=%.4e; vs f64 "
          "golden /max|V|=%.4e /max|G|=%.4e"
          % (len(up), n_bl, inst.nchan, rv, rg, gv_r, gg_r))
    if not (rv < PLAIN_BAR and rg < PLAIN_BAR and gv_r < EXT_BAR
            and gg_r < GRAD_BAR):
        raise SystemExit("K1b+K1c disagrees")


def counts():
    from prisim_tpu_torch.engine import cuda_banded, cuda_nudft, cuda_spread
    f = cuda_nudft.nudft_cuda
    return dict(k1a=f.launches, k1b=f.launches_grad, k1c=f.launches_ext,
                k2=cuda_banded.banded_spread_cuda.launches,
                spread=cuda_spread.delay_spread_cuda.launches)


def zero_counts():
    from prisim_tpu_torch.engine import cuda_banded, cuda_nudft, cuda_spread
    f = cuda_nudft.nudft_cuda
    f.launches = f.launches_grad = f.launches_ext = 0
    cuda_banded.banded_spread_cuda.launches = 0
    cuda_spread.delay_spread_cuda.launches = 0


def direct_mode_slice(label, parms, have_h5py, cuda, v0, want):
    """run_simulation(parms) on the card, expected to take the direct
    engine in one mode: checks the printed routing, the counts `want`
    (all others 0), the output, the products, and snapshot 0 against the
    kernel phase's `v0`. Returns the run's VisibilitySet and counts."""
    from prisim_tpu_torch.driver import run_simulation
    print("%s phase: run_simulation(device='cuda'), engine: auto" % label)
    t0 = time.time()
    log = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(log):
        vs, outdir = run_simulation(parms, verbose=True, save=True,
                                    device=cuda)
    got = counts()
    wall = time.time() - t0
    print(log.getvalue().rstrip())
    print("%s wall-clock: %.3f s, launches %s" % (label, wall, got))
    assert "running the direct engine" in log.getvalue()
    assert got == dict(dict.fromkeys(got, 0), **want), got
    shape = np.shape(v0) + (parms["obsparm"]["n_acc"],)
    assert vs.skyvis.shape == shape, (vs.skyvis.shape, shape)
    assert np.isfinite(vs.skyvis).all() and np.isfinite(vs.vis).all()
    want0 = phased_snapshot0(vs, parms, v0)
    d0 = np.abs(vs.skyvis[:, :, 0] - want0).max() / np.abs(want0).max()
    print("snapshot 0 vs the kernel phase: max|dV|/max|V| = %.3e (%s)"
          % (d0, "bit-exact" if d0 == 0 else "not bit-exact"))
    assert d0 <= 1e-6, d0
    check_products(vs, outdir, have_h5py)
    with np.load(os.path.join(outdir, "simdata", "simvis.npz")) as f:
        assert not any("grad" in k for k in f.files)
    print("[%s phase: %.2f s]" % (label, wall))
    return vs, got


def northstar_mode_phase(label, parms, cuda, gradient):
    """One north-star snapshot of K1b (`gradient`) or K1c (a sky with
    shapes) over all 630 baselines: its time and bound, a second launch
    bit-identical, and the kernel against its plain version and the f64
    golden on N_GOLDEN_BL baselines over all sources. Returns the time
    and the bound."""
    from prisim_tpu_torch.driver import prepare_simulation
    from prisim_tpu_torch.engine import cuda_nudft
    from prisim_tpu_torch.engine.nudft import (nudft_reference_f64,
                                               nudft_visibilities)
    from prisim_tpu_torch.engine.observe import (schedule_tensors,
                                                 snapshot_nudft_inputs)
    t0 = time.time()
    sim = prepare_simulation(parms, cuda)
    inst, sky = sim.inst, sim.sky
    Mh, Ml, pch, pcl = (x[0] for x in schedule_tensors(
        sim.obs, inst.latitude, cuda))
    seh, sel, amps, sh = snapshot_nudft_inputs(inst, sky, Mh, Ml, pch, pcl,
                                               sim.beam_fn)
    torch.cuda.synchronize()
    sigma = sky.src_shape_sigma
    S = seh.shape[0]
    print("%s phase: %d bl x %d ch x %d %s sources%s (set-up %.2f s)"
          % (label, inst.nbl, inst.nchan, S, parms["skyparm"]["model"],
             "" if sigma is None else
             ", sigma_uv %.4f" % float(sigma.min()), time.time() - t0))
    kw = dict(s_sky=sh, src_shape_sigma=sigma, gradient=gradient)
    args = (seh, sel, inst.bl_hi, inst.bl_lo, amps, inst.grid_scalars(),
            inst.nchan)

    def launch():
        out = cuda_nudft.nudft_cuda(*args, **kw)
        return out if gradient else (out,)

    t0 = time.time()
    out_k = launch()
    torch.cuda.synchronize()
    print("%s first launch: %.2f s, %d source splits"
          % (label, time.time() - t0, cuda_nudft.nudft_cuda.last_splits))
    assert out_k[0].shape == (inst.nbl, inst.nchan)
    assert all(bool(torch.isfinite(x).all()) for x in out_k)
    if not all(torch.equal(x, y) for x, y in zip(out_k, launch())):
        raise SystemExit("%s is not deterministic: two launches differ"
                         % label)
    ms = cuda_time_ms(launch, n=2, warm=False)
    bd = (nudft_bound(amps, inst.nbl, K1B_FLOPS, out_planes=4,
                      extra_bytes=S * 12) if gradient else
          nudft_bound(amps, inst.nbl, K1C_FLOPS, extra_bytes=S * 16))
    print("%s time: %.4f ms per snapshot = %.4e complex MAC/s; bound "
          "%.4f ms (%s; %d of %d sources above the horizon); two launches "
          "bit-identical" % (label, ms, float(S) * inst.nbl * inst.nchan
                             / (ms / 1e3), bd["bound_ms"], bd["bound_by"],
                             bd["live"], S))
    pick, lens = golden_pick(inst)
    pk = torch.as_tensor(pick, device=cuda)
    blh, bll = inst.bl_hi[pk].contiguous(), inst.bl_lo[pk].contiguous()
    t0 = time.time()
    out_p = nudft_visibilities(seh, sel, blh, bll, amps, inst.grid_scalars(),
                               inst.nchan, src_block=4096, **kw)
    torch.cuda.synchronize()
    t_p = time.time() - t0
    gold = nudft_reference_f64(joined(seh, sel), joined(blh, bll), amps,
                               inst.freqs, **kw)
    if not gradient:
        out_p, gold = (out_p,), (gold,)
    coherent = float(amps.abs().sum(dim=0).max())
    gv = float(gold[0].abs().max())
    r_p, _ = rel_err(out_k[0][pk], out_p[0], gv)
    r_g, d_g = rel_err(out_k[0][pk], gold[0], gv)
    print("%s vs plain (%d bl, plain %.2f s): /max|V|=%.4e; vs f64 golden "
          "(%.1f-%.1f m): max|dV|=%.4e  /max|V|=%.4e  /max_c sum_s|A|=%.4e"
          % (label, len(pick), t_p, r_p, lens[pick[0]], lens[pick[-1]], d_g,
             r_g, d_g / coherent))
    rels = [(r_p, PLAIN_BAR), (r_g, BAR if sigma is None else EXT_BAR)]
    if gradient:
        gg = float(gold[1].abs().max())
        rg_p, _ = rel_err(out_k[1][:, pk], out_p[1], gg)
        rg_g, _ = rel_err(out_k[1][:, pk], gold[1], gg)
        print("%s planes vs plain: /max|G|=%.4e; vs f64 golden: "
              "/max|G|=%.4e" % (label, rg_p, rg_g))
        rels += [(rg_p, PLAIN_BAR), (rg_g, GRAD_BAR)]
    if not all(r < bar for r, bar in rels):
        raise SystemExit("%s disagrees: %s" % (label, rels))
    return dict(ms=ms, **bd)


# --------------------------------------------------------------------------
# Phases a-e: every beam of the dispatcher on the card, BASELINE config #2
# at full size, a phased-array track, an external HEALPix beam at config
# #4's width, and sky sectors
# --------------------------------------------------------------------------

# one beam on the card against the same torch code on the CPU, max|d pb| /
# max|pb|: float32 maths, rounded by other libraries (the bar of
# tests/test_torch_beams.py against JAX)
BEAM_CPU_BAR = 1e-5
# the CPU side takes every BEAM_CPU_STRIDE-th direction (a beam's rows are
# independent of each other)
BEAM_CPU_STRIDE = 8
# config #2's engine auto run against its engine direct run, max|dV| /
# max_c sum_s |A|: the gate's 2e-6, with room for the snapshots it does not
# see
CFG2_BAR = 1e-5
STEER_BAR = 2e-5      # a track snapshot vs a 1-acc run at its LST, of max|V|
SECTOR_BAR = 2e-4     # the sum of the sectors vs the full run, of max|V|
# K1a on ExternalBeam.evaluate's float64 host beam against the route's
# snapshot (float32 log table and weights on the card), max|dV| / max_c
# sum_s |A|: the float32 beam's rounding (~6e-8 of its peak of 1 in a CPU
# run at small size) with room
EXT_HOST_BAR = 1e-6
EXT_HOST_CHANS = (448, 576)   # the channels of that comparison
SIDEREAL_DEG_PER_SEC = 360.0 / 86164.0905


def beam_cases():
    """(label, telescope, pointing_info) of every branch of the dispatcher:
    each telescope id, each generic shape with and without a ground plane,
    the MWA tile steered with no errors and with delay and gain errors
    (4 realizations), an aperture of isotropic radiators alone and lit by a
    feed, and a steered array of dipoles."""
    from prisim_tpu_torch.beams import mwa_tile_positions
    point = (0.1, -0.05, float(np.sqrt(1.0 - 0.1 ** 2 - 0.05 ** 2)))
    locs = np.random.RandomState(11).uniform(-3, 3, (12, 3)) * [1, 1, 0.1]
    steer = {"pointing_center_dircos": point}
    cases = [("id %s" % tid, {"id": tid}, None) for tid in
             ("vla", "gmrt", "ugmrt", "hera", "hirax", "mwa", "mwa_dipole",
              "paper")]
    for shape in ("delta", "dipole", "dish", "gaussian", "rect", "square"):
        size = {"rect": (4.0, 2.0), "dipole": 0.74}.get(shape, 2.0)
        for gp in (None, 0.3):
            cases.append(("%s%s" % (shape, ", ground plane" if gp else ""),
                          {"id": "custom", "shape": shape, "size": size,
                           "groundplane": gp}, None))
    return cases + [
        ("mwa tile steered, no errors", {"id": "mwa"}, steer),
        ("mwa tile steered, errors", {"id": "mwa"},
         dict(steer, delayerr=1e-9, gainerr=0.5, nrand=4)),
        ("aperture", {"id": "custom", "aperture_locs": locs}, steer),
        ("aperture lit by a feed",
         {"id": "custom", "aperture_locs": locs,
          "feedinfo": {"shape": "dipole", "size": 1.2,
                       "position": (0.0, 0.0, 2.0)}}, steer),
        ("dipole array steered",
         {"id": "custom", "shape": "dipole", "size": 0.74,
          "element_locs": mwa_tile_positions()}, steer)]


def beams_phase(dirs, freqs, dev):
    """Phase a: every beam of beam_cases() on the card at the directions
    `dirs` (S, 3) x `freqs` (C,) (float32 on `dev`; the VLA/GMRT ids 250 MHz
    higher, where uGMRT has a band), against the same torch code on the CPU
    on every BEAM_CPU_STRIDE-th direction (a beam with errors: both draws
    from one CPU generator seeded 0), and each beam twice on the card with
    its default generator, bit-identical. Checks device, dtype and shape;
    prints each beam's card time."""
    from prisim_tpu_torch.beams import primary_beam
    S, C = dirs.shape[0], freqs.shape[0]
    dirs_cpu = dirs[::BEAM_CPU_STRIDE].cpu()
    print("beams phase: %d directions x %d channels on %s; the CPU on every "
          "%dth direction (%d)" % (S, C, dev, BEAM_CPU_STRIDE,
                                   dirs_cpu.shape[0]))
    worst = 0.0
    for label, tel, pinfo in beam_cases():
        f = freqs + 250e6 if tel["id"] in ("vla", "gmrt", "ugmrt") else freqs
        kw = dict(pointing_info=pinfo, band_freq=float(f[0]))

        def card(**more):
            return primary_beam(dirs, f, tel, **kw, **more)

        pb = card()
        if not (pb.device == dirs.device and pb.dtype == torch.float32
                and pb.shape == (S, C)):
            raise SystemExit("beam %s: %s %s %s on the card" % (
                label, pb.device, pb.dtype, tuple(pb.shape)))
        if not bool(torch.isfinite(pb).all()):
            raise SystemExit("beam %s: not finite on the card" % label)
        if not torch.equal(pb, card()):
            raise SystemExit("beam %s: two calls differ" % label)
        ms = cuda_time_ms(card, n=1, warm=False)
        errors = bool(pinfo and pinfo.get("delayerr"))
        if errors:
            pb = card(generator=torch.Generator().manual_seed(0))
            more = dict(generator=torch.Generator().manual_seed(0))
        else:
            more = {}
        ref = primary_beam(dirs_cpu, f.cpu(), tel, **kw, **more)
        rel = float((pb[::BEAM_CPU_STRIDE].cpu() - ref).abs().max()
                    / ref.abs().max())
        worst = max(worst, rel)
        print("beam %-32s card %.4f ms, max %.4e, vs CPU max|d|/max = %.4e%s"
              % (label, ms, float(pb.abs().max()), rel,
                 "; two calls bit-identical" + (
                     " (errors, nrand %d)" % pinfo["nrand"] if errors else "")))
        if not rel <= BEAM_CPU_BAR:
            raise SystemExit("beam %s: card vs CPU %.3e (bar %.0e)"
                             % (label, rel, BEAM_CPU_BAR))
        del pb, ref
    print("beams phase: %d beams, worst card vs CPU %.4e (bar %.0e)"
          % (len(beam_cases()), worst, BEAM_CPU_BAR))


def engine_ran(log):
    """The engine a run took, from its verbose log."""
    if "falling back to the direct engine" in log:
        return ("sorted" if "delay-space NUFFT" in log else "banded") + \
            ", demoted to direct"
    if "delay-space NUFFT" in log:
        return "sorted"
    return "banded" if "banded NUFFT:" in log else "direct"


def drive(label, parms, dev, save=False, devices=None):
    """run_simulation(parms) with the kernel counts set to 0 just before
    and read just after (on `devices`, a mesh, where given). Prints its
    log, wall-clock, engine and K1a and K2 launches; every route of this
    slice launches K1a (the direct engine, or the banded engine's gate).
    Returns (result, log, counts, seconds)."""
    from prisim_tpu_torch.driver import run_simulation
    log = io.StringIO()
    zero_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(log):
        out = run_simulation(parms, verbose=True, save=save, device=dev,
                             devices=devices)
    wall = time.time() - t0
    got = counts()
    text = log.getvalue()
    print(text.rstrip())
    print("%s: wall-clock %.3f s, engine %s, launches K1a %d, K2 %d, "
          "delay_spread %d (%s)" % (label, wall, engine_ran(text), got["k1a"],
                                    got["k2"], got["spread"], got))
    if got["k1a"] == 0:
        raise SystemExit("%s: K1a never launched" % label)
    if engine_ran(text) == "banded" and got["k2"] == 0:
        raise SystemExit("%s: banded run without a K2 launch" % label)
    if engine_ran(text) == "sorted" and got["spread"] == 0:
        raise SystemExit("%s: sorted run without a delay_spread launch"
                         % label)
    return out, text, got, wall


def coherent_scale(parms, dev):
    """The coherent flux scale of a run, max over snapshots and channels of
    sum_s |A_sc|, and its source count."""
    from prisim_tpu_torch.driver import prepare_simulation
    from prisim_tpu_torch.engine.observe import (schedule_tensors,
                                                 snapshot_nudft_inputs)
    sim = prepare_simulation(parms, dev)
    Mh, Ml, pch, pcl = schedule_tensors(sim.obs, sim.inst.latitude, dev)
    best = 0.0
    for t in range(Mh.shape[0]):
        amps = snapshot_nudft_inputs(sim.inst, sim.sky, Mh[t], Ml[t], pch[t],
                                     pcl[t], sim.beam_fn)[2]
        best = max(best, float(amps.abs().sum(dim=0).max()))
    return best, sim.sky.flux.shape[0]


def config2_parms(root, engine, simid, nant=128, nchan=256, nsrc=4096,
                  n_acc=10, **sections):
    """BASELINE config #2 (MWA-128 catalog) as
    benchmarks/bench_configs.config2 builds it: nant antennas random-uniform
    over +-750 m from default_rng(42) (its stand-in for the MWA layout
    file), then from the same generator the catalog of nsrc sources (RA
    0-360, dec -80-20, Pareto(1.8) + 0.05 Jy, spectral index -0.83 +- 0.1)
    written as a text file; mwa_dipole, chromatic; nchan x 160 kHz at 150
    MHz; n_acc x 112 s drift from LST 0; NPZ products. `sections` update the
    parameter sections."""
    from prisim_tpu_torch.config import load_parms
    rng = np.random.default_rng(42)
    pos = np.zeros((nant, 3))
    pos[:, :2] = rng.uniform(-750, 750, (nant, 2))
    loc = np.stack([rng.uniform(0, 360, nsrc),
                    rng.uniform(-80, 20, nsrc)], axis=-1)
    flux = rng.pareto(1.8, nsrc) + 0.05
    spindex = rng.normal(-0.83, 0.1, nsrc)
    os.makedirs(root, exist_ok=True)
    cat = os.path.join(root, "cfg2_catalog.txt")
    with open(cat, "w") as f:
        f.write("# ra dec flux spindex\n")
        for i in range(nsrc):
            f.write(f"{loc[i,0]:.6f} {loc[i,1]:.6f} {flux[i]:.4f} "
                    f"{spindex[i]:.4f}\n")
    p = {
        "dirstruct": {"rootdir": root, "project": "bench_cfg2",
                      "simid": simid},
        "telescope": {"id": "mwa_dipole", "latitude": -26.7,
                      "A_eff": 21.0, "Trx": 50.0},
        "array": {"layout_positions": pos.tolist()},
        "antenna": {"shape": "dipole", "size": 0.74},
        "beam": {"use_external": False, "chromatic": True},
        "bandpass": {"freq": 150e6, "freq_resolution": 160e3,
                     "nchan": nchan},
        "obsparm": {"obs_mode": "drift", "n_acc": n_acc, "t_acc": 112.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "custom"},
        "catalog": {"custom_file": cat},
        "processing": {"engine": engine},
        "save_formats": {"fmt": "none", "npz": True},
    }
    for sec, val in sections.items():
        p[sec] = dict(p.get(sec, {}), **val)
    return load_parms(p)


def gate_readings(dump):
    """The banded gate's readings from its PRISIM_DEBUG_XCHECK_DUMP file."""
    with np.load(dump) as g:
        dmax = float(np.abs(g["fast0"] - g["direct0"]).max())
        return ("ok=%s, max|dV|/max|V|=%.4e, /max_c sum_s|A|=%.4e, truth "
                "amps %s, model residual %.4e"
                % (bool(g["ok0"]), dmax / float(np.abs(g["direct0"]).max()),
                   dmax / float(g["csA0"]), bool(g["truth_on"]),
                   float(g["resid0"])))


def config2_phase(root, dev, **sizes):
    """Phase b: config #2 with engine auto (the banded engine behind its
    gate on a card: whether the gate passed or the run was demoted, and the
    gate's readings) and engine direct; both wall-clocks and the runs'
    difference in both normalizations. Twice: as config2 builds it
    (skyparm.flux_min takes its default of 10 Jy), with its NPZ products,
    and with skyparm.flux_min: 0 (every catalog source), without products
    (writing them takes ~30 s a run on the card machine's host). Returns
    {cut: numbers}."""
    out = {}
    for cut, extra, save in (
            ("as built", {}, True),
            ("flux_min 0", {"skyparm": {"flux_min": 0.0}}, False)):
        runs = {}
        for engine in ("auto", "direct"):
            simid = "cfg2_%s_%s" % ("all" if extra else "cut", engine)
            parms = config2_parms(root, engine, simid, **sizes, **extra)
            n_acc = parms["obsparm"]["n_acc"]
            dump = os.path.join(root, simid + "_gate.npz")
            if os.path.exists(dump):
                os.remove(dump)
            if engine == "auto":
                os.environ["PRISIM_DEBUG_XCHECK_DUMP"] = dump
            try:
                (vs, outdir), log, got, wall = drive(
                    "config #2 (%s), engine %s" % (cut, engine), parms, dev,
                    save=save)
            finally:
                os.environ.pop("PRISIM_DEBUG_XCHECK_DUMP", None)
            nant = len(parms["array"]["layout_positions"])
            shape = (nant * (nant - 1) // 2, parms["bandpass"]["nchan"], n_acc)
            assert vs.skyvis.shape == shape, (vs.skyvis.shape, shape)
            assert np.isfinite(vs.skyvis).all() and np.isfinite(vs.vis).all()
            if save:
                check_products(vs, outdir, False)
            eng = engine_ran(log)
            if engine == "direct":
                assert got == dict(dict.fromkeys(got, 0), k1a=n_acc), got
            elif os.path.exists(dump):
                print("config #2 (%s) gate: %s; %s" % (
                    cut, gate_readings(dump), "passed" if eng == "banded"
                    else "the run was demoted to the direct engine"))
            runs[engine] = (vs.skyvis, wall, eng)
        coh, nsky = coherent_scale(parms, dev)
        d = float(np.abs(runs["auto"][0] - runs["direct"][0]).max())
        vmax = float(np.abs(runs["direct"][0]).max())
        print("config #2 (%s): %s bl x %d ch x %d acc, %d sources in the sky "
              "of %d in the catalog; engine auto (%s) %.3f s, engine direct "
              "%.3f s; auto vs direct max|dV|=%.4e  /max|V|=%.4e  "
              "/max_c sum_s|A|=%.4e" % (
                  cut, vs.skyvis.shape[0], vs.skyvis.shape[1],
                  vs.skyvis.shape[2], nsky, sizes.get("nsrc", 4096),
                  runs["auto"][2], runs["auto"][1], runs["direct"][1], d,
                  d / vmax, d / coh))
        if not d / coh <= CFG2_BAR:
            raise SystemExit("config #2 (%s): auto vs direct %.3e (bar %.0e)"
                             % (cut, d / coh, CFG2_BAR))
        out[cut] = dict(auto_s=runs["auto"][1], direct_s=runs["direct"][1],
                        engine=runs["auto"][2], nsky=nsky)
        del vs, runs
    return out


def track_parms(root, simid, lst_init_h, n_acc, sizes, **phasedarray):
    """Config #2's array, band and catalog seen by a steered MWA tile
    (telescope.id: mwa, antenna.phased_array) tracking RA 30, dec -26.7
    from lst_init_h hours in n_acc accumulations of 3,600 s; engine auto.
    The catalog stays at its epoch (skyparm.epoch: null): a run precesses
    it to the run's mean epoch, which differs by 1.5 h between a 4- and a
    1-accumulation run, a shift that 1.5 km baselines resolve (~4e-5 of
    max|V| in a CPU run at small size), where the steering check wants the
    two runs to differ only in their pointing."""
    return config2_parms(
        root, "auto", simid, n_acc=n_acc, telescope={"id": "mwa"},
        antenna={"phased_array": True},
        phasedarray=dict({"delayerr": 0.0, "gainerr": 0.0}, **phasedarray),
        obsparm={"obs_mode": "track", "t_acc": 3600.0},
        pointing={"lst_init": lst_init_h,
                  "track_init": {"ra": 30.0, "dec": -26.7}},
        skyparm={"epoch": None}, **sizes)


def track_phase(root, dev, **sizes):
    """Phase c: the phased-array track in 4 accumulations; snapshot 1 equals
    a 1-accumulation run at its LST (the pointing reaches the beam each
    snapshot) and differs from snapshot 0; then delay and gain errors with 4
    realizations, run twice: bit-identical, and unlike the run without
    errors."""
    (vs4, _), _, _, w4 = drive("phased-array track, 4 acc",
                               track_parms(root, "track4", 0.0, 4, sizes),
                               dev)
    lst1 = 3600.0 * SIDEREAL_DEG_PER_SEC / 15.0
    (vs1, _), _, _, w1 = drive("phased-array track, 1 acc at snapshot 1's "
                               "LST", track_parms(root, "track1", lst1, 1,
                                                  sizes), dev)
    a, b = vs4.skyvis[..., 1], vs1.skyvis[..., 0]
    scale = float(np.abs(a).max())
    d1 = float(np.abs(a - b).max()) / scale
    d0 = float(np.abs(a - vs4.skyvis[..., 0]).max()) / scale
    print("phased-array track: snapshot 1 vs the 1-acc run at its LST "
          "max|dV|/max|V| = %.4e (bar %.0e); vs snapshot 0 %.4e"
          % (d1, STEER_BAR, d0))
    if not (np.isfinite(vs4.skyvis).all() and d1 <= STEER_BAR and d0 > 1e-3):
        raise SystemExit("phased-array track: the steering does not follow "
                         "the snapshots")
    err = dict(delayerr=1e-9, gainerr=0.5, nrand=4)
    walls = []
    vis = []
    for k in range(2):
        (vs, _), _, _, w = drive(
            "phased-array track with delay/gain errors, run %d" % (k + 1),
            track_parms(root, "track_err%d" % k, 0.0, 4, sizes, **err), dev)
        vis.append(vs.skyvis)
        walls.append(w)
    same = np.array_equal(vis[0], vis[1])
    de = float(np.abs(vis[0] - vs4.skyvis).max()) / float(
        np.abs(vs4.skyvis).max())
    print("phased-array track with errors (delayerr 1 ns, gainerr 0.5 dB, "
          "nrand 4): two runs %s; vs no errors max|dV|/max|V| = %.4e"
          % ("bit-identical" if same else "DIFFER", de))
    if not (same and de > 1e-3):
        raise SystemExit("phased-array errors do not repeat or do not act")
    return dict(track_s=w4, one_s=w1, err_s=walls)


def write_feko_like_beam(path, nside=64, freqs=np.linspace(100e6, 200e6, 8),
                         d_eff=14.0):
    """The chromatic beam of benchmarks/bench_configs._write_synthetic_feko
    as a HEALPix FITS file written with the port's write_image: an
    elliptical gaussian in sin(theta) of width ~ lambda/D (sigma 0.42
    c / (nu D) times 1.08 and 0.94) with its first-sidelobe ripple, at the
    model frequencies `freqs`; 1e-6 below the horizon. Returns `path`."""
    from prisim_tpu_torch import healpix as hp
    from prisim_tpu_torch.constants import c
    from prisim_tpu_torch.io.fitsio import write_image
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    st = np.sin(theta)
    maps = []
    for nu in freqs:
        sig0 = 0.42 * c / (nu * d_eff)
        arg = ((st * np.cos(phi)) / (1.08 * sig0)) ** 2 \
            + ((st * np.sin(phi)) / (0.94 * sig0)) ** 2
        gdb = -10.0 * arg / np.log(10.0) + 3.0 * np.sin(
            4.0 * st / sig0) ** 2 * np.exp(-0.5 * arg) * 0.05
        maps.append(10.0 ** (gdb / 10.0))
    maps = np.stack(maps, axis=1)
    maps[theta > 0.5 * np.pi] = 1e-6
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        write_image(fh, maps, primary=True)
        write_image(fh, np.asarray(freqs), extname="FREQS")
    return path


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def external_phase(parms, dev, host_chans=EXT_HOST_CHANS, save=False):
    """Phase d: the external-beam route (beam.use_external with a FITS
    file), which runs the direct engine (K1a): the run (with its products
    where `save`), then its snapshots again as the route runs them, each
    split into host weights (rotate on the card, fetch the directions,
    angular weights on the host, upload), device beam
    (ExternalBeam.device_evaluate) and K1a; snapshot 0 against the run's,
    and against K1a on the beam of ExternalBeam.evaluate (host, float64)
    over the channels `host_chans`. Returns the times, the run's launches
    and its output directory."""
    from prisim_tpu_torch import geometry as geom
    from prisim_tpu_torch.beams import ExternalBeam
    from prisim_tpu_torch.driver import prepare_simulation
    from prisim_tpu_torch.engine import cuda_nudft
    from prisim_tpu_torch.engine.observe import (df_rotate3,
                                                 schedule_tensors,
                                                 snapshot_nudft_inputs)
    n_acc = parms["obsparm"]["n_acc"]
    (vs, outdir), _, got, wall = drive("external beam", parms, dev, save=save)
    assert got == dict(dict.fromkeys(got, 0), k1a=n_acc), got
    assert np.isfinite(vs.skyvis).all()
    sim = prepare_simulation(parms, dev)
    inst, sky = sim.inst, sim.sky
    ext = ExternalBeam.from_fits(parms["beam"]["file"])
    logtable = torch.as_tensor(ext.channel_table(sim.freqs), device=dev)
    chunk = max(1, (1 << 28) // (4 * inst.nchan))
    Mh, Ml, pch, pcl = schedule_tensors(sim.obs, inst.latitude, dev)
    times = []
    for t in range(n_acc):
        sync(dev)
        t0 = time.time()
        sh, _ = df_rotate3(Mh[t], Ml[t], sky.s_eq_hi, sky.s_eq_lo)
        altaz = geom.dircos2altaz(np.clip(sh.cpu().numpy().astype(
            np.float64), -1.0, 1.0), xp=np)
        pix, wgt = (torch.as_tensor(x, device=dev)
                    for x in ext.interp_weights(altaz))
        sync(dev)
        host_s = time.time() - t0

        def beam(s, f):
            return ExternalBeam.device_evaluate(logtable, pix, wgt, chunk)

        beam_ms = cuda_time_ms(lambda: beam(None, None), n=1)
        seh, sel, amps, _ = snapshot_nudft_inputs(inst, sky, Mh[t], Ml[t],
                                                  pch[t], pcl[t], beam)
        args = (seh, sel, inst.bl_hi, inst.bl_lo, amps, inst.grid_scalars(),
                inst.nchan)
        v = cuda_nudft.nudft_cuda(*args)
        k1a_ms = cuda_time_ms(lambda: cuda_nudft.nudft_cuda(*args), n=1,
                              warm=False)
        times.append(dict(host_s=host_s, beam_ms=beam_ms, k1a_ms=k1a_ms))
        print("external beam snapshot %d: host weights %.4f s (rotate, fetch "
              "%d directions, angular weights, upload), device beam %.4f ms "
              "(%d source chunks), K1a %.4f ms"
              % (t, host_s, sh.shape[0], beam_ms,
                 -(-sh.shape[0] // chunk), k1a_ms))
        if t == 0:
            want = phased_snapshot0(vs, parms, v.cpu().numpy())
            d0 = np.abs(vs.skyvis[:, :, 0] - want).max() / np.abs(want).max()
            print("external beam snapshot 0 vs the run's: max|dV|/max|V| = "
                  "%.3e" % d0)
            assert d0 <= 1e-6, d0
            c0, c1 = host_chans
            t0 = time.time()
            pb = ext.evaluate(altaz, sim.freqs[c0:c1])
            eval_s = time.time() - t0
            pb = torch.as_tensor(pb, dtype=torch.float32, device=dev)
            fl = sky.flux[:, c0:c1]
            amps_h = torch.where((sh[:, 2] > 0.0)[:, None], pb * fl,
                                 torch.zeros_like(fl)).contiguous()
            v_h = cuda_nudft.nudft_cuda(seh, sel, inst.bl_hi, inst.bl_lo,
                                        amps_h, inst.grid_scalars(),
                                        c1 - c0, chan0=c0)
            coh = float(amps_h.abs().sum(dim=0).max())
            vr = v[:, c0:c1]
            dh = float((vr - v_h).abs().max())
            vmax = float(vr.abs().max())
            print("external beam snapshot 0, channels %d-%d: K1a on the host "
                  "ExternalBeam.evaluate beam (%.2f s) vs the route's: "
                  "max|dV|=%.4e  /max|V|=%.4e  /max_c sum_s|A|=%.4e (bar "
                  "%.0e); max|d beam| over the sources above the horizon "
                  "%.4e" % (c0, c1 - 1, eval_s, dh, dh / vmax, dh / coh,
                            EXT_HOST_BAR,
                            float((pb - beam(None, None)[:, c0:c1])[
                                sh[:, 2] > 0].abs().max())))
            if not dh / coh <= EXT_HOST_BAR:
                raise SystemExit("external beam: the route disagrees with "
                                 "the host beam: %.3e" % (dh / coh))
            del pb, amps_h, v_h
        del seh, sel, amps, args, v, pix, wgt
    return dict(wall_s=wall, snapshots=times, launches=got, outdir=outdir)


def sectors_phase(parms, full, dev):
    """Phase e: processing.n_sky_sectors on engine auto; the sum of the
    sector outputs against the full run, and the engine of each sector (at
    least one banded, without the float64 truth beam, which sectors never
    take)."""
    n = parms["processing"]["n_sky_sectors"]
    (outs, _), log, got, wall = drive("sky sectors (%d)" % n, parms, dev)
    assert len(outs) == n
    parts = log.split("sky sector ")[1:]
    plain_banded = 0
    for k, part in enumerate(parts):
        if outs[k] is None:
            print("sky sector %d: no source enters it" % k)
            continue
        eng = engine_ran(part)
        truth = "truth amps" in part
        plain_banded += eng == "banded" and not truth
        print("sky sector %d: engine %s, truth amps %s" % (k, eng, truth))
        if truth:
            raise SystemExit("sky sector %d took the truth beam" % k)
    (vf, _), _, _, wall_f = drive("full sky (the sectors' reference)", full,
                                  dev)
    tot = sum(v.skyvis for v in outs if v is not None)
    d = float(np.abs(tot - vf.skyvis).max())
    rel = d / float(np.abs(vf.skyvis).max())
    print("sky sectors: %d of %d run banded without the truth beam; sum vs "
          "full run max|dV|/max|V| = %.4e (bar %.0e), /max_c sum_s|A| = "
          "%.4e; %.3f s for the sectors, %.3f s for the full run"
          % (plain_banded, n, rel, SECTOR_BAR,
             d / coherent_scale(full, dev)[0], wall, wall_f))
    if not (rel <= SECTOR_BAR and plain_banded >= 1):
        raise SystemExit("sky sectors failed")
    return dict(sectors_s=wall, full_s=wall_f)


# --------------------------------------------------------------------------
# Phases f-g: full polarization at full size on config #2, dual
# polarization with the native FITS, UVFITS and redundant-expansion
# products on the HERA-37 slice
# --------------------------------------------------------------------------

MUELLER_CPU_BAR = 1e-6    # Mueller weights card vs CPU, max|d B| / max|B|
# X and Y runs of a circular dish, max|V_X - V_Y| / max|V| (the same beam)
DISH_XY_BAR = 1e-7


@contextlib.contextmanager
def component_counts():
    """Record, for every run_simulation call made inside another (the
    polarization components of a pol run), its component (the Mueller
    component, else beam.pol), wall-clock and kernel launches: yields the
    list the records go into."""
    from prisim_tpu_torch import driver as drv
    outer = drv.run_simulation
    records, depth = [], [0]

    def run(parms, *a, **k):
        depth[0] += 1
        c0, t0 = counts(), time.time()
        try:
            return outer(parms, *a, **k)
        finally:
            depth[0] -= 1
            if depth[0] > 0:
                c1 = counts()
                records.append(dict(
                    comp=str(parms.get("_mueller_component")
                             or parms["beam"]["pol"]),
                    wall=time.time() - t0,
                    launches={n: c1[n] - c0[n] for n in c1}))

    drv.run_simulation = run
    try:
        yield records
    finally:
        drv.run_simulation = outer


def component_logs(log):
    """The verbose log of a pol run cut into its component runs' logs, each
    ending at its "done in" line (a demoted attempt prints none)."""
    parts, cur = [], []
    for line in log.splitlines():
        cur.append(line)
        if line.startswith("[prisim_tpu_torch] done in"):
            parts.append("\n".join(cur))
            cur = []
    return parts


def gate_line(log):
    """The gate's readings in both normalizations from a component's log."""
    for line in log.splitlines():
        if "cross-check" in line:
            return line[line.find("(") + 1:line.rfind(")")]
    return "no gate"


def report_components(label, log, records):
    """Print each component's engine, gate readings, launches and
    wall-clock; returns {component: record with the engine}."""
    out = {}
    for rec, part in zip(records, component_logs(log)):
        rec["engine"] = engine_ran(part)
        out[rec["comp"]] = rec
        print("%s component %s: engine %s, K1a %d, K2 %d launches, "
              "%.3f s; gate: %s" % (label, rec["comp"], rec["engine"],
                                    rec["launches"]["k1a"],
                                    rec["launches"]["k2"], rec["wall"],
                                    gate_line(part)))
    return out


def stokes_cube(path, npol):
    """The (Ntimes, Nbls, Nfreq, npol) visibilities and (..., npol) weights
    of a UVFITS file, read with the port's read_fits, un-conjugated."""
    from prisim_tpu_torch.io.fitsio import read_fits
    (gh,) = [h for h in read_fits(path) if "pars" in h]
    assert int(gh["header"]["NAXIS3"]) == npol
    d = gh["data"].reshape(gh["data"].shape[0], -1, npol, 3)
    return np.conj(d[..., 0] + 1j * d[..., 1]), d[..., 2]


def to_cube(v_tm, vs):
    """(Nblts, Nfreq) time-major rows -> (nbl, nchan, n_acc)."""
    return v_tm.reshape(vs.n_acc, vs.nbl, vs.nchan).transpose(1, 2, 0)


def fullpol_phase(root, dev, **sizes):
    """Phase f: beam.pol full on config #2 at full size, engine auto: the
    XX, YY and XY component runs (each one's engine, gate readings,
    launches), the XY component on engine direct against the banded one,
    the combined 4-pol UVFITS read back, and the Mueller weights of
    snapshot 0 on the card against the CPU. Returns the numbers."""
    import copy
    from prisim_tpu_torch.beams import mueller_unpol_weights
    from prisim_tpu_torch.driver import prepare_simulation
    from prisim_tpu_torch.engine.observe import df_rotate3, schedule_tensors
    from prisim_tpu_torch.io.uvfits import load_uvfits
    parms = config2_parms(root, "auto", "cfg2_fullpol",
                          beam={"pol": "full"},
                          save_formats={"fmt": "none", "npz": False},
                          **sizes)
    parms["save_redundant"] = False
    with component_counts() as records:
        (outs, outdir), log, got, wall = drive(
            "full polarization, config #2", parms, dev, save=True)
    comps = report_components("full polarization", log, records)
    vs_xx, vs_yy, vs_xy = outs
    assert [r["comp"] for r in records] == ["XX", "YY", "XY"], records
    banded = sum(r["engine"] == "banded" for r in records)
    export_s = wall - sum(r["wall"] for r in records)
    print("full polarization: %d of 3 components banded; launches K1a %d, "
          "K2 %d (expected 3 and 33 if none demotes); the combined 4-pol "
          "UVFITS written in %.3f s (the run's wall-clock less its "
          "components')" % (banded, got["k1a"], got["k2"], export_s))
    for vs in outs:
        assert np.isfinite(vs.skyvis).all() and np.isfinite(vs.vis).all()

    direct = copy.deepcopy(parms)
    direct["processing"]["engine"] = "direct"
    direct["beam"]["pol"] = "X"
    direct["_mueller_component"] = "XY"
    (vd, _), _, got_d, wall_d = drive("XY component, engine direct", direct,
                                      dev)
    assert got_d == dict(dict.fromkeys(got_d, 0),
                         k1a=direct["obsparm"]["n_acc"]), got_d
    coh, _ = coherent_scale(direct, dev)
    d = float(np.abs(vs_xy.skyvis - vd.skyvis).max())
    vmax = float(np.abs(vd.skyvis).max())
    print("XY component, engine %s vs direct: max|dV|=%.4e  /max|V|=%.4e  "
          "/max_c sum_s|A|=%.4e (bar %.0e); max|V_XY|/max|V_XX| = %.4e"
          % (comps["XY"]["engine"], d, d / vmax, d / coh, GATE_TOL,
             vmax / float(np.abs(vs_xx.skyvis).max())))
    if not d / coh <= GATE_TOL:
        raise SystemExit("full polarization: the XY component on engine %s "
                         "disagrees with engine direct: %.3e of the coherent "
                         "scale" % (comps["XY"]["engine"], d / coh))

    path = os.path.join(outdir, "simdata", "simvis_fullpol.uvfits")
    t0 = time.time()
    back = load_uvfits(path)
    cube, wts = stokes_cube(path, 4)
    read_s = time.time() - t0
    same = [np.array_equal(to_cube(cube[..., p], vs_xx), vs.skyvis)
            for p, vs in enumerate((vs_xx, vs_yy, vs_xy, vs_xy))]
    print("full polarization: %s (%.1f MB) read back in %.2f s: "
          "load_uvfits XX equal %s, XX/YY/XY/YX equal %s, weights > 0 %s"
          % (os.path.basename(path), os.path.getsize(path) / 1e6, read_s,
             np.array_equal(back.skyvis, vs_xx.skyvis), same,
             bool((wts > 0).all())))
    if not (np.array_equal(back.skyvis, vs_xx.skyvis) and all(same)
            and (wts > 0).all()):
        raise SystemExit("full polarization: the 4-pol UVFITS does not hold "
                         "the simulated cubes")
    del back, cube, wts

    sim = prepare_simulation(direct, dev)
    Mh, Ml, _, _ = schedule_tensors(sim.obs, sim.inst.latitude, dev)
    dirs = df_rotate3(Mh[0], Ml[0], sim.sky.s_eq_hi, sim.sky.s_eq_lo)[0]
    f32 = torch.as_tensor(sim.freqs, dtype=torch.float32, device=dev)
    w_dev = mueller_unpol_weights(dirs, f32)
    w_cpu = mueller_unpol_weights(dirs.cpu(), f32.cpu())
    errs = {pq: float((w_dev[pq].cpu() - w_cpu[pq]).abs().max())
            / float(w_cpu[pq].abs().max()) for pq in ("XX", "YY", "XY")}
    cs = bool((w_dev["XY"].abs() <= torch.sqrt(w_dev["XX"] * w_dev["YY"])
               * (1 + 1e-6) + 1e-7).all())
    print("Mueller weights at snapshot 0 (%d directions x %d channels) on "
          "the card vs the CPU, max|dB|/max|B|: %s (bar %.0e); "
          "|B_XY| <= sqrt(B_XX B_YY): %s; B_XY in [%.4e, %.4e]"
          % (dirs.shape[0], f32.shape[0],
             ", ".join("%s %.4e" % kv for kv in errs.items()),
             MUELLER_CPU_BAR, cs, float(w_dev["XY"].min()),
             float(w_dev["XY"].max())))
    if not (max(errs.values()) <= MUELLER_CPU_BAR and cs
            and all(w_dev[pq].device.type == "cuda" for pq in w_dev)):
        raise SystemExit("Mueller weights on the card disagree")
    return dict(wall_s=wall, direct_xy_s=wall_d, export_s=export_s,
                launches=got, components=comps)


def dualpol_phase(parms, dev):
    """Phase g: beam.pol XY on the HERA-37 slice with array.redundant,
    engine auto, save_formats fmt fits + uvfits, save_redundant: each feed
    (engine, gate, launches), X against Y, each simvis.fits read back with
    load_fits, each simvis.uvfits on the full redundant set, the combined
    2-pol and 4-pol UVFITS; then each product's writer timed alone."""
    from prisim_tpu_torch import driver as drv
    from prisim_tpu_torch.io import load_fits, save_fits
    from prisim_tpu_torch.io.uvfits import load_uvfits, save_uvfits
    with component_counts() as records:
        (outs, dir_x), log, got, wall = drive("dual polarization, HERA-37 "
                                              "redundant", parms, dev,
                                              save=True)
    comps = report_components("dual polarization", log, records)
    vs_x, vs_y = outs
    scale = float(np.abs(vs_x.skyvis).max())
    dxy = float(np.abs(vs_x.skyvis - vs_y.skyvis).max()) / scale
    print("dual polarization: %d unique baselines x %d ch x %d acc; X vs Y "
          "(a circular dish) max|dV|/max|V| = %.4e (bar %.0e)"
          % (vs_x.nbl, vs_x.nchan, vs_x.n_acc, dxy, DISH_XY_BAR))
    if not dxy <= DISH_XY_BAR:
        raise SystemExit("dual polarization: X and Y of a dish differ")
    n_all = len(vs_x.layout["labels"]) * (len(vs_x.layout["labels"]) - 1) // 2
    for vs, d in ((vs_x, dir_x), (vs_y, dir_x[:-len("_polX")] + "_polY")):
        sd = os.path.join(d, "simdata")
        back = load_fits(os.path.join(sd, "simvis.fits"))
        exact = all(np.array_equal(getattr(back, n), getattr(vs, n))
                    for n in ("skyvis", "vis", "vis_noise", "baselines",
                              "projected_baselines", "freqs", "lst",
                              "timestamps", "t_acc", "labels"))
        exact &= all(np.array_equal(getattr(back, n), np.asarray(
            getattr(vs, n), np.float32)) for n in ("bp", "bp_wts", "Tsys",
                                                   "vis_rms"))
        uv = load_uvfits(os.path.join(sd, "simvis.uvfits"))
        rows = np.all(uv.skyvis[:, None] == vs.skyvis[None], axis=(2, 3))
        expanded = bool((rows.sum(axis=1) >= 1).all()
                        and np.unique(rows.argmax(axis=1)).size == vs.nbl)
        print("dual polarization %s: simvis.fits equals the run %s; "
              "simvis.uvfits %d baselines (all pairs %d), each a unique "
              "baseline's rows: %s" % (os.path.basename(d), exact, uv.nbl,
                                       n_all, expanded))
        if not (exact and uv.nbl == n_all and expanded):
            raise SystemExit("dual polarization: products disagree")
    sd = os.path.join(dir_x, "simdata")
    c2, w2 = stokes_cube(os.path.join(sd, "simvis_dualpol.uvfits"), 2)
    c4, w4 = stokes_cube(os.path.join(sd, "simvis_4pol.uvfits"), 4)
    ok = (all(np.array_equal(to_cube(c[..., p], vs_x), vs.skyvis)
              for c in (c2, c4) for p, vs in enumerate((vs_x, vs_y)))
          and (c4[..., 2:] == 0).all() and (w4[..., 2:] < 0).all()
          and (w2 > 0).all())
    print("dual polarization: combined 2-pol and 4-pol UVFITS read back, "
          "XX/YY equal the runs and the cross-pols flagged zeros: %s" % ok)
    if not ok:
        raise SystemExit("dual polarization: combined exports disagree")
    tmp = os.path.join(os.path.dirname(dir_x), "dualpol_writer_times")
    os.makedirs(tmp, exist_ok=True)
    times = {}
    t0 = time.time()
    save_fits(vs_x, os.path.join(tmp, "simvis.fits"))
    times["simvis.fits (save_fits)"] = time.time() - t0
    t0 = time.time()
    vs_uv = drv._expand_redundant(vs_x)
    times["expansion onto the redundant set"] = time.time() - t0
    t0 = time.time()
    save_uvfits(vs_uv, os.path.join(tmp, "simvis.uvfits"), pols=(-5,))
    times["simvis.uvfits, %d baselines (save_uvfits)" % n_all] = \
        time.time() - t0
    for name, kw in (("simvis_dualpol.uvfits", {}),
                     ("simvis_4pol.uvfits", {"four_pol": True})):
        t0 = time.time()
        save_uvfits(vs_x, os.path.join(tmp, name), vs_second=vs_y, **kw)
        times[name] = time.time() - t0
    print("dual polarization product writers (host): %s"
          % "; ".join("%s %.3f s" % kv for kv in times.items()))
    return dict(wall_s=wall, launches=got, components=comps, writers=times)


# --------------------------------------------------------------------------
# Phases h-j: BASELINE configs #3 and #5 at full size through the analysis
# stack, chunked runs with resume, and the diagnosis section
# --------------------------------------------------------------------------

# CLEAN's identity res + cc * kernel = inp, of max|inp| per spectrum: a
# float32 residual updated up to 200 times
CLEAN_ID_BAR = 1e-5
# CLEAN on the card vs on the CPU, of max|inp|, over the spectra whose
# iteration count and stop rule agree; and the least share that agrees
CLEAN_CPU_BAR = 1e-5
CLEAN_SAME_SHARE = 0.95
# delay_ps on the card vs on the CPU, P(k) of max P(k): complex64 delay
# transforms (~1e-7), squared
DPS_CPU_BAR = 1e-6
# each chunk's noise rms against the radiometer rms: > 1e5 complex samples
NOISE_RMS_BAR = 0.01


def config3_parms(root, nchan=256, nside=128, n_acc=10):
    """BASELINE config #3 as benchmarks/bench_configs.config3 builds it:
    HERA-37 redundant, 14 m dish, nchan x 390.625 kHz around 150 MHz, an
    nside-`nside` USM sky, n_acc x 60 s drift from LST 0, Trx 100 K, eff_Q
    0.96, A_eff 154, engine as config3 leaves it (auto); the simulation is
    saved as the native FITS product in place of HDF5 (no h5py on the card
    machine)."""
    from prisim_tpu_torch.config import load_parms
    return load_parms({
        "dirstruct": {"rootdir": root, "project": "hera37_dps",
                      "simid": "cfg3"},
        "telescope": {"id": "hera", "latitude": -30.7224,
                      "A_eff": 154.0, "eff_Q": 0.96, "Trx": 100.0},
        "array": {"layout": "HERA-37", "redundant": True},
        "antenna": {"shape": "dish", "size": 14.0},
        "bandpass": {"freq": 150e6, "freq_resolution": 390625.0,
                     "nchan": nchan},
        "obsparm": {"obs_mode": "drift", "n_acc": n_acc, "t_acc": 60.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "usm", "nside": nside},
        "save_formats": {"fmt": "fits", "npz": False},
    })


def clean_cubes(vst):
    """The (spectrum, lag) rows delay_clean_vs cleans, per cube present:
    {name: (inp, kernel, horizon box)}, each (nbl * n_acc, nlag)."""
    nlag = vst.lags.size
    blc = vst.baseline_lengths / 299792458.0
    box = np.abs(vst.lags)[None, None, :] <= blc[:, None, None]
    out = {}
    for name in ("skyvis_lag", "vis_lag", "vis_noise_lag"):
        cube = getattr(vst, name)
        if cube is None:
            continue
        x = np.transpose(cube, (0, 2, 1))
        out[name] = (x.reshape(-1, nlag),
                     np.transpose(vst.lag_kernel, (0, 2, 1)).reshape(-1,
                                                                     nlag),
                     np.broadcast_to(box, x.shape).reshape(-1, nlag))
    return out


def clean_identity(inp, kernel, cc, res):
    """max over spectra of max|res + cc * kernel - inp| / max|inp|, the
    convolution circular with the kernel normalized and rolled to its
    peak as CLEAN rolls it (complex128 FFTs on the tensors' device)."""
    k = kernel.to(torch.complex128)
    k = k / k.abs().max(dim=1, keepdim=True).values
    n = k.shape[1]
    idx = torch.remainder(torch.arange(n, device=k.device)[None, :]
                          + k.abs().argmax(dim=1)[:, None], n)
    conv = torch.fft.ifft(torch.fft.fft(cc.to(torch.complex128), dim=1)
                          * torch.fft.fft(k.gather(1, idx), dim=1), dim=1)
    d = res.to(torch.complex128) + conv - inp.to(torch.complex128)
    return float((d.abs().max(dim=1).values
                  / inp.abs().max(dim=1).values.to(torch.float64)).max())


def config3_phase(root, dev, **sizes):
    """Phase h: config #3 at full size: the simulation (engine, gate
    readings, K1a/K2 launches, wall-clock) saved as FITS, then the port's
    tools.delay_ps on that file with CLEAN on the card (each step's time);
    CLEAN's iteration counts and stop rules, its identity on the card, CLEAN
    on the CPU on the same lag cubes, and delay_ps on the CPU on the same
    file. Returns the numbers."""
    from prisim_tpu_torch.analysis.clean import clean_rows
    from prisim_tpu_torch.io import load_fits
    from prisim_tpu_torch.tools import delay_ps
    from prisim_tpu_torch.vis import delay_transform
    parms = config3_parms(root, **sizes)
    dump = os.path.join(root, "cfg3_gate.npz")
    os.makedirs(root, exist_ok=True)
    if os.path.exists(dump):
        os.remove(dump)
    os.environ["PRISIM_DEBUG_XCHECK_DUMP"] = dump
    try:
        (vs, outdir), log, got, wall = drive(
            "config #3 simulation (products: native FITS in place of HDF5)",
            parms, dev, save=True)
    finally:
        os.environ.pop("PRISIM_DEBUG_XCHECK_DUMP", None)
    if os.path.exists(dump):
        print("config #3 gate: %s; %s" % (
            gate_readings(dump), "passed" if engine_ran(log) == "banded"
            else "the run was demoted to the direct engine"))
    assert np.isfinite(vs.skyvis).all() and np.isfinite(vs.vis).all()
    fits = os.path.join(outdir, "simdata", "simvis.fits")
    kw = dict(pad=1.0, nside_beam=32, clean=True, gain=0.1, maxiter=200,
              threshold=5e-3)
    times = {}
    zero_counts()
    t0 = time.time()
    dps = delay_ps(fits, None, device=dev, timings=times, **kw)
    dps_s = time.time() - t0
    print("config #3 delay_ps on the card (%d bl x %d ch x %d acc, CLEAN on "
          "skyvis, vis and noise): %.3f s; %s; kernel launches %s"
          % (vs.nbl, vs.nchan, vs.n_acc, dps_s,
             ", ".join("%s %.3f s" % kv for kv in times.items()), counts()))
    for key in ("skyvis", "vis", "noise", "cc_skyvis_ps", "res_skyvis_ps"):
        assert np.isfinite(dps[key]).all() and dps[key].shape == \
            vs.skyvis.shape, key

    vst = delay_transform(load_fits(fits), pad=1.0, device=dev)
    cubes = clean_cubes(vst)
    worst_id, same_all, d_cc, d_res, clean_ms = 0.0, [], 0.0, 0.0, {}
    for name, (x, k, b) in cubes.items():
        args = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
                for a in (x, k, b)]
        ckw = dict(gain=0.1, maxiter=200, threshold=5e-3)
        clean_rows(*args, **ckw)
        torch.cuda.synchronize()
        t0 = time.time()
        out = clean_rows(*args, **ckw)
        torch.cuda.synchronize()
        clean_ms[name] = (time.time() - t0) * 1e3
        ident = clean_identity(args[0], args[1], out["cc"], out["res"])
        worst_id = max(worst_id, ident)
        t0 = time.time()
        cpu = clean_rows(*[a.cpu() for a in args], **ckw)
        cpu_s = time.time() - t0
        niter, code = out["niter"].cpu(), out["terminated_by"].cpu()
        same = (niter == cpu["niter"]) & (code == cpu["terminated_by"])
        same_all.append(same)
        scale = args[0].abs().max(dim=1).values.cpu()[:, None]
        dcc = ((out["cc"].cpu() - cpu["cc"]).abs() / scale)[same].max()
        dres = ((out["res"].cpu() - cpu["res"]).abs() / scale)[same].max()
        d_cc, d_res = max(d_cc, float(dcc)), max(d_res, float(dres))
        counts_ = {int(c): int((code == c).sum()) for c in (0, 1, 2)}
        print("config #3 CLEAN %s: %d spectra x %d lags, %.3f ms on the card "
              "(%.3f s on the CPU); niter min %d, median %d, max %d; stopped "
              "by threshold %d, maxiter %d, box rule %d; identity res + cc * "
              "kernel = inp: %.4e of max|inp| (bar %.0e); card vs CPU: same "
              "niter and stop rule %.4f, max|dcc| %.4e, max|dres| %.4e of "
              "max|inp|" % (name, x.shape[0], x.shape[1], clean_ms[name],
                            cpu_s, int(niter.min()), int(niter.median()),
                            int(niter.max()), counts_[0], counts_[1],
                            counts_[2], ident, CLEAN_ID_BAR,
                            float(same.double().mean()), float(dcc),
                            float(dres)))
    share = float(torch.cat(same_all).double().mean())
    if not (worst_id <= CLEAN_ID_BAR and share >= CLEAN_SAME_SHARE
            and d_cc <= CLEAN_CPU_BAR and d_res <= CLEAN_CPU_BAR):
        raise SystemExit("config #3 CLEAN: identity %.3e, card vs CPU share "
                         "%.4f, dcc %.3e, dres %.3e" % (worst_id, share, d_cc,
                                                         d_res))

    t0 = time.time()
    ref = delay_ps(fits, None, device="cpu", **kw)
    cpu_s = time.time() - t0
    rel = {k: float(np.abs(dps[k] - ref[k]).max() / np.abs(ref[k]).max())
           for k in ("skyvis", "vis", "noise", "cc_skyvis_ps",
                     "res_skyvis_ps")}
    same = {k: bool(np.array_equal(dps[k], ref[k]))
            for k in ("z", "kprll", "kperp", "factor", "omega_bw")}
    f_rel = abs(dps["factor"] / ref["factor"] - 1.0)
    print("config #3 delay_ps card vs CPU (CPU run %.3f s): P(k) max|dP| / "
          "max P %s (bar %.0e on skyvis, vis, noise); equal: %s; factor "
          "relative difference %.4e" % (
              cpu_s, ", ".join("%s %.4e" % kv for kv in rel.items()),
              DPS_CPU_BAR, same, f_rel))
    if not (max(rel[k] for k in ("skyvis", "vis", "noise")) <= DPS_CPU_BAR
            and same["z"] and same["kprll"] and f_rel <= DPS_CPU_BAR):
        raise SystemExit("config #3: delay_ps on the card disagrees with the "
                         "CPU")
    return dict(sim_s=wall, launches=got, delay_ps_s=dps_s, times=times,
                clean_ms=clean_ms, engine=engine_ran(log))


def grid_positions(shape, spacing=7.0):
    """An ny x nx grid at `spacing` m and its labels (a copy of
    benchmarks/bench_configs._grid_positions)."""
    ny, nx = shape
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny))
    pos = np.zeros((nx * ny, 3))
    pos[:, 0] = xs.ravel() * spacing
    pos[:, 1] = ys.ravel() * spacing
    labels = np.asarray([str(i) for i in range(nx * ny)])
    return pos, labels


def config5_phase(dev, grid=(16, 32), nchan=128, n_acc=8, nsrc=1024,
                  max_classes=512):
    """Phase i: config #5 at full size, as bench_configs.config5 builds it:
    the 16 x 32 grid at 7 m (512 antennas), redundant baselines, 128 ch x
    100 kHz from 150 MHz, 1,024 power-law sources from default_rng(1),
    8 x 60 s, unit beam: engine.observe.simulate_drift on the card (K1a, one
    launch an accumulation), unique_triads_fast(max_classes=512),
    triad_baseline_indices, closure_phases; ClosurePhaseData over 4 days
    with the 0.01 jitter of default_rng(2), smooth_in_tbins(daybinsize=2,
    median), cpds_ft(152 MHz, 2 MHz, pad 1), xcpdps_full(cohax (2,), incohax
    (1, 3), collapse (3,), lst shifts 0-1). Then K1a against its plain
    version on accumulation 0. Returns the numbers."""
    from prisim_tpu_torch.analysis.bispectrum import (ClosurePhaseData,
                                                      cpds_ft, xcpdps_full)
    from prisim_tpu_torch.analysis.closure import (closure_phases,
                                                   triad_baseline_indices,
                                                   unique_triads_fast)
    from prisim_tpu_torch.baselines import build_baselines
    from prisim_tpu_torch.engine import cuda_nudft, observe
    from prisim_tpu_torch.engine.nudft import nudft_visibilities
    from prisim_tpu_torch.layouts import ArrayLayout
    from prisim_tpu_torch.skymodel import SkyModel
    layout = ArrayLayout(*grid_positions(grid, spacing=7.0))
    bset = build_baselines(layout, redundant=True)
    freqs = 150e6 + 100e3 * np.arange(nchan)
    inst = observe.Instrument.build(bset.vectors, freqs, dev, latitude=-30.72)
    rng = np.random.default_rng(1)
    loc = np.stack([rng.uniform(0, 360, nsrc),
                    rng.uniform(-75, 15, nsrc)], axis=-1)
    model = SkyModel(location=loc, spec_kind="power-law", spec_parms={
        "flux-scale": rng.uniform(0.5, 3.0, nsrc),
        "freq-ref": np.full(nsrc, 150e6),
        "power-law-index": np.full(nsrc, -0.8)})
    sky = observe.SkySources.from_skymodel(model, freqs, dev)
    lsts = (np.arange(n_acc) * 60.0 / 240.0) % 360.0
    obs = observe.Observation(
        lst_deg=lsts, jd=np.full(n_acc, 2458000.0),
        t_acc=np.full(n_acc, 60.0),
        pointing_altaz=np.stack([np.full(n_acc, 90.0), np.zeros(n_acc)], -1),
        mode="drift")

    def beam_fn(s, f):
        return torch.ones((s.shape[0], f.shape[0]), dtype=torch.float32,
                          device=s.device)

    zero_counts()
    t0 = time.time()
    vis = observe.simulate_drift(inst, sky, obs, beam_fn, src_block=1024)
    vis = vis.cpu().numpy()
    t_sim = time.time() - t0
    got = counts()
    if got["k1a"] != n_acc:
        raise SystemExit("config #5: K1a launched %d times for %d "
                         "accumulations" % (got["k1a"], n_acc))

    t0 = time.time()
    triads = unique_triads_fast(layout.labels, layout.positions,
                                max_classes=max_classes)
    idx, conj = triad_baseline_indices(
        bset.labels, triads, baselines=bset.vectors,
        ant_positions=layout.positions, ant_labels=layout.labels)
    vis_bct = np.ascontiguousarray(np.transpose(vis, (1, 2, 0)))
    cp, _ = closure_phases(vis_bct, idx, conj)   # (ntri, nchan, nacc)
    t_cp = time.time() - t0

    t0 = time.time()
    ntri = cp.shape[0]
    cp4 = np.transpose(cp, (2, 0, 1))[:, None, :, :]     # (nlst, 1, t, c)
    ndays = 4
    cp4 = np.repeat(cp4, ndays, axis=1)
    cp4 = cp4 + 0.01 * np.random.default_rng(2).normal(size=cp4.shape)
    cpd = ClosurePhaseData(cp=cp4, wts=np.ones(cp4.shape), freqs=freqs,
                           lst=lsts / 15.0,
                           days=2458000.0 + np.arange(ndays, dtype=float),
                           triads=np.asarray(triads))
    sm_cpd = cpd.smooth_in_tbins(daybinsize=2.0, stat="median")
    ft = cpds_ft(sm_cpd.eicp * sm_cpd.wts, sm_cpd.wts, freqs,
                 freq_center=[152e6], bw_eff=2e6, pad=1.0)
    ps = xcpdps_full(ft, cohax=(2,), incohax=(1, 3), collapse_axes=(3,),
                     lst_shifts=np.arange(2))
    t_ps = time.time() - t0
    P = np.asarray(ps["P"])
    print("config #5: %d antennas, %d unique baselines x %d ch x %d acc, %d "
          "sources; simulate_drift on the card %.3f s (K1a %d launches, "
          "%s); %d triads: triads + indices + closure phases %.3f s (host); "
          "day binning + cpds_ft + xcpdps_full %.3f s (host); P %s, finite "
          "%s" % (layout.positions.shape[0], bset.nbl, nchan, n_acc, nsrc,
                  t_sim, got["k1a"], got, ntri, t_cp, t_ps, P.shape,
                  bool(np.isfinite(P[~np.isnan(P)]).all())))
    if not (ntri == max_classes and np.isfinite(cp).all()
            and not np.isnan(P).all()):
        raise SystemExit("config #5: bad closure products")

    Mh, Ml, pch, pcl = observe.schedule_tensors(obs, inst.latitude, dev)
    seh, sel, amps, _ = observe.snapshot_nudft_inputs(
        inst, sky, Mh[0], Ml[0], pch[0], pcl[0], beam_fn)
    args = (seh, sel, inst.bl_hi, inst.bl_lo, amps, inst.grid_scalars(),
            inst.nchan)
    v_k = cuda_nudft.nudft_cuda(*args)
    v_p = nudft_visibilities(*args)
    rel, d = rel_err(v_k, v_p, float(v_p.abs().max()))
    coherent = float(amps.abs().sum(dim=0).max())
    same0 = bool(np.array_equal(v_k.cpu().numpy(), vis[0]))
    print("config #5 K1a vs plain, accumulation 0 (%d sources x %d bl x %d "
          "ch): max|dV|=%.4e  /max|V|=%.4e  /max_c sum_s|A|=%.4e (bar %.0e); "
          "the run's accumulation 0 equals this launch: %s"
          % (seh.shape[0], inst.nbl, inst.nchan, d, rel, d / coherent, BAR,
             same0))
    if not (rel < BAR and same0):
        raise SystemExit("config #5: K1a disagrees with its plain version")
    return dict(sim_s=t_sim, closure_s=t_cp, xcpdps_s=t_ps, launches=got,
                nbl=bset.nbl, ntri=ntri, P_shape=P.shape)


def drive_chunked(label, parms, dev, **kw):
    """run_simulation_chunked with the kernel counts set to 0 just before
    and read just after; prints its log, wall-clock and launches. Returns
    (result, log, counts, seconds)."""
    from prisim_tpu_torch.driver import run_simulation_chunked
    log = io.StringIO()
    zero_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(log):
        out = run_simulation_chunked(parms, verbose=True, device=dev, **kw)
    wall = time.time() - t0
    got = counts()
    print(log.getvalue().rstrip())
    print("%s: wall-clock %.3f s, launches K1a %d, K2 %d (%s)"
          % (label, wall, got["k1a"], got["k2"], got))
    if got["k1a"] == 0:
        raise SystemExit("%s: K1a never launched" % label)
    return out, log.getvalue(), got, wall


def chunk_noise(vs, axis, n_chunks=2):
    """Each chunk's noise block along `axis`, and its rms against the
    radiometer rms of its samples."""
    edges = np.linspace(0, vs.vis_noise.shape[axis], n_chunks + 1).astype(int)
    out = []
    for i in range(n_chunks):
        sl = [slice(None)] * 3
        sl[axis] = slice(edges[i], edges[i + 1])
        n = vs.vis_noise[tuple(sl)]
        r = np.asarray(vs.vis_rms)[tuple(sl)]
        out.append((n, float(np.sqrt(np.mean(np.abs(n) ** 2))
                             / np.sqrt(np.mean(r ** 2)))))
    return out


def chunked_phase(root, dev, have_h5py, nchan=256, n_acc=2, **sections):
    """Phase j: the slice's HERA-37 config cut to 2 accumulations and 256
    channels, engine auto: the run unchunked, then pp.n_chunks: 2 with key
    freq and with key time (skyvis against the unchunked run in both
    normalizations, each chunk's noise rms against the radiometer rms, the
    chunks' draws differ); resume (part 1 deleted, part 0 kept untouched,
    the merge equal to the first); diagnosis.jax_profile (a torch.profiler
    trace) and diagnosis.resource_monitor (JSONL rows with device bytes
    where psutil imports; without it, ImportError before any compute).
    `sections` update the parameter sections. Returns the numbers."""
    import copy
    base = slice_parms(root, have_h5py, "auto", "chunks_single",
                       bandpass={"nchan": nchan}, obsparm={"n_acc": n_acc},
                       save_formats={"fmt": "none", "npz": False},
                       processing={"engine": "auto", "cleanup": 0},
                       **sections)
    (single, _), _, got_u, wall_u = drive("chunked phase, unchunked run",
                                          base, dev)
    coh, _ = coherent_scale(base, dev)
    vmax = float(np.abs(single.skyvis).max())
    res = {}
    for key, axis in (("freq", 1), ("time", 2)):
        parms = copy.deepcopy(base)
        parms["dirstruct"]["simid"] = "chunks_" + key
        parms["pp"].update(n_chunks=2, key=key)
        outdir = os.path.join(root, "chip_smoke", "chunks_" + key)
        for i in range(2):
            part = os.path.join(outdir, "simdata", "_part_%d.npz" % i)
            if os.path.exists(part):
                os.remove(part)
        (vs, outdir), log, got, wall = drive_chunked(
            "chunked phase, pp.key %s, 2 chunks" % key, parms, dev)
        d = float(np.abs(vs.skyvis - single.skyvis).max())
        noise = chunk_noise(vs, axis)
        differ = not np.array_equal(noise[0][0], noise[1][0])
        print("chunked (%s) vs unchunked: max|dV|=%.4e  /max|V|=%.4e  "
              "/max_c sum_s|A|=%.4e (bar %.0e); noise rms / radiometer rms "
              "per chunk %s (bar %.0e); the chunks' draws differ: %s"
              % (key, d, d / vmax, d / coh, BAR,
                 ", ".join("%.5f" % r for _, r in noise), NOISE_RMS_BAR,
                 differ))
        if not (d / coh <= BAR and differ and all(
                abs(r - 1.0) <= NOISE_RMS_BAR for _, r in noise)):
            raise SystemExit("chunked (%s) run disagrees" % key)
        res[key] = dict(wall=wall, launches=got, rel_coherent=d / coh)
        if key == "freq":
            first, parms_f = vs, parms
            p0 = os.path.join(outdir, "simdata", "_part_0.npz")
            p1 = os.path.join(outdir, "simdata", "_part_1.npz")

    mtime = os.stat(p0).st_mtime_ns
    os.remove(p1)
    (again, _), log, got, wall = drive_chunked(
        "chunked phase, resume with _part_1.npz deleted", parms_f, dev)
    kept = os.stat(p0).st_mtime_ns == mtime and "resume: part 0" in log
    same = {n: bool(np.array_equal(getattr(again, n), getattr(first, n)))
            for n in ("skyvis", "vis", "vis_noise")}
    d = float(np.abs(again.skyvis - first.skyvis).max())
    print("resume: part 0 skipped and untouched %s; merge equal to the first "
          "run %s (skyvis max|dV|/max_c sum_s|A| = %.4e)" % (kept, same,
                                                             d / coh))
    if not (kept and same["vis_noise"] and d / coh <= 1e-7):
        raise SystemExit("chunked phase: resume changed the product")

    prof_dir = os.path.join(root, "torch_profile")
    if os.path.isdir(prof_dir):
        for f in os.listdir(prof_dir):
            os.remove(os.path.join(prof_dir, f))
    prof = copy.deepcopy(base)
    prof["diagnosis"]["jax_profile"] = prof_dir
    _, _, got_p, wall_p = drive("chunked phase, diagnosis.jax_profile",
                                prof, dev)
    files = os.listdir(prof_dir)
    size = sum(os.path.getsize(os.path.join(prof_dir, f)) for f in files)
    print("diagnosis.jax_profile: %d trace file(s), %.1f MB, run %.3f s "
          "(unprofiled %.3f s)" % (len(files), size / 1e6, wall_p, wall_u))
    if not (files and size > 0):
        raise SystemExit("diagnosis.jax_profile wrote no trace")

    mon = copy.deepcopy(base)
    mon["diagnosis"].update(resource_monitor=True, refresh_interval=0.1)
    path = os.path.join(root, "resource_monitor.jsonl")
    if os.path.exists(path):
        os.remove(path)
    if importable("psutil"):
        drive("chunked phase, diagnosis.resource_monitor", mon, dev)
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        peak = max(r.get("device_bytes_in_use", -1) for r in rows)
        print("diagnosis.resource_monitor: %d rows, device bytes in use up "
              "to %d" % (len(rows), peak))
        if not (rows and all("device_bytes_in_use" in r for r in rows)):
            raise SystemExit("resource monitor rows lack device bytes")
    else:
        from prisim_tpu_torch.driver import run_simulation
        zero_counts()
        try:
            run_simulation(mon, verbose=False, save=False, device=dev)
        except ImportError as exc:
            print("diagnosis.resource_monitor without psutil: ImportError "
                  "(%s) before any compute, launches %s" % (exc, counts()))
        else:
            raise SystemExit("resource_monitor ran without psutil")
        if any(counts().values()):
            raise SystemExit("resource_monitor: compute ran before the "
                             "ImportError")
    return dict(single_s=wall_u, launches=got_u, runs=res,
                resume_s=wall, profile_s=wall_p)


# --------------------------------------------------------------------------
# Phases k-m: the device mesh on the card, the tools with BASELINE config #4
# through feko2hpx, and the example
# --------------------------------------------------------------------------

MESH_SHARDS = 4
# a bl or chan mesh run against the single-device run, max|dV| / max|V|:
# the same float64 sums per (baseline, channel), split across the grid in
# other source splits, each rounded once to complex64
MESH_BAR = 1e-6
# a src mesh run: the sum of the shards' complex64 partial visibilities,
# each up to the coherent scale, max|dV| / max_c sum_s |A|: the f32 engines'
# bar
MESH_SRC_BAR = 2e-6
# config #4's product converted to UVFITS and read back, max|dV| / max|V|:
# both hold float32 cubes
CONVERT_BAR = 1e-7


def sync_warnings(fn):
    """The host synchronizations of a second call of fn() on the card (the
    first uploads what its wrapper caches), as torch.cuda's sync debug
    mode reports them (one message line each; its note that the mode is a
    prototype is not one)."""
    import warnings
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    msgs = [str(w.message).strip().splitlines()[0] for w in caught]
    return [m for m in msgs if "prototype feature" not in m]


def mesh_phase(root, dev, have_h5py, n_acc=2):
    """Phase k: the slice cut to n_acc accumulations on a mesh of
    MESH_SHARDS shards that all sit on `dev` (devices=[dev] * 4): the
    direct engine with pp.key freq (1, 4), bl (4, 1), src (1, 1, 4) and
    pp.mesh_axes [2, 2], each against the single-device direct run in both
    normalizations, K1a launching once per shard and accumulation; engine
    auto on the banded 'bl' mesh (the mesh gate's readings, K2 launches
    per shard) against the single-device banded run; the host
    synchronizations of one K1a and one K2 launch; tools.mesh_check on the
    same entries. Shards on one card run one after another, so the times
    say nothing about scaling. Returns the numbers and the launches."""
    from prisim_tpu_torch import tools
    from prisim_tpu_torch.driver import banded_engine, prepare_simulation
    from prisim_tpu_torch.engine import cuda_banded, cuda_nudft
    from prisim_tpu_torch.engine.observe import (schedule_tensors,
                                                 snapshot_nudft_inputs)
    devs = [dev] * MESH_SHARDS
    print("mesh phase: torch.cuda.device_count() = %d; %d shards on %s; "
          "shards on one card run one after another, so these times show "
          "no scaling" % (torch.cuda.device_count(), MESH_SHARDS, dev))

    def parms(engine, simid, **pp):
        return slice_parms(root, have_h5py, engine, simid,
                           obsparm={"n_acc": n_acc},
                           save_formats={"fmt": "none", "npz": False}, pp=pp)

    base = parms("direct", "mesh_single_direct", key="none")
    (one, _), _, got, wall1 = drive("mesh phase, one device, engine direct",
                                    base, dev)
    assert got == dict(dict.fromkeys(got, 0), k1a=n_acc), got
    coh, _ = coherent_scale(base, dev)
    vmax = float(np.abs(one.skyvis).max())
    out = dict(single_direct_s=wall1, runs={}, k1a=0, k2=0)
    for label, pp, src in (
            ("freq (1, 4)", {"key": "freq"}, False),
            ("bl (4, 1)", {"key": "bl"}, False),
            ("src (1, 1, 4)", {"key": "src"}, True),
            ("freq, mesh_axes [2, 2]", {"key": "freq", "mesh_axes": [2, 2]},
             False)):
        simid = "mesh_" + label.split()[0].strip(",") + (
            "_axes" if "mesh_axes" in pp else "")
        (vs, _), log, got, wall = drive(
            "mesh phase, pp.key %s, engine direct" % label,
            parms("direct", simid, **pp), dev, devices=devs)
        d = float(np.abs(vs.skyvis - one.skyvis).max())
        rel, bar = (d / coh, MESH_SRC_BAR) if src else (d / vmax, MESH_BAR)
        want = MESH_SHARDS * n_acc
        print("mesh %s vs one device: max|dV|=%.4e  /max|V|=%.4e  "
              "/max_c sum_s|A|=%.4e (bar %.0e of %s); K1a launches %d "
              "(shards x accumulations: %d); %.3f s against %.3f s on one "
              "device" % (label, d, d / vmax, d / coh, bar,
                          "max_c sum_s|A|" if src else "max|V|", got["k1a"],
                          want, wall, wall1))
        if not (rel <= bar and got == dict(dict.fromkeys(got, 0),
                                           k1a=want)
                and "direct engine on a" in log):
            raise SystemExit("mesh %s disagrees with one device" % label)
        out["runs"][label] = dict(wall_s=wall, rel_v=d / vmax, rel_c=d / coh)
        out["k1a"] += got["k1a"]

    bone = parms("auto", "mesh_single_banded", key="none")
    (b1, _), _, got1, wall_b1 = drive("mesh phase, one device, engine auto",
                                      bone, dev)
    dump = os.path.join(root, "mesh_gate.npz")
    os.makedirs(root, exist_ok=True)
    if os.path.exists(dump):
        os.remove(dump)
    os.environ["PRISIM_DEBUG_XCHECK_DUMP"] = dump
    try:
        (bm, _), log, got, wall_bm = drive(
            "mesh phase, engine auto on the 'bl' mesh",
            parms("auto", "mesh_banded", key="freq"), dev, devices=devs)
    finally:
        os.environ.pop("PRISIM_DEBUG_XCHECK_DUMP", None)
    d = float(np.abs(bm.skyvis - b1.skyvis).max())
    dd = float(np.abs(bm.skyvis - one.skyvis).max())
    gate_ok = "mesh shared-amps cross-check ok" in log
    print("mesh gate: %s; %s" % (gate_readings(dump), "passed" if gate_ok
                                 else "FAILED"))
    print("banded mesh: K2 launches %d (the gate 1 + %d shards x %d "
          "accumulations), K1a %d (the gate); vs the one-device banded run "
          "max|dV|/max|V|=%.4e  /max_c sum_s|A|=%.4e (bar %.0e of "
          "max_c sum_s|A|), vs the one-device direct run %.4e of "
          "max_c sum_s|A|; %.3f s against %.3f s on one device (K2 %d)"
          % (got["k2"], MESH_SHARDS, n_acc, got["k1a"], d / vmax, d / coh,
             GATE_TOL, dd / coh, wall_bm, wall_b1, got1["k2"]))
    if not (gate_ok and engine_ran(log) == "banded" and d / coh <= GATE_TOL
            and got["k2"] == 1 + MESH_SHARDS * n_acc):
        raise SystemExit("banded mesh run disagrees")
    out.update(banded_s=wall_bm, single_banded_s=wall_b1,
               banded_rel_c=d / coh, k2=got["k2"], k1a=out["k1a"] + got["k1a"])

    sim = prepare_simulation(base, dev)
    Mh, Ml, pch, pcl = schedule_tensors(sim.obs, sim.inst.latitude, dev)
    seh, sel, amps, _ = snapshot_nudft_inputs(sim.inst, sim.sky, Mh[0],
                                              Ml[0], pch[0], pcl[0],
                                              sim.beam_fn)
    nb = -(-sim.inst.nbl // MESH_SHARDS)
    k1a_syncs = sync_warnings(lambda: cuda_nudft.nudft_cuda(
        seh, sel, sim.inst.bl_hi[:nb].contiguous(),
        sim.inst.bl_lo[:nb].contiguous(), amps, sim.inst.grid_scalars(),
        sim.inst.nchan))
    del seh, sel, amps
    bsim = prepare_simulation(bone, dev)
    plan, snap = banded_engine(bone, bsim)
    prep = snap.prep_chunk(0, Mh[0], Ml[0], pch[0], pcl[0])
    k2_syncs = sync_warnings(lambda: cuda_banded.banded_spread_cuda(
        plan, *prep[:3]))
    for name, msgs in (("K1a (one bl shard's launch)", k1a_syncs),
                       ("K2 (one launch)", k2_syncs)):
        print("host synchronizations inside the %s wrapper, warmed up: %d%s"
              % (name, len(msgs), "".join("\n  " + m for m in msgs[:4])))
    del sim, bsim, plan, snap, prep
    t0 = time.time()
    ok = tools.mesh_check(MESH_SHARDS, device=str(dev))
    print("tools.mesh_check on [%s] * %d: %s (%.3f s)"
          % (dev, MESH_SHARDS, ok, time.time() - t0))
    if not ok:
        raise SystemExit("mesh_check failed")
    out.update(k1a_syncs=len(k1a_syncs), k2_syncs=len(k2_syncs))
    return out


def write_synthetic_feko(path, freqs_hz, ntheta=91, nphi=73, d_eff=14.0):
    """A FEKO far-field text export: benchmarks/bench_configs.
    _write_synthetic_feko's pattern (per-frequency '#Frequency' blocks over
    a (theta, phi) grid, gain dB in the last column: an elliptical
    gaussian-in-sin(theta) beam of width ~ lambda/D with a first-sidelobe
    ripple), on the port's constants. Returns `path`."""
    from prisim_tpu_torch.constants import c
    theta = np.linspace(0.0, 90.0, ntheta)
    phi = np.linspace(0.0, 360.0, nphi)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for nu in freqs_hz:
            f.write('#Request Name: FarField\n')
            f.write('#Frequency: %.1f\n' % nu)
            f.write('#No. of Theta Samples: %d\n' % ntheta)
            f.write('#No. of Phi Samples: %d\n' % nphi)
            f.write('#  "Theta" "Phi" "Gain(Total)"\n')
            tt = np.radians(theta)[:, None]
            pp = np.radians(phi)[None, :]
            sig0 = 0.42 * c / (nu * d_eff)
            sx = sig0 * 1.08
            sy = sig0 * 0.94
            st = np.sin(tt)
            arg = ((st * np.cos(pp)) / sx) ** 2 \
                + ((st * np.sin(pp)) / sy) ** 2
            gdb = -10.0 * arg / np.log(10.0)
            gdb = gdb + 3.0 * np.sin(4.0 * st / sig0) ** 2 \
                * np.exp(-0.5 * arg) * 0.05
            for j in range(nphi):
                for i in range(ntheta):
                    f.write("%.4f %.4f %.6f\n"
                            % (theta[i], phi[j], gdb[i, j]))
    return path


def config4_parms(root, beam, n_acc=4):
    """BASELINE config #4 as benchmarks/bench_configs.config4 builds it:
    HERA-331 redundant (630 baselines), 14 m dish, 1024 ch x 97,656.25 Hz
    around 150 MHz, an nside-256 USM sky, the FEKO beam (chromatic) as the
    external beam, n_acc x 60 s drift from LST 0 (cut from 100), Trx 100 K;
    saved as the native FITS product in place of HDF5 (no h5py on the card
    machine)."""
    from prisim_tpu_torch.config import load_parms
    return load_parms({
        "dirstruct": {"rootdir": root, "project": "hera331_feko",
                      "simid": "cfg4"},
        "telescope": {"id": "hera", "latitude": -30.7224,
                      "A_eff": 154.0, "eff_Q": 0.96, "Trx": 100.0},
        "array": {"layout": "HERA-331", "redundant": True},
        "antenna": {"shape": "dish", "size": 14.0},
        "beam": {"use_external": True, "file": beam, "chromatic": True},
        "bandpass": {"freq": 150e6, "freq_resolution": 97656.25,
                     "nchan": 1024},
        "obsparm": {"obs_mode": "drift", "n_acc": n_acc, "t_acc": 60.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "usm", "nside": 256},
        "save_formats": {"fmt": "fits", "npz": False},
    })


def config4_phase(root, dev, redundant_fits, projects):
    """Phase l: the synthetic FEKO export (8 frequencies, 100-200 MHz)
    through tools.feko_to_healpix to a FITS beam (nside 64, spline), then
    BASELINE config #4 at full width on that beam through run_simulation
    (the external-beam route, K1a; per snapshot host weights, device beam
    and K1a, as phase d), saved as native FITS; on that product convert to
    NPZ and UVFITS (read back), update_noise to FITS on the card twice with
    one seed, replicate 4 realizations; expand_redundant_file on phase g's
    redundant FITS product (`redundant_fits`); list_sims and grep_sims over
    `projects`. Returns the numbers and the launches."""
    from prisim_tpu_torch import tools
    from prisim_tpu_torch.io import load_fits, load_npz
    from prisim_tpu_torch.io.uvfits import load_uvfits
    t0 = time.time()
    txt = write_synthetic_feko(os.path.join(root, "feko_beam.txt"),
                               np.linspace(100e6, 200e6, 8))
    t_txt = time.time() - t0
    t0 = time.time()
    beam = os.path.join(root, "feko_beam.fits")
    maps = tools.feko_to_healpix(txt, beam, nside=64, interp="spline")
    t_beam = time.time() - t0
    print("config #4 beam: FEKO text (8 frequencies x 91 x 73) written in "
          "%.3f s; feko_to_healpix -> %s (nside 64, spline) %.3f s; maps %s, "
          "peak %.4f, min %.4e" % (t_txt, os.path.basename(beam), t_beam,
                                   maps.shape, maps.max(), maps.min()))
    parms = config4_parms(root, beam)
    print("config #4: HERA-331 redundant x 1024 ch x nside-256 USM on the "
          "FEKO FITS beam; cut: accumulations 100 -> %d; products: native "
          "FITS in place of HDF5" % parms["obsparm"]["n_acc"])
    ext = external_phase(parms, dev, save=True)
    fits = os.path.join(ext["outdir"], "simdata", "simvis.fits")
    vs = load_fits(fits)
    print("config #4: %d bl x %d ch x %d acc, wall-clock %.3f s, K1a %d"
          % (vs.nbl, vs.nchan, vs.n_acc, ext["wall_s"],
             ext["launches"]["k1a"]))
    if not (vs.n_acc == parms["obsparm"]["n_acc"]
            and np.isfinite(vs.skyvis).all()):
        raise SystemExit("config #4: bad product")
    times = {}
    t0 = time.time()
    conv = tools.convert(fits, os.path.join(root, "cfg4_converted"),
                         ["npz", "uvfits"])
    times["convert (npz + uvfits)"] = time.time() - t0
    eq_npz = np.array_equal(load_npz(conv[0]).skyvis, vs.skyvis)
    d_uv = float(np.abs(load_uvfits(conv[1]).skyvis - vs.skyvis).max()
                 / np.abs(vs.skyvis).max())
    noisy = []
    for k in range(2):
        t0 = time.time()
        noisy.append(tools.update_noise(
            fits, os.path.join(root, "cfg4_noise%d.fits" % k), seed=7,
            device=dev))
        times["update_noise run %d" % (k + 1)] = time.time() - t0
    same = np.array_equal(noisy[0].vis_noise, noisy[1].vis_noise)
    ratio = float(np.sqrt(np.mean(np.abs(noisy[0].vis_noise) ** 2))
                  / np.sqrt(np.mean(np.asarray(noisy[0].vis_rms) ** 2)))
    back = load_fits(os.path.join(root, "cfg4_noise0.fits"))
    t0 = time.time()
    rep = tools.replicate(fits, os.path.join(root, "cfg4_replicas"),
                          n_realize=4, seed=100, device=dev)
    times["replicate (4)"] = time.time() - t0
    with np.load(rep[0]) as r:
        rep_shape = r["vis"].shape
        rep_differ = not np.array_equal(r["noise"][0], r["noise"][1])
    t0 = time.time()
    full = tools.expand_redundant_file(
        redundant_fits, os.path.join(root, "hera37_redundant_full.fits"))
    times["expand_redundant_file"] = time.time() - t0
    src = load_fits(redundant_fits)
    print("config #4 tools: convert -> NPZ equal %s, UVFITS read back "
          "max|dV|/max|V| = %.4e (bar %.0e); update_noise on %s twice with "
          "seed 7 bit-identical %s, noise rms / radiometer rms %.5f, the "
          "FITS read back equal %s; replicate %s, realizations differ %s; "
          "expand_redundant_file %d -> %d baselines; times %s"
          % (eq_npz, d_uv, CONVERT_BAR, dev, same, ratio,
             np.array_equal(back.vis_noise, noisy[0].vis_noise), rep_shape,
             rep_differ, src.nbl, full.nbl,
             "; ".join("%s %.3f s" % kv for kv in times.items())))
    if not (eq_npz and d_uv <= CONVERT_BAR and same
            and abs(ratio - 1.0) <= NOISE_RMS_BAR and rep_differ
            and full.nbl == 666 and src.nbl == 63):
        raise SystemExit("config #4 tools disagree")
    for proj in projects:
        t0 = time.time()
        listing = tools.list_sims(proj)
        hits = tools.grep_sims(proj, **{"array.layout": "HERA-331"})
        print("list_sims %s: %d sims, %d parameters differ; grep_sims "
              "array.layout=HERA-331: %s (%.3f s)"
              % (proj, len(listing["sims"]), len(listing["diffs"]), hits,
                 time.time() - t0))
        if not listing["sims"]:
            raise SystemExit("list_sims found no sims in %s" % proj)
    return dict(beam_s=t_beam, sim_s=ext["wall_s"],
                snapshots=ext["snapshots"], tools_s=times,
                k1a=ext["launches"]["k1a"], k2=ext["launches"]["k2"])


def example_phase(root, dev):
    """Phase m: examples.full_pipeline.main on the card (simulation with
    engine auto, delay power spectrum with CLEAN, closure phases, the
    UVFITS round trip), with the kernel counts set to 0 just before and
    read just after. Returns the numbers and the launches."""
    from prisim_tpu_torch.examples import full_pipeline
    log = io.StringIO()
    zero_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(log):
        out = full_pipeline.main(os.path.join(root, "example"), device=dev)
    wall = time.time() - t0
    got = counts()
    print(log.getvalue().rstrip())
    dps = np.asarray(out["dps"]["skyvis"])
    print("example: wall-clock %.3f s, engine %s, launches %s; UVFITS round "
          "trip %.3e of max|V| (bar %.0e); P(k) finite %s"
          % (wall, engine_ran(log.getvalue()), got, out["round_trip"],
             full_pipeline.ROUND_TRIP_BAR, bool(np.isfinite(dps).all())))
    if not (got["k1a"] > 0 and np.isfinite(dps).all()
            and out["round_trip"] < full_pipeline.ROUND_TRIP_BAR):
        raise SystemExit("example failed")
    return dict(wall_s=wall, k1a=got["k1a"], k2=got["k2"])


# --------------------------------------------------------------------------
# Phases n-o: the delay-space NUFFT with the sorted spread (kernel
# delay_spread), on one card and on the mesh
# --------------------------------------------------------------------------

# delay_spread vs its plain version, max|d grid| / max|grid|: both sum in
# float64; the kernel's atomics only change the order of the run sums
SPREAD_BAR = 1e-12
# the sorted route's own gate: max|dV| / max|V| against K1a's snapshot 0
# (the reference's cross-program bar, nufft_crosscheck_tol's default)
SORTED_GATE_TOL = 1e-4
SORTED_RANK = 32      # the slice's fractional bandwidth is 0.67 > 0.4
N_SPREAD_BL = 16      # north-star baselines of the kernel-vs-plain check


def spread_bound(a):
    """delay_spread's bound for one launch on kernel_args `a`, the larger
    of its operations' and its bytes' least times. Per live (source,
    baseline) pair: 4 K r float64 operations of the K taps' complex
    products (an FMA as 2), at the FP64 tensor-core peak (each run of
    equal bins is a dense (K x run) @ (run x 2r) product that DMMA could
    do), and 2 K (ncoef - 1) of the tap polynomials at the FP64 vector
    peak; the sincospi of the carrier is not counted. Bytes: the two-float
    delays of the live pairs and the float64 payload (as the kernel reads
    it) read once, the complex128 grid (B, n, r) written once."""
    pairs = float(a["S"]) * a["B"]
    K, r, nc = a["K"], a["r"], a["taps"].shape[1]
    t_ops = (pairs * 4 * K * r / FP64_TC_FLOPS
             + pairs * 2 * K * (nc - 1) / FP64_FLOPS) * 1e3
    nbytes = (pairs * 8 + a["P"].numel() * a["P"].element_size()
              + a["B"] * a["n"] * r * 16)
    t_bytes = nbytes / HBM_BPS * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                pairs=int(pairs))


def sorted_inputs(sim, dev, rank, t=0):
    """Snapshot t's spread inputs as simulate_snapshot_nufft_jit makes
    them: the two-float delays (S_live, B) of the sources above the
    horizon with a payload, for all baselines (the snapshot takes them in
    blocks of baselines), their float32 spectral coefficients (S_live,
    rank), the basis Q, and the coherent scale max_c sum_s |A_sc|."""
    from prisim_tpu_torch.engine import nufft_delay as nd
    from prisim_tpu_torch.engine.observe import (schedule_tensors,
                                                 snapshot_nudft_inputs)
    sched = schedule_tensors(sim.obs, sim.inst.latitude, dev)
    seh, sel, amps, _ = snapshot_nudft_inputs(
        sim.inst, sim.sky, *(a[t] for a in sched), sim.beam_fn,
        above_horizon=True)
    coherent = float(amps.double().abs().sum(dim=0).max())
    pinvQ, Q = nd.chebyshev_projection(sim.freqs, rank)
    P = nd.spectral_project(amps, torch.as_tensor(pinvQ, device=dev))
    del amps
    keep = nd.live_sources(P)
    th, tl = nd.delays_two_float(seh[keep], sel[keep], sim.inst.bl_hi,
                                 sim.inst.bl_lo)
    return th, tl, P[keep].contiguous(), Q, coherent


def spread_vs_plain(label, th, tl, P, inst, setup=None):
    """delay_spread against its plain version on these inputs; returns
    (max|d grid|, max|d grid| / max|grid|)."""
    from prisim_tpu_torch.engine.cuda_spread import (delay_spread_cuda,
                                                     delay_spread_plain)
    args = (th, tl, P, inst.nu0, inst.dnu, inst.nchan)
    g_k = delay_spread_cuda(*args, setup=setup)
    torch.cuda.synchronize()
    t0 = time.time()
    g_p = delay_spread_plain(*args)
    torch.cuda.synchronize()
    d = float((g_k - g_p).abs().max())
    rel = d / float(g_p.abs().max())
    print("%s delay_spread vs plain (%d live sources x %d bl x rank %d, grid "
          "%s; plain %.2f s): max|d grid|=%.4e  /max|grid|=%.4e (bar %.0e)"
          % (label, th.shape[0], th.shape[1], P.shape[1], tuple(g_k.shape),
             time.time() - t0, d, rel, SPREAD_BAR))
    if not (rel <= SPREAD_BAR and bool(torch.isfinite(g_k).all())):
        raise SystemExit("%s delay_spread disagrees with its plain version"
                         % label)
    return d, rel


def sorted_gate(dump):
    """The sorted route's gate readings from its PRISIM_DEBUG_XCHECK_DUMP
    file: (max|dV| / max|V|, max|dV| / max_c sum_s|A|)."""
    with np.load(dump) as g:
        dmax = float(np.abs(g["fast0"] - g["direct0"]).max())
        return (dmax / float(np.abs(g["direct0"]).max()),
                dmax / float(g["csA0"]))


SNAPSHOT_SPANS = ("beam_flux", "project", "delays", "spread.sort", "spread",
                  "post")


def snapshot_span_ms(fn, dev):
    """One call of `fn` (a sorted snapshot) with the recorder on, under a
    root span on `dev` and a "snapshot" span: ({span name: stream ms of
    the spans of that name directly under the snapshot, summed over its
    blocks}, the snapshot's own stream ms). Stream times exist on a card
    only; elsewhere they read 0."""
    from prisim_tpu_torch import tracing
    tracing.take()
    with tracing.on():
        with tracing.span("simulation", device=str(dev)):
            with tracing.span("snapshot", t=0):
                fn()
    recs = tracing.take()
    snap = next(r for r in recs if r["name"] == "snapshot")
    by = {}
    for r in recs:
        if r["parent"] == snap["id"]:
            by[r["name"]] = by.get(r["name"], 0.0) + r.get("device_ms", 0.0)
    if set(by) != set(SNAPSHOT_SPANS):
        raise SystemExit("sorted snapshot spans: %s, not %s"
                         % (sorted(by), sorted(SNAPSHOT_SPANS)))
    return by, snap.get("device_ms", 0.0)


def sorted_phase(root, dev, have_h5py, v0, ns):
    """Phase n: the sorted route at the slice and one north-star snapshot.
    `v0` is phase 1's K1a snapshot 0; `ns` phase 5's north-star numbers
    (the banded snapshot and K1a times of this card)."""
    from prisim_tpu_torch.driver import prepare_simulation
    from prisim_tpu_torch.engine import cuda_spread as cs
    from prisim_tpu_torch.engine import nufft_delay as nd
    from prisim_tpu_torch.engine.cuda_nudft import nudft_cuda
    from prisim_tpu_torch.engine.observe import (schedule_tensors,
                                                 snapshot_nudft_inputs)
    parms = slice_parms(root, have_h5py, "nufft", "hera37_usm64_sorted",
                        processing={"nufft_spread": "sorted"},
                        save_formats={"fmt": "none", "npz": True})
    sim = prepare_simulation(parms, dev)
    inst = sim.inst
    th, tl, P, Q, coherent = sorted_inputs(sim, dev, SORTED_RANK)
    m0, _, n = nd.fold_delay_bins(th, tl, inst.dnu, inst.nchan)
    setup = nd._sorted_spread_setup(m0, n)
    del m0
    print("sorted phase: %d of %d sources above the horizon x %d bl, rank "
          "%d, grid n=%d" % (th.shape[0], sim.sky.flux.shape[0], inst.nbl,
                             P.shape[1], n))
    d_abs, _ = spread_vs_plain("slice", th, tl, P, inst, setup)
    spread_args = (th, tl, P, inst.nu0, inst.dnu, inst.nchan)
    a = cs.kernel_args(*spread_args, setup=setup)
    bd = spread_bound(a)
    # times: plain, kernel, kernel, plain (the plain version once a turn)
    t_p = cuda_time_ms(lambda: cs.delay_spread_plain(*spread_args), n=1)
    t_k = cuda_time_ms(lambda: cs.launch(a))
    t_k2 = cuda_time_ms(lambda: cs.launch(a))
    t_p2 = cuda_time_ms(lambda: cs.delay_spread_plain(*spread_args), n=1)
    t_args = cuda_time_ms(lambda: cs.kernel_args(*spread_args, setup=setup))
    t_setup = cuda_time_ms(lambda: nd._sorted_spread_setup(
        nd.fold_delay_bins(th, tl, inst.dnu, inst.nchan)[0], n))
    pinvQ, _ = nd.chebyshev_projection(sim.freqs, SORTED_RANK)
    Mh, Ml, pch, pcl = (x[0] for x in schedule_tensors(sim.obs, inst.latitude,
                                                        dev))
    t_snap = cuda_time_ms(lambda: nd.simulate_snapshot_nufft_jit(
        inst, sim.sky, Mh, Ml, pch, pcl, sim.beam_fn, pinvQ, Q))
    ms_k, ms_p = 0.5 * (t_k + t_k2), 0.5 * (t_p + t_p2)
    print("delay_spread time: %.4f ms (runs %.4f, %.4f) per slice snapshot; "
          "plain %.4f ms (runs %.4f, %.4f); the wrapper's set-up with the "
          "sort given (bins, layouts, zeroed grid) %.4f ms; bins and sort "
          "%.4f ms; sorted snapshot (beam, projection, delays, set-up, "
          "kernel, FFT post) %.4f ms"
          % (ms_k, t_k, t_k2, ms_p, t_p, t_p2, t_args, t_setup, t_snap))
    print("delay_spread bound: %.4f ms (%s; %d live pairs); share %.4f"
          % (bd["bound_ms"], bd["bound_by"], bd["pairs"],
             bd["bound_ms"] / ms_k))
    del a, setup, th, tl, P
    torch.cuda.empty_cache()

    dump = os.path.join(root, "sorted_gate.npz")
    os.makedirs(root, exist_ok=True)
    if os.path.exists(dump):
        os.remove(dump)
    os.environ["PRISIM_DEBUG_XCHECK_DUMP"] = dump
    try:
        (vs, outdir), log, got, wall = drive(
            "sorted slice, engine nufft, nufft_spread sorted", parms, dev,
            save=True)
    finally:
        os.environ.pop("PRISIM_DEBUG_XCHECK_DUMP", None)
    g_v, g_c = sorted_gate(dump)
    print("sorted slice gate (sorted vs K1a snapshot 0): /max|V|=%.4e (the "
          "run's bar %.0e)  /max_c sum_s|A|=%.4e"
          % (g_v, SORTED_GATE_TOL, g_c))
    want = phased_snapshot0(vs, parms, v0)
    d0 = float(np.abs(vs.skyvis[:, :, 0] - want).max())
    print("sorted slice snapshot 0 vs phase 1's K1a snapshot: max|dV|=%.4e  "
          "/max|V|=%.4e  /max_c sum_s|A|=%.4e (bar %.0e of max_c sum_s|A|)"
          % (d0, d0 / np.abs(want).max(), d0 / coherent, BAR))
    if not ("cross-check ok" in log and engine_ran(log) == "sorted"
            and got["spread"] == 4 and got["k1a"] == 1 and got["k2"] == 0
            and g_v <= SORTED_GATE_TOL and d0 / coherent <= BAR
            and vs.skyvis.shape == np.shape(v0) + (4,)
            and np.isfinite(vs.skyvis).all()):
        raise SystemExit("sorted slice run failed")
    with np.load(os.path.join(outdir, "simdata", "simvis.npz")) as f:
        assert np.array_equal(f["skyvis_freq"], vs.skyvis)
    launches = got["spread"]
    del vs
    torch.cuda.empty_cache()

    # one north-star snapshot
    nparms = northstar_parms(processing={"engine": "nufft",
                                         "nufft_spread": "sorted"})
    t0 = time.time()
    nsim = prepare_simulation(nparms, dev)
    ninst = nsim.inst
    Mh, Ml, pch, pcl = (x[0] for x in schedule_tensors(
        nsim.obs, ninst.latitude, dev))
    pinvQ, Q = nd.chebyshev_projection(nsim.freqs, SORTED_RANK)
    torch.cuda.synchronize()
    print("north-star sorted snapshot: %d bl x %d ch x %d sources (set-up "
          "%.2f s)" % (ninst.nbl, ninst.nchan, nsim.sky.flux.shape[0],
                       time.time() - t0))

    def snap():
        return nd.simulate_snapshot_nufft_jit(ninst, nsim.sky, Mh, Ml, pch,
                                              pcl, nsim.beam_fn, pinvQ, Q)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    v = snap()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    t_ns = cuda_time_ms(snap, n=2, warm=False)
    print("north-star sorted snapshot: peak device memory %.4f GB (%.4f GB "
          "held before it: the sky and the instrument)"
          % (torch.cuda.max_memory_allocated() / 1e9, base_gb))
    assert v.shape == (ninst.nbl, ninst.nchan)
    assert bool(torch.isfinite(v).all())
    print("north-star sorted snapshot: first %.4f s, then %.4f ms; beside "
          "this card's banded snapshot %.4f ms and K1a launch %.4f ms "
          "(phase 5)" % (first_s, t_ns, ns["snap_ms"], ns["k1a_ms"]))
    span_ms, span_total = snapshot_span_ms(snap, dev)
    print("north-star sorted snapshot, stream ms by span: %s; together "
          "%.4f of the snapshot span's %.4f ms (%.2f%%)"
          % (", ".join("%s %.4f" % (k, span_ms[k]) for k in SNAPSHOT_SPANS),
             sum(span_ms.values()), span_total,
             100.0 * sum(span_ms.values()) / max(span_total, 1e-30)))
    pick, lens = golden_pick(ninst)
    pk = torch.as_tensor(pick, device=dev)
    seh, sel, amps, _ = snapshot_nudft_inputs(ninst, nsim.sky, Mh, Ml, pch,
                                              pcl, nsim.beam_fn)
    ncoh = float(amps.double().abs().sum(dim=0).max())
    bh, bl = (ninst.bl_hi[pk].contiguous(), ninst.bl_lo[pk].contiguous())
    vd = nudft_cuda(seh, sel, bh, bl, amps, ninst.grid_scalars(),
                    ninst.nchan)
    dv = float((v[pk] - vd).abs().max())
    rel_v = dv / float(vd.abs().max())
    print("north-star sorted snapshot vs K1a on %d bl (%.1f-%.1f m): "
          "max|dV|=%.4e  /max|V|=%.4e (bar %.0e)  /max_c sum_s|A|=%.4e"
          % (len(pick), lens[pick[0]], lens[pick[-1]], dv, rel_v,
             SORTED_GATE_TOL, dv / ncoh))
    if not rel_v <= SORTED_GATE_TOL:
        raise SystemExit("north-star sorted snapshot disagrees with K1a")
    del seh, sel, amps, vd, v
    torch.cuda.empty_cache()
    th, tl, P, _, _ = sorted_inputs(nsim, dev, SORTED_RANK)
    # the launches of one snapshot: its blocks of baselines
    step = max(1, nd._BLOCK_PAIRS // th.shape[0])
    blocks = [cs.kernel_args(th[:, b0:b0 + step].contiguous(),
                             tl[:, b0:b0 + step].contiguous(), P, ninst.nu0,
                             ninst.dnu, ninst.nchan)
              for b0 in range(0, ninst.nbl, step)]
    bds = [spread_bound(a) for a in blocks]
    ns_bd = dict(bound_ms=sum(b["bound_ms"] for b in bds),
                 bound_by="/".join(sorted({b["bound_by"] for b in bds})),
                 pairs=sum(b["pairs"] for b in bds))
    t_nk = cuda_time_ms(lambda: [cs.launch(a) for a in blocks], n=2)
    del blocks
    torch.cuda.empty_cache()
    print("north-star delay_spread: %.4f ms per snapshot (%d launches of up "
          "to %d baselines); bound %.4f ms (%s; %d live pairs); share %.4f"
          % (t_nk, len(bds), min(step, ninst.nbl), ns_bd["bound_ms"],
             ns_bd["bound_by"], ns_bd["pairs"], ns_bd["bound_ms"] / t_nk))
    spread_vs_plain("north-star, %d bl from %.1f to %.1f m:"
                    % (len(pick), lens[pick[0]], lens[pick[-1]]),
                    th[:, pk].contiguous(), tl[:, pk].contiguous(), P, ninst)
    del th, tl, P, nsim
    torch.cuda.empty_cache()
    return dict(max_abs_err=d_abs, ms=ms_k, plain_ms=ms_p, launches=launches,
                k1a=got["k1a"], wall_s=wall, snap_ms=t_snap, ns_ms=t_nk,
                ns_snap_ms=t_ns, ns_span_ms=span_ms,
                ns_span_total_ms=span_total,
                ns_bound=ns_bd, **bd)


def sorted_mesh_phase(root, dev, have_h5py, n_acc=2):
    """Phase o: the sorted route on MESH_SHARDS shards of `dev` with
    pp.key freq (1, 4), bl (4, 1), src (1, 1, 4) and pp.mesh_axes [2, 2],
    each against the one-device sorted run; launches per shard and
    accumulation. Returns the numbers and the launches."""
    devs = [dev] * MESH_SHARDS

    def parms(simid, **pp):
        return slice_parms(root, have_h5py, "nufft", simid,
                           obsparm={"n_acc": n_acc},
                           processing={"nufft_spread": "sorted"},
                           save_formats={"fmt": "none", "npz": False}, pp=pp)

    base = parms("sorted_mesh_single", key="none")
    (one, _), _, got1, wall1 = drive("sorted mesh phase, one device", base,
                                     dev)
    assert got1["spread"] == n_acc and got1["k1a"] == 1, got1
    coh, _ = coherent_scale(base, dev)
    vmax = float(np.abs(one.skyvis).max())
    out = dict(single_s=wall1, runs={}, spread=got1["spread"],
               k1a=got1["k1a"])
    for label, pp in (
            ("freq (1, 4)", {"key": "freq"}),
            ("bl (4, 1)", {"key": "bl"}),
            ("src (1, 1, 4)", {"key": "src"}),
            ("freq, mesh_axes [2, 2]", {"key": "freq", "mesh_axes": [2, 2]})):
        simid = "sorted_mesh_" + label.split()[0].strip(",") + (
            "_axes" if "mesh_axes" in pp else "")
        (vs, _), log, got, wall = drive(
            "sorted mesh phase, pp.key %s" % label, parms(simid, **pp), dev,
            devices=devs)
        d = float(np.abs(vs.skyvis - one.skyvis).max())
        # every shard fits its own (sub-)band's basis in float32
        # (chebyshev_basis_jit, as the reference's mesh does), src shards
        # add complex64 partials: the f32 engines' bar of the coherent scale
        want = MESH_SHARDS * n_acc
        print("sorted mesh %s vs one device: max|dV|=%.4e  /max|V|=%.4e  "
              "/max_c sum_s|A|=%.4e (bar %.0e of max_c sum_s|A|); "
              "delay_spread launches %d (shards x accumulations: %d), K1a %d "
              "(the gate); %.3f s against %.3f s on one device"
              % (label, d, d / vmax, d / coh, MESH_SRC_BAR, got["spread"],
                 want, got["k1a"], wall, wall1))
        if not (d / coh <= MESH_SRC_BAR and got["spread"] == want
                and got["k1a"] == 1 and got["k2"] == 0
                and "cross-check ok" in log and "mesh of" in log):
            raise SystemExit("sorted mesh %s disagrees with one device"
                             % label)
        out["runs"][label] = dict(wall_s=wall, rel_v=d / vmax, rel_c=d / coh)
        out["spread"] += got["spread"]
        out["k1a"] += got["k1a"]
    return out


# --------------------------------------------------------------------------
# Phase p: the north-star main path end to end, at its 100 accumulations
# --------------------------------------------------------------------------

# a phase line of the driver's verbose log: "[prisim_tpu_torch] ... <label>
# (<seconds> s)"
PHASE_LINE = re.compile(r"^\[prisim_tpu_torch\] \.\.\. (.+) \(([0-9.]+) s\)$",
                        re.M)
# the north star's own bar against the float64 golden (ROADMAP R2): printed
# beside the readings, not held
NORTHSTAR_TRUTH_BAR = 1e-6


def northstar_run_parms(rootdir):
    """The sections of prisim_tpu/examples/simparms/hera331_northstar.yaml,
    built as a dict (the card machine has no pyyaml): HERA-331 redundant
    (630 baselines), 1024 channels, nside-256 USM, all 100 accumulations,
    processing at its defaults (engine auto), with dirstruct.rootdir
    `rootdir` and the product as native FITS (save_formats fmt fits, npz
    false) in place of the YAML's HDF5, which needs h5py."""
    from prisim_tpu_torch.config import load_parms
    return load_parms({
        "dirstruct": {"rootdir": rootdir, "project": "hera331_northstar"},
        "telescope": {"id": "hera", "latitude": -30.7224,
                      "longitude": 21.4278, "A_eff": 154.0, "eff_Q": 0.96,
                      "Trx": 100.0},
        "array": {"layout": "HERA-331", "redundant": True},
        "antenna": {"shape": "dish", "size": 14.0},
        "bandpass": {"freq": 150000000.0, "freq_resolution": 97656.25,
                     "nchan": 1024},
        "obsparm": {"obs_mode": "drift", "n_acc": 100, "t_acc": 60.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "usm", "nside": 256},
        "pp": {"key": "freq"},
        "save_formats": {"fmt": "fits", "npz": False},
    })


def northstar_run_phase(root, dev):
    """Phase p: run_simulation(northstar_run_parms, save=True) on the card
    with the kernel counts set to 0 just before it and read just after.
    Fails on a demotion (phase 5 passes the same gate at the same LST) and
    on K2/K1a counts other than the banded engine's (a launch per source
    chunk and snapshot, the gate's included; K1a twice per chunk in truth
    mode, once otherwise). Prints the wall-clock split by the driver's
    phase lines and the peak device memory; snapshots 0 and n_acc - 1
    against K1a on the same snapshot's inputs, phased as the run phases
    them (GATE_TOL of the coherent scale), and against the float64 golden
    on golden_pick's baselines in both normalizations (printed beside
    NORTHSTAR_TRUTH_BAR, not held); the FITS product read back with
    load_fits, equal to the returned VisibilitySet. Returns the run's
    counts."""
    from prisim_tpu_torch.driver import banded_engine, prepare_simulation
    from prisim_tpu_torch.engine.cuda_nudft import nudft_cuda
    from prisim_tpu_torch.engine.nudft import nudft_reference_f64
    from prisim_tpu_torch.engine.observe import (schedule_tensors,
                                                 snapshot_nudft_inputs)
    from prisim_tpu_torch.io import load_fits
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        parms = northstar_run_parms(tmp)
        n_acc = parms["obsparm"]["n_acc"]
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        (vs, outdir), log, got, wall = drive(
            "north-star run (%d accumulations)" % n_acc, parms, dev,
            save=True)
        peak = torch.cuda.max_memory_allocated(dev)
        engine = engine_ran(log)
        for line in log.splitlines():
            if "FAILED" in line or "falling back" in line:
                print("north-star run demotion: %s" % line.strip())
        print("north-star run engine: %s" % engine)
        if engine != "banded":
            raise SystemExit("north-star run: engine %s, not the banded "
                             "engine with no demotion" % engine)
        n_chunks = int(re.search(r"(\d+) source chunk\(s\) of", log)
                       .group(1))
        per_chunk = 2 if "truth amps" in log else 1
        want = dict(dict.fromkeys(got, 0), k2=n_chunks * (n_acc + 1),
                    k1a=per_chunk * n_chunks)
        print("north-star run launches: K2 %d (%d source chunks x (%d "
              "snapshots + the gate's 1): %d), K1a %d (the gate's, %d a "
              "chunk: %d)" % (got["k2"], n_chunks, n_acc, want["k2"],
                              got["k1a"], per_chunk, want["k1a"]))
        if got != want:
            raise SystemExit("north-star run launches %s, expected %s"
                             % (got, want))

        ph = {label: float(sec) for label, sec in PHASE_LINE.findall(log)}
        setup = next(v for k, v in ph.items()
                     if k.startswith("inputs built and on"))
        gate = ph["banded shared-amps gate"]
        vis = ph["visibilities computed + transferred"]
        noise = ph["Tsys, rms and noise"]
        post = ph["gains, container, phasing, projection"]
        write = ph["products saved"]
        print("north-star run wall-clock split: set-up %.2f s, gate %.2f s, "
              "plan + %d snapshots + transfer %.2f s (%.4f s a snapshot), "
              "finalize %.2f s (Tsys, rms and noise %.2f s; gains, "
              "container, phasing, projection %.2f s), product write %.2f "
              "s; whole run %.3f s"
              % (setup, gate, n_acc, vis - gate, (vis - gate) / n_acc,
                 noise + post, noise, post, write, wall))
        print("north-star run peak device memory: %.4f GB "
              "(torch.cuda.max_memory_allocated)" % (peak / 1e9))
        # snapshots 0 and n_acc - 1 against K1a and the golden
        sim = prepare_simulation(parms, dev)
        inst = sim.inst
        B, C = inst.nbl, inst.nchan
        print("north-star run cube %s (%d bl x %d ch x %d acc, %d sources)"
              % (vs.skyvis.shape, B, C, n_acc, sim.sky.flux.shape[0]))
        assert vs.skyvis.shape == (B, C, n_acc), vs.skyvis.shape
        assert np.isfinite(vs.skyvis).all() and np.isfinite(vs.vis).all()
        _, snap = banded_engine(parms, sim)
        Mh, Ml, pch, pcl = schedule_tensors(sim.obs, inst.latitude, dev)
        pick, lens = golden_pick(inst)
        bl64 = torch.as_tensor(joined(inst.bl_hi, inst.bl_lo)[pick],
                               device=dev)
        # the run's complex64 phasor of each (baseline, channel)
        ones = np.ones((B, C), np.complex64)
        worst = 0.0
        for t in (0, n_acc - 1):
            run_t = vs.skyvis[:, :, t]
            at = (Mh[t], Ml[t], pch[t], pcl[t])
            # the gate's form: K1a on the amplitudes the banded engine
            # models (in truth mode the float64 model amps, split hi/lo)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            direct, banded, ok, resid, coherent = snap.gate_fn(*at)
            peak_gate = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            snap(*at)
            print("north-star run snapshot %d: peak device memory of the "
                  "gate alone %.4f GB, of one banded snapshot alone %.4f GB "
                  "(%.4f GB held before each)"
                  % (t, peak_gate / 1e9,
                     torch.cuda.max_memory_allocated(dev) / 1e9, held / 1e9))
            k1a = phased_snapshot0(vs, parms, direct.astype(np.complex64), t)
            d = float(np.abs(run_t - k1a).max())
            db = float(np.abs(run_t - phased_snapshot0(
                vs, parms, banded.astype(np.complex64), t)).max()) \
                / float(np.abs(run_t).max())
            print("north-star run snapshot %d vs K1a on the model amps (all "
                  "%d bl): max|dV|=%.4e  /max|V|=%.4e  /max_c sum_s|A|=%.4e "
                  "(bar %.0e); vs the banded snapshot recomputed: "
                  "max|dV|/max|V|=%.3e; ok=%s, amps-space model residual "
                  "%.4e" % (t, B, d, d / float(np.abs(k1a).max()),
                            d / coherent, GATE_TOL, db, ok, resid))
            worst = max(worst, d / coherent)
            if not (ok and db <= 1e-6):
                raise SystemExit("north-star run snapshot %d differs from "
                                 "its banded snapshot recomputed: %.3e "
                                 "(ok=%s)" % (t, db, ok))
            # K1a on the full-channel float32 amps, and the float64 golden
            # on the same amps: readings, not bars (the model residual
            # above separates the two amplitude sets)
            seh, sel, amps, _ = snapshot_nudft_inputs(
                inst, sim.sky, *at, sim.beam_fn)
            v_k = nudft_cuda(seh, sel, inst.bl_hi, inst.bl_lo, amps,
                             inst.grid_scalars(), inst.nchan)
            cs32 = float(amps.abs().sum(dim=0).max())
            k1a32 = phased_snapshot0(vs, parms, v_k.cpu().numpy(), t)
            d32 = float(np.abs(run_t - k1a32).max())
            print("north-star run snapshot %d vs K1a on the float32 amps: "
                  "max|dV|=%.4e  /max|V|=%.4e  /max_c sum_s|A|=%.4e"
                  % (t, d32, d32 / float(np.abs(k1a32).max()), d32 / cs32))
            gold = nudft_reference_f64(joined(seh, sel), bl64, amps,
                                       inst.freqs).cpu().numpy()
            gold = gold * phased_snapshot0(vs, parms, ones, t)[pick]
            gmax = float(np.abs(gold).max())
            for label, v in (("run", run_t[pick]), ("K1a", k1a32[pick])):
                dg = float(np.abs(v - gold).max())
                print("north-star run snapshot %d, %s vs f64 golden on the "
                      "float32 amps (%d bl, %.1f-%.1f m): max|dV|=%.4e  "
                      "/max|V|=%.4e  /max_c sum_s|A|=%.4e  (north star's "
                      "bar %.0e, not held)"
                      % (t, label, len(pick), lens[pick[0]], lens[pick[-1]],
                         dg, dg / gmax, dg / cs32, NORTHSTAR_TRUTH_BAR))
            del seh, sel, amps, v_k
        del sim, snap
        torch.cuda.empty_cache()
        if not worst <= GATE_TOL:
            raise SystemExit("north-star run disagrees with K1a: %.3e of the "
                             "coherent scale (bar %.0e)" % (worst, GATE_TOL))

        t0 = time.time()
        path = os.path.join(outdir, "simdata", "simvis.fits")
        back = load_fits(path)
        exact = all(np.array_equal(getattr(back, n), getattr(vs, n))
                    for n in ("skyvis", "vis", "vis_noise", "baselines",
                              "freqs", "lst", "labels"))
        print("north-star run product %s (%.4f GB) read back with load_fits "
              "in %.2f s: %s the returned run"
              % (os.path.basename(path), os.path.getsize(path) / 1e9,
                 time.time() - t0, "equal to" if exact else "DIFFERS from"))
        if not exact:
            raise SystemExit("north-star run: the FITS product differs from "
                             "the returned VisibilitySet")
    return got


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from prisim_tpu_torch._build import build_info, load_kernel_library
    from prisim_tpu_torch.driver import prepare_simulation, run_simulation
    from prisim_tpu_torch.engine import (cuda_banded, cuda_beam,
                                         cuda_finalize, cuda_nudft,
                                         cuda_prep, cuda_spread)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    have_h5py, have_yaml = importable("h5py"), importable("yaml")
    print("torch %s (CUDA %s), device %s, count %d"
          % (torch.__version__, torch.version.cuda, name,
             torch.cuda.device_count()))
    print("h5py importable: %s; yaml importable: %s" % (have_h5py, have_yaml))

    t0 = time.time()
    libs = ("nudft", "banded", "spread", "beam", "prep", "finalize")
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        list(pool.map(load_kernel_library, libs))
    print("kernel builds (in parallel): %.2f s" % (time.time() - t0))
    for kname in libs:
        info = build_info(kname)
        print("%s build: %.2f s (%s) -> %s"
              % (kname, info["seconds"],
                 "compiled" if info["built"] else "cached", info["path"]))
        print(info["report"].strip())

    root = os.path.dirname(os.path.abspath(__file__))
    out_root = os.path.join(root, "build", "chip_smoke")
    direct = slice_parms(out_root, have_h5py, "direct", "hera37_usm64_direct")

    t0 = time.time()
    sim = prepare_simulation(direct, cuda)
    k = kernel_phase(sim, cuda)
    torch.cuda.empty_cache()
    print("[K1a phase: %.2f s]" % (time.time() - t0))
    t0 = time.time()
    airy = airy_amps_phase(sim.beam_fn, sim.freqs, cuda)
    del sim
    torch.cuda.empty_cache()
    print("[airy_amps phase: %.2f s]" % (time.time() - t0))
    t0 = time.time()
    fin = finalize_phase(cuda)
    print("[phase_cubes phase: %.2f s]" % (time.time() - t0))

    print("direct slice phase: run_simulation(device='cuda'), engine: "
          "direct, products: NPZ%s" % (" + HDF5" if have_h5py else
                                       " only (no h5py)"))
    t0 = time.time()
    cuda_nudft.nudft_cuda.launches = 0
    cuda_beam.airy_amps_cuda.launches = 0
    cuda_finalize.phase_cubes_cuda.launches = 0
    vs, outdir = run_simulation(direct, verbose=True, save=True, device=cuda)
    k1a_launches = cuda_nudft.nudft_cuda.launches
    airy_launches = cuda_beam.airy_amps_cuda.launches
    wall = time.time() - t0
    print("direct slice wall-clock: %.3f s (666 bl x 1024 ch x 4 acc, "
          "49152 src), K1a launches: %d, airy_amps launches: %d"
          % (wall, k1a_launches, airy_launches))
    assert vs.skyvis.shape == (666, 1024, 4), vs.skyvis.shape
    assert np.isfinite(vs.skyvis).all() and np.isfinite(vs.vis).all()
    assert k1a_launches == 4 and airy_launches == 4, (k1a_launches,
                                                      airy_launches)
    want = phased_snapshot0(vs, direct, k["v0"])
    d0 = np.abs(vs.skyvis[:, :, 0] - want).max() / np.abs(want).max()
    print("snapshot 0 vs kernel phase: max|dV|/max|V| = %.3e (%s)"
          % (d0, "bit-exact" if d0 == 0 else "not bit-exact"))
    assert d0 <= 1e-6, d0
    check_products(vs, outdir, have_h5py)
    direct_skyvis = vs.skyvis
    del vs
    print("[direct slice phase: %.2f s]" % (time.time() - t0))

    banded = slice_parms(out_root, have_h5py, "auto", "hera37_usm64_banded")
    t0 = time.time()
    k2 = k2_phase(banded, cuda)
    torch.cuda.empty_cache()
    print("[K2 phase: %.2f s]" % (time.time() - t0))

    print("banded slice phase: run_simulation(device='cuda'), engine: auto")
    t0 = time.time()
    dump = os.path.join(out_root, "banded_gate.npz")
    os.makedirs(out_root, exist_ok=True)
    os.environ["PRISIM_DEBUG_XCHECK_DUMP"] = dump
    cuda_nudft.nudft_cuda.launches = 0
    cuda_banded.banded_spread_cuda.launches = 0
    cuda_beam.airy_amps_cuda.launches = 0
    cuda_prep.banded_prep_cuda.launches = 0
    vs, outdir = run_simulation(banded, verbose=True, save=True, device=cuda)
    k2_launches = cuda_banded.banded_spread_cuda.launches
    gate_k1a = cuda_nudft.nudft_cuda.launches
    gate_airy = cuda_beam.airy_amps_cuda.launches
    prep_launches = cuda_prep.banded_prep_cuda.launches
    fin_launches = cuda_finalize.phase_cubes_cuda.launches
    del os.environ["PRISIM_DEBUG_XCHECK_DUMP"]
    wall = time.time() - t0
    print("banded slice wall-clock: %.3f s, K2 launches: %d (gate 1 + 4 "
          "snapshots expected), K1a launches: %d (the gate's direct side, "
          "hi + lo: 2 expected; a demotion adds 4), airy_amps launches: %d "
          "(the gate's one source chunk: 1 expected; the truth-amps "
          "snapshots weight no f32 beam)"
          % (wall, k2_launches, gate_k1a, gate_airy))
    assert k2_launches == 5 and gate_k1a == 2 and gate_airy == 1, (
        k2_launches, gate_k1a, gate_airy)
    print("banded slice banded_prep launches: %d (one a source chunk and "
          "snapshot, the gate's included: 5 expected)" % prep_launches)
    assert prep_launches == 5, prep_launches
    print("direct and banded slice runs' phase_cubes launches: %d (one a "
          "finalize: 2 expected)" % fin_launches)
    assert fin_launches == 2, fin_launches
    airy_launches += gate_airy
    assert vs.skyvis.shape == (666, 1024, 4), vs.skyvis.shape
    assert np.isfinite(vs.skyvis).all() and np.isfinite(vs.vis).all()
    with np.load(dump) as g:
        gate = (g["direct0"], g["fast0"], bool(g["ok0"]),
                float(g["resid0"]), float(g["csA0"]))
    gate_report("banded slice", gate)
    want = phased_snapshot0(vs, banded, gate[1])
    d0 = np.abs(vs.skyvis[:, :, 0] - want).max() / np.abs(want).max()
    print("snapshot 0 vs the gate's banded snapshot: max|dV|/max|V| = %.3e"
          % d0)
    assert d0 <= 1e-6, d0
    dd = np.abs(vs.skyvis - direct_skyvis).max()
    print("banded run vs direct run, all 4 snapshots: max|dV|/max|V| = %.3e"
          % (dd / np.abs(direct_skyvis).max()))
    check_products(vs, outdir, have_h5py)
    del vs, direct_skyvis
    torch.cuda.empty_cache()
    print("[banded slice phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    ns = northstar_phase(cuda)
    prep_launches += ns["prep_launches"]
    print("[north-star phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    plan_phase(cuda)
    torch.cuda.empty_cache()
    print("[plan phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    prep_sl = banded_prep_phase("slice", banded, cuda)
    prep_ns = banded_prep_phase("north-star", northstar_parms(), cuda)
    print("banded_prep phase launches (comparisons and timing loops, not "
          "in the kernels line): slice %d, north star %d"
          % (prep_sl["launches"], prep_ns["launches"]))
    print("[banded_prep phase: %.2f s]" % (time.time() - t0))

    grad = slice_parms(out_root, have_h5py, "auto", "hera37_usm64_gradient",
                       processing={"gradient_mode": "baseline"})
    t0 = time.time()
    k1b = mode_phase("K1b", prepare_simulation(grad, cuda), cuda,
                     gradient=True, shaped=False)
    torch.cuda.empty_cache()
    print("[K1b phase: %.2f s]" % (time.time() - t0))
    vs, got = direct_mode_slice("gradient slice", grad, have_h5py, cuda,
                                k1b["out"][0], dict(k1b=4))
    k1b_launches = got["k1b"]
    g = vs.gradients["baseline"]
    assert g.shape == (3, 666, 1024, 4) and np.isfinite(g).all(), g.shape
    d0 = np.abs(g[:, :, :, 0] - k1b["out"][1]).max() / np.abs(g).max()
    print("gradient cube %s; snapshot 0 vs the K1b phase's planes: "
          "max|dG|/max|G| = %.3e" % (g.shape, d0))
    assert d0 <= 1e-6, d0
    del vs, g, k1b["out"]
    torch.cuda.empty_cache()

    t0 = time.time()
    prefix = os.path.join(out_root, "dsm")
    for nside in (64, 256):
        write_dsm_fits(prefix, nside)
    print("DSM FITS maps written (nside 64 and 256): %.2f s"
          % (time.time() - t0))
    dsm = slice_parms(out_root, have_h5py, "auto", "hera37_dsm64",
                      skyparm={"model": "dsm", "nside": 64},
                      catalog={"DSM_file_prefix": prefix})
    t0 = time.time()
    sim = prepare_simulation(dsm, cuda)
    k1c = mode_phase("K1c", sim, cuda, gradient=False, shaped=True)
    both_modes_small(sim, cuda)
    del sim
    torch.cuda.empty_cache()
    print("[K1c phase: %.2f s]" % (time.time() - t0))
    vs, got = direct_mode_slice("DSM slice", dsm, have_h5py, cuda,
                                k1c["out"][0], dict(k1c=4))
    k1c_launches = got["k1c"]
    del vs, k1c["out"]
    torch.cuda.empty_cache()

    t0 = time.time()
    ns_k1c = northstar_mode_phase(
        "north-star K1c", northstar_parms(
            skyparm={"model": "dsm", "nside": 256},
            catalog={"DSM_file_prefix": prefix}), cuda, gradient=False)
    torch.cuda.empty_cache()
    print("[north-star K1c phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    ns_k1b = northstar_mode_phase(
        "north-star K1b", northstar_parms(
            processing={"engine": "auto", "gradient_mode": "baseline"}),
        cuda, gradient=True)
    torch.cuda.empty_cache()
    print("[north-star K1b phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    from prisim_tpu_torch.engine.observe import df_rotate3, schedule_tensors
    sim = prepare_simulation(direct, cuda)
    Mh, Ml, _, _ = schedule_tensors(sim.obs, sim.inst.latitude, cuda)
    dirs = df_rotate3(Mh[0], Ml[0], sim.sky.s_eq_hi, sim.sky.s_eq_lo)[0]
    beams_phase(dirs.contiguous(), torch.as_tensor(
        sim.freqs, dtype=torch.float32, device=cuda), cuda)
    del sim, dirs
    torch.cuda.empty_cache()
    print("[beams phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    config2_phase(os.path.join(out_root, "cfg2"), cuda)
    torch.cuda.empty_cache()
    print("[config #2 phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    track_phase(os.path.join(out_root, "cfg2"), cuda)
    torch.cuda.empty_cache()
    print("[phased-array track phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    beam = write_feko_like_beam(os.path.join(out_root, "feko_beam.fits"))
    external_phase(northstar_parms(
        obsparm={"n_acc": 2},
        beam={"use_external": True, "file": beam, "chromatic": True},
        processing={"engine": "auto"}), cuda)
    torch.cuda.empty_cache()
    print("[external beam phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    sectors_phase(
        slice_parms(out_root, have_h5py, "auto", "hera37_sectors",
                    processing={"n_sky_sectors": 3}),
        slice_parms(out_root, have_h5py, "auto", "hera37_sectors_full"), cuda)
    torch.cuda.empty_cache()
    print("[sky sectors phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    fullpol_phase(os.path.join(out_root, "cfg2"), cuda)
    torch.cuda.empty_cache()
    print("[full polarization phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    dualpol_phase(slice_parms(
        out_root, have_h5py, "auto", "hera37_dualpol",
        array={"layout": "HERA-37", "redundant": True}, beam={"pol": "XY"},
        save_formats={"fmt": "fits", "npz": False, "uvfits": True}), cuda)
    torch.cuda.empty_cache()
    print("[dual polarization phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    config3_phase(os.path.join(out_root, "cfg3"), cuda)
    torch.cuda.empty_cache()
    print("[config #3 phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    config5_phase(cuda)
    torch.cuda.empty_cache()
    print("[config #5 phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    chunked_phase(os.path.join(out_root, "chunks"), cuda, have_h5py)
    torch.cuda.empty_cache()
    print("[chunked runs and diagnosis phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    mesh = mesh_phase(out_root, cuda, have_h5py)
    torch.cuda.empty_cache()
    print("[mesh phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    cfg4 = config4_phase(
        os.path.join(out_root, "cfg4"), cuda,
        os.path.join(out_root, "chip_smoke", "hera37_dualpol_polX",
                     "simdata", "simvis.fits"),
        [os.path.join(out_root, "chip_smoke"),
         os.path.join(out_root, "cfg4", "hera331_feko")])
    torch.cuda.empty_cache()
    print("[config #4 and tools phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    ex = example_phase(out_root, cuda)
    torch.cuda.empty_cache()
    print("[example phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    srt = sorted_phase(out_root, cuda, have_h5py, k["v0"], ns)
    torch.cuda.empty_cache()
    print("[sorted route phase: %.2f s]" % (time.time() - t0))

    t0 = time.time()
    smesh = sorted_mesh_phase(out_root, cuda, have_h5py)
    torch.cuda.empty_cache()
    print("[sorted mesh phase: %.2f s]" % (time.time() - t0))
    t0 = time.time()
    nsr = northstar_run_phase(os.path.join(out_root, "northstar_run"), cuda)
    torch.cuda.empty_cache()
    print("[north-star run phase: %.2f s]" % (time.time() - t0))
    k1a_launches += (mesh["k1a"] + cfg4["k1a"] + ex["k1a"] + srt["k1a"]
                     + smesh["k1a"] + nsr["k1a"])
    k2_launches += mesh["k2"] + cfg4["k2"] + ex["k2"] + nsr["k2"]
    spread_launches = srt["launches"] + smesh["spread"]

    print(smi)
    for label, ms, bd in (
            ("K1a, slice snapshot", k["ms"], k),
            ("K1a, north-star launch", ns["k1a_ms"], ns["k1a_bound"]),
            ("K1b, slice snapshot", k1b["ms"], k1b),
            ("K1b, north-star snapshot", ns_k1b["ms"], ns_k1b),
            ("K1c, slice snapshot", k1c["ms"], k1c),
            ("K1c, north-star DSM snapshot", ns_k1c["ms"], ns_k1c),
            ("K2, slice snapshot", k2["ms"], k2),
            ("K2, north-star snapshot", ns["k2_ms"], ns["k2_bound"]),
            ("banded_prep, slice snapshot", prep_sl["ms"], prep_sl),
            ("banded_prep, north-star snapshot", prep_ns["ms"], prep_ns),
            ("delay_spread, slice snapshot", srt["ms"], srt),
            ("delay_spread, north-star snapshot", srt["ns_ms"],
             srt["ns_bound"])) + tuple(
            ("airy_amps, %d x %d table" % a["shape"], a["ms"], a)
            for a in airy["shapes"]) + tuple(
            ("phase_cubes, %d x %d x %d cubes" % f["shape"], f["ms"], f)
            for f in fin["shapes"]):
        print("roofline share of %s: bound %.4f ms (%s) / %.4f ms = %.4f, "
              "against the data-sheet peaks (FP64 %.0f TFLOP/s, FP64 tensor "
              "%.0f TFLOP/s, HBM %.2f TB/s), on %s"
              % (label, bd["bound_ms"], bd["bound_by"], ms,
                 bd["bound_ms"] / ms, FP64_FLOPS / 1e12, FP64_TC_FLOPS / 1e12,
                 HBM_BPS / 1e12, smi))

    def row(name, source, replaces, launches, nums):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=nums["max_abs_err"],
                    ms=nums["ms"], plain_ms=nums["plain_ms"],
                    bound_ms=nums["bound_ms"], bound_by=nums["bound_by"],
                    library_ms=None)

    print(json.dumps({"kernels": [
        row("nudft_k1a", cuda_nudft.KERNEL_SOURCE, cuda_nudft.TPU_KERNEL,
            k1a_launches, k),
        row("nudft_k1b", cuda_nudft.KERNEL_SOURCE, cuda_nudft.TPU_KERNEL_GRAD,
            k1b_launches, k1b),
        row("nudft_k1c", cuda_nudft.KERNEL_SOURCE, cuda_nudft.TPU_KERNEL_EXT,
            k1c_launches, k1c),
        row("banded_k2", cuda_banded.KERNEL_SOURCE, cuda_banded.TPU_KERNEL,
            k2_launches, k2),
        row("delay_spread", cuda_spread.KERNEL_SOURCE, cuda_spread.TPU_KERNEL,
            spread_launches, srt),
        # no TPU kernel: XLA fused the chain it replaces on the TPU
        row("airy_amps", cuda_beam.KERNEL_SOURCE, None, airy_launches,
            airy),
        row("banded_prep", cuda_prep.KERNEL_SOURCE, None, prep_launches,
            prep_ns),
        row("phase_cubes", cuda_finalize.KERNEL_SOURCE, None, fin_launches,
            fin)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
