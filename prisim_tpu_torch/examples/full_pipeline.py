"""End-to-end example: simulate -> delay power spectrum -> closure phases
-> UVFITS round trip.

Counterpart of prisim_tpu/examples/full_pipeline.py, the workflow a user
of the reference drives via run_prisim.py and the DelaySpectrum /
ClosurePhase classes (PRISim's scripts/run_prisim.py,
prisim/delay_spectrum.py:3260, prisim/bispectrum_phase.py:1497):

    python -m prisim_tpu_torch.examples.full_pipeline [outdir] [--device cpu]

The parameters are PARMS, equal to the reference's
examples/simparms/hera19_random.yaml as its load_parms reads it, so the
example needs no pyyaml. Its products are the native FITS product (with
the NPZ export) and UVFITS, not HDF5 and UVH5, and the delay power
spectrum is written only where h5py imports: everything runs on a
machine without h5py. On a CUDA card the simulation runs the banded
engine (K2, gated against K1a) and the analysis its torch code on the
card; device="cpu" runs the plain versions (a few seconds).
"""

from __future__ import annotations

import copy
import os
import tempfile

import numpy as np

# examples/simparms/hera19_random.yaml of the reference, as a dict
PARMS = {
    "dirstruct": {"rootdir": "./", "project": "hera19_example"},
    "telescope": {"id": "hera", "latitude": -30.7224, "longitude": 21.4278,
                  "A_eff": 154.0, "eff_Q": 0.96, "Trx": 100.0,
                  "Tant_ref": 200.0, "Tant_freqref": 150000000.0,
                  "Tant_spindex": -2.55},
    "array": {"layout": "HERA-19", "redundant": True},
    "antenna": {"shape": "dish", "size": 14.0},
    "bandpass": {"freq": 155000000.0, "freq_resolution": 97656.25,
                 "nchan": 64},
    "obsparm": {"obs_mode": "drift", "n_acc": 4, "t_acc": 60.0},
    "pointing": {"lst_init": 2.0},
    "skyparm": {"model": "random", "nsrc": 128, "seed": 42,
                "flux_min": 1.0, "flux_max": 50.0},
    "save_formats": {"fmt": "HDF5", "npz": True, "uvfits": True,
                     "uvh5": True},
}

# the UVFITS round trip, max|dV| / max|V|: the exported cube is complex64
# as written (the reference's bar)
ROUND_TRIP_BAR = 1e-5


def main(outdir=None, verbose=True, device="cuda"):
    from prisim_tpu_torch import config, driver, tools
    from prisim_tpu_torch.analysis.closure import closure_phases_vs
    from prisim_tpu_torch.io import load_fits
    from prisim_tpu_torch.io.hdf5 import h5py
    from prisim_tpu_torch.io.uvfits import load_uvfits

    if outdir is None:
        outdir = tempfile.mkdtemp(prefix="prisim_tpu_torch_example_")
    parms = config.load_parms(copy.deepcopy(PARMS))
    parms["dirstruct"]["rootdir"] = outdir
    parms["dirstruct"]["project"] = "full_pipeline"
    # native FITS + UVFITS in place of HDF5 + UVH5: no h5py needed
    parms["save_formats"].update(fmt="fits", uvh5=False)

    # 1. simulate (noiseless sky visibilities + thermal noise, all
    #    products written under <rootdir>/<project>/<simid>/)
    vs, simdir = driver.run_simulation(parms, verbose=verbose,
                                       device=device)
    base = os.path.join(simdir, "simdata", "simvis")
    sim_fits = base + ".fits"
    if verbose:
        print("simulated %d baselines x %d channels x %d accumulations"
              % (vs.nbl, vs.nchan, vs.n_acc))
        print("products:", sorted(os.listdir(os.path.dirname(base))))

    # 2. delay power spectrum in K^2 (Mpc/h)^3 (one command; CLEANs the
    #    foregrounds and normalizes with the analytic HERA beam volume)
    dps_path = os.path.join(outdir, "dps.hdf5") if h5py is not None \
        else None
    dps = tools.delay_ps(sim_fits, dps_path, nside_beam=16, clean=True,
                         maxiter=50, device=device)
    if verbose:
        kp = np.asarray(dps["kprll"])
        pk = np.asarray(dps["skyvis"])       # (nbl, nlag, nacc)
        print("delay PS: z=%.2f, k_parallel in [%.3f, %.3f] h/Mpc, "
              "peak P(k)=%.3e K^2 (Mpc/h)^3%s"
              % (dps["z"], kp.min(), kp.max(), pk.max(),
                 "" if dps_path else " (not written: no h5py)"))

    # 3. closure phases on all unique antenna triads
    sim = load_fits(sim_fits)
    cl = closure_phases_vs(sim)                 # unique triads by default
    cp = np.asarray(cl["closure_phase_skyvis"])  # (ntri, nchan, nacc)
    if verbose:
        print("closure phases: %d unique triads, rms %.3f rad"
              % (len(cl["triads"]), float(np.std(cp))))

    # 4. round-trip check through the UVFITS export: it expands the unique
    # baselines onto the full redundant set (save_redundant) and writes
    # the noiseless cube, so rows are matched by antenna-pair label and
    # compared with skyvis
    back = load_uvfits(base + ".uvfits")
    sent = np.asarray(sim.skyvis)
    where = {tuple(p): i
             for i, p in enumerate(np.asarray(back.labels, dtype=str))}
    rows = [where[tuple(p)] for p in np.asarray(sim.labels, dtype=str)]
    got = np.asarray(back.skyvis)[rows]
    resid = np.max(np.abs(got - sent))
    rel = resid / np.max(np.abs(sent))
    if verbose:
        print("UVFITS round trip: max |dV| = %.2e (%.1e relative)"
              % (resid, rel))
    if not rel < ROUND_TRIP_BAR:
        raise RuntimeError("UVFITS round trip off by %.2e of max|V|" % rel)
    return dict(vs=vs, simdir=simdir, dps=dps, closure=cp, outdir=outdir,
                round_trip=rel)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        prog="prisim_tpu_torch.examples.full_pipeline")
    ap.add_argument("outdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (raises without a card) or 'cpu'")
    args = ap.parse_args()
    main(args.outdir, device=args.device)
