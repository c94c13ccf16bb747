"""The port runs with jax, yaml, h5py and the JAX package prisim_tpu all
unavailable, as on a card machine that has none of the first three: a
subprocess blocks the four imports, imports every module of
prisim_tpu_torch and runs a small simulation to NPZ, with the direct
engine, with the banded NUFFT engine, with the sorted spread, as a
gradient run, on a DSM FITS
map that the port itself writes (extended sources), as a phased-array
track, in sky sectors, with an external FITS beam that the port writes,
and as a full-polarization run written to UVFITS and read back."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

BLOCKED = ("jax", "yaml", "h5py", "prisim_tpu")

SCRIPT = textwrap.dedent("""
    import sys
    for name in %r:
        sys.modules[name] = None
    import numpy as np
    import prisim_tpu_torch
    from prisim_tpu_torch import driver
    from prisim_tpu_torch.catalogs import write_dsm_fits
    from prisim_tpu_torch.config import load_parms
    root, mode = sys.argv[1], sys.argv[2]
    proc = {"engine": mode if mode in ("direct", "nufft") else "auto"}
    sky = {"model": "usm", "nside": 4}
    cat = {}
    if mode == "gradient":
        proc["gradient_mode"] = "baseline"
    if mode == "sorted":
        proc = {"engine": "nufft", "nufft_spread": "sorted"}
    if mode == "dsm":
        path = root + "/dsm.fits"
        write_dsm_fits(path, np.ones(12 * 4 * 4), -2.55)
        sky = {"model": "dsm", "nside": 4}
        cat = {"DSM_file_prefix": path}
    p = {
        "dirstruct": {"rootdir": root, "project": "proj", "simid": "nojax"},
        "telescope": {"id": "hera"},
        "array": {"layout": "HERA-7", "redundant": False},
        "bandpass": {"nchan": 8, "freq_resolution": 97656.25},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": sky, "catalog": cat, "processing": proc,
        "save_formats": {"fmt": "none", "npz": True}}
    if mode == "phased":
        p["telescope"] = {"id": "mwa"}
        p["antenna"] = {"shape": "dipole", "size": 0.74,
                        "phased_array": True}
        p["obsparm"] = {"n_acc": 2, "t_acc": 1800.0, "obs_mode": "track"}
        p["pointing"] = {"track_init": {"ra": 10.0, "dec": -30.0}}
    if mode == "sectors":
        proc["n_sky_sectors"] = 2
    if mode == "fullpol":
        p["beam"] = {"pol": "full"}
        p["save_formats"]["uvfits"] = True
    if mode == "external":
        from prisim_tpu_torch import healpix as hp
        from prisim_tpu_torch.io.fitsio import write_image
        theta, _ = hp.pix2ang(8, np.arange(hp.nside2npix(8)))
        path = root + "/beam.fits"
        with open(path, "wb") as fh:
            write_image(fh, np.exp(-(np.sin(theta) / 0.3) ** 2)[:, None],
                        primary=True)
        p["beam"] = {"use_external": True, "file": path}
    parms = load_parms(p)
    vs, out = driver.run_simulation(parms, verbose=False, device="cpu")
    if mode == "sectors":
        full = dict(parms, processing=dict(proc, n_sky_sectors=1))
        vf, _ = driver.run_simulation(full, verbose=False, save=False,
                                      device="cpu")
        tot = sum(v.skyvis for v in vs if v is not None)
        print("SECTORS", len(vs), float(abs(tot - vf.skyvis).max()
                                        / abs(vf.skyvis).max()))
        out = root + "/proj/nojax_sector0"
    if mode == "fullpol":
        import json, os
        from prisim_tpu_torch.io.fitsio import read_fits
        from prisim_tpu_torch.io.uvfits import load_uvfits
        xx, yy, xy = vs
        base = out + "/simdata/simvis"
        own = load_uvfits(base + ".uvfits")
        (g,) = [h for h in read_fits(base + "_fullpol.uvfits") if "pars" in h]
        d = g["data"].reshape(2, 21, 8, 4, 3)
        cubes = np.conj(d[..., 0] + 1j * d[..., 1]).transpose(1, 2, 3, 0)
        print("FULLPOL", json.dumps(dict(
            own=float(abs(own.skyvis - xx.skyvis).max()),
            combined=[float(abs(cubes[:, :, k] - v.skyvis).max())
                      for k, v in enumerate((xx, yy, xy, xy))],
            leak=float(abs(xy.skyvis).max() / abs(xx.skyvis).max()),
            uvh5=os.path.exists(base + "_fullpol.uvh5"))))
    if mode == "gradient":
        print("GRAD", vs.gradients["baseline"].shape)
    if mode == "dsm":
        sim = driver.prepare_simulation(parms, "cpu")
        print("SIGMA", sim.sky.src_shape_sigma.min().item())
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib") + %r
                    and sys.modules[m] is not None)
    print("LOADED", loaded)
    print("OUT", out)
""" % (BLOCKED, BLOCKED))


def _run_blocked(tmp_path, mode, lines_out=None):
    env = dict(os.environ, PYTHONPATH=ROOT)
    tmp_path.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path),
                           mode], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("LOADED", "OUT", "GRAD", "SIGMA",
                                     "SECTORS", "FULLPOL")))
    if lines_out is not None:
        lines_out.update(lines)
    assert lines["LOADED"] == "[]"
    out = lines["OUT"]
    with np.load(os.path.join(out, "simdata", "simvis.npz")) as d:
        sky = d["skyvis_freq"]
    assert sky.shape == (21, 8, 2) and np.isfinite(sky).all()
    assert np.abs(sky).max() > 0
    assert not os.path.exists(os.path.join(out, "simdata", "simvis.hdf5"))
    assert os.path.exists(os.path.join(out, "metainfo", "simparms.json"))
    return sky


def test_port_runs_without_jax_yaml_h5py(tmp_path):
    _run_blocked(tmp_path, "direct")


def test_port_runs_banded_engine_without_jax_yaml_h5py(tmp_path):
    """engine: nufft on the CPU: the plain version of kernel K2 behind the
    gate; agrees with the direct run (truth amps against the f32 beam,
    well inside 1e-4 of max|V|)."""
    sky = _run_blocked(tmp_path / "nufft", "nufft")
    direct = _run_blocked(tmp_path / "direct", "direct")
    assert np.abs(sky - direct).max() / np.abs(direct).max() < 1e-4


def test_port_runs_sorted_spread_without_jax_yaml_h5py(tmp_path):
    """engine: nufft with nufft_spread: sorted on the CPU: the plain version
    of kernel delay_spread behind the gate against the direct engine's
    snapshot 0; agrees with the direct run well inside the gate's 1e-4 of
    max|V|."""
    sky = _run_blocked(tmp_path / "sorted", "sorted")
    direct = _run_blocked(tmp_path / "direct", "direct")
    assert np.abs(sky - direct).max() / np.abs(direct).max() < 1e-4


def test_port_runs_gradient_without_jax_yaml_h5py(tmp_path):
    """processing.gradient_mode: the plain moments (the CPU path of K1b);
    the visibilities are the direct run's, bit for bit."""
    lines = {}
    sky = _run_blocked(tmp_path / "grad", "gradient", lines)
    assert lines["GRAD"] == "(3, 21, 8, 2)"
    np.testing.assert_array_equal(sky, _run_blocked(tmp_path / "direct",
                                                    "direct"))


def test_port_runs_dsm_fits_without_jax_yaml_h5py(tmp_path):
    """A DSM FITS map written and read by the port's jax-free FITS IO: every
    pixel gets the nside-4 pixel-resolution shape (sigma_uv ~ 3.4), so the
    run takes the plain gaussian weights (the CPU path of K1c), whatever
    the engine, and differs from the same sky without shapes."""
    lines = {}
    sky = _run_blocked(tmp_path / "dsm", "dsm", lines)
    sigma = float(lines["SIGMA"])
    assert 3.0 < sigma < 4.0
    usm = _run_blocked(tmp_path / "usm", "direct")
    assert np.abs(sky - usm).max() > 1e-3 * np.abs(usm).max()


def test_port_runs_beam_routes_without_jax_yaml_h5py(tmp_path):
    """A phased-array (MWA tile) track, two sky sectors (their sum is the
    full run) and an external FITS beam written by the port's
    write_image; each differs from the plain HERA run."""
    direct = _run_blocked(tmp_path / "direct", "direct")
    lines = {}
    runs = {mode: _run_blocked(tmp_path / mode, mode, lines)
            for mode in ("phased", "sectors", "external")}
    n, rel = lines["SECTORS"].split()
    assert int(n) == 2 and float(rel) < 2e-4
    for mode in ("phased", "external"):
        assert np.abs(runs[mode] - direct).max() > 1e-3 * np.abs(direct).max()


def test_port_runs_full_pol_uvfits_without_jax_yaml_h5py(tmp_path):
    """beam.pol: full with save_formats.uvfits: three component runs, each
    with its own UVFITS, and the combined 4-pol UVFITS; all read back with
    the port's jax-free FITS reader to the returned cubes, and no UVH5 is
    written (save_formats.uvh5 is off, and h5py is blocked)."""
    lines = {}
    _run_blocked(tmp_path, "fullpol", lines)
    got = json.loads(lines["FULLPOL"])
    assert got["own"] == 0.0
    assert got["combined"] == [0.0] * 4           # XX, YY, XY, YX
    assert 0.0 < got["leak"] < 1.0                # real leakage
    assert not got["uvh5"]


IMPORT_ALL = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in %r:
        sys.modules[name] = None
    import prisim_tpu_torch
    names = sorted(m.name for m in pkgutil.walk_packages(
        prisim_tpu_torch.__path__, "prisim_tpu_torch."))
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib") + %r
                    and sys.modules[m] is not None)
    print("MODULES", len(names))
    print("LOADED", leaked)
""" % (BLOCKED, BLOCKED))


def test_every_port_module_imports_without_prisim_tpu():
    """Every module of the port (the kernel wrappers and the copied host
    modules included) imports with jax and every prisim_tpu module
    blocked, and none of them is loaded afterwards."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines())
    assert lines["LOADED"] == "[]"
    assert int(lines["MODULES"]) >= 30


ANALYSIS = textwrap.dedent("""
    import json, os, sys
    for name in %r:
        sys.modules[name] = None
    import numpy as np
    from prisim_tpu_torch import driver, tools
    from prisim_tpu_torch.config import load_parms
    root = sys.argv[1]
    p = load_parms({
        "dirstruct": {"rootdir": root, "project": "proj", "simid": "ana"},
        "telescope": {"id": "hera", "Trx": 100.0},
        "array": {"layout": "HERA-7", "redundant": True},
        "bandpass": {"nchan": 16, "freq_resolution": 390625.0},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "usm", "nside": 4},
        "save_formats": {"fmt": "fits", "npz": False}})
    vs, out = driver.run_simulation(p, verbose=False, device="cpu")
    fits = os.path.join(out, "simdata", "simvis.fits")
    dps = tools.delay_ps(fits, None, nside_beam=4, clean=True, maxiter=50,
                         device="cpu")
    cpd = tools.closure_npz(fits, os.path.join(root, "cp.npz"))
    ps = tools.xcpdps(os.path.join(root, "cp.npz"), None)
    p["pp"]["n_chunks"] = 2
    p["dirstruct"]["simid"] = "chunks"
    p["processing"]["cleanup"] = 0
    v1, cdir = driver.run_simulation_chunked(p, verbose=False, device="cpu")
    part = os.path.join(cdir, "simdata", "_part_1.npz")
    os.remove(part)
    v2, _ = driver.run_simulation_chunked(p, verbose=False, device="cpu")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib") + %r
                    and sys.modules[m] is not None)
    print("ANALYSIS", json.dumps(dict(
        dps=sorted(dps), cc_shape=list(dps["cc_skyvis_ps"].shape),
        finite=bool(np.isfinite(dps["skyvis"]).all()),
        cp_shape=list(cpd.cp.shape), P_shape=list(ps["P"].shape),
        resumed=bool(os.path.exists(part)),
        same=bool(np.array_equal(v1.vis, v2.vis)),
        chunked_vs_single=float(np.abs(v1.skyvis - vs.skyvis).max()
                                / np.abs(vs.skyvis).max()),
        products=sorted(os.listdir(os.path.join(cdir, "simdata"))),
        meta=sorted(os.listdir(os.path.join(cdir, "metainfo"))))))
    print("LOADED", loaded)
""" % (BLOCKED, BLOCKED))


def test_port_analysis_and_chunked_runs_without_jax_yaml_h5py(tmp_path):
    """The analysis entry points and a chunked run with resume on a machine
    without jax, yaml or h5py: a HERA-7 redundant run saved as native FITS,
    delay_ps on it with CLEAN (product returned, nothing written),
    closure_npz to an NPZ and xcpdps on that, then a 2-chunk run whose
    part 1 is deleted and rebuilt, equal to the first merge and to the
    single-shot run; the chunk table is written as JSON."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", ANALYSIS, str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("ANALYSIS", "LOADED")))
    assert lines["LOADED"] == "[]"
    got = json.loads(lines["ANALYSIS"])
    assert {"skyvis", "vis", "noise", "cc_skyvis_ps", "res_skyvis_ps",
            "omega_bw"} <= set(got["dps"])
    assert got["cc_shape"] == [9, 16, 2] and got["finite"]
    assert got["cp_shape"][:2] == [2, 1] and got["cp_shape"][3] == 16
    assert got["P_shape"][0] == 1 and got["P_shape"][-1] == 32
    assert got["resumed"] and got["same"]
    assert got["chunked_vs_single"] < 2e-6
    assert got["products"] == ["_part_0.npz", "_part_1.npz", "simvis.fits"]
    assert "chunkinfo.json" in got["meta"]


MESH_TOOLS = textwrap.dedent("""
    import contextlib, io, json, os, sys
    for name in %r:
        sys.modules[name] = None
    import numpy as np
    from prisim_tpu_torch import altsim, driver, tools
    from prisim_tpu_torch.config import load_parms
    from prisim_tpu_torch.examples import full_pipeline
    root = sys.argv[1]

    def parms(simid, key, **proc):
        return load_parms({
            "dirstruct": {"rootdir": root, "project": "proj",
                          "simid": simid},
            "telescope": {"id": "hera"},
            "array": {"layout": "HERA-7", "redundant": True},
            "bandpass": {"nchan": 8, "freq_resolution": 97656.25},
            "obsparm": {"n_acc": 2, "t_acc": 60.0},
            "skyparm": {"model": "usm", "nside": 4},
            "pp": {"key": key}, "processing": proc,
            "save_formats": {"fmt": "fits", "npz": False}})

    one, _ = driver.run_simulation(parms("one", "none"), verbose=False,
                                   device="cpu")
    runs = {}
    for key, proc in (("freq", {}), ("bl", {}), ("src", {}),
                      ("freq", {"engine": "nufft"})):
        vs, _ = driver.run_simulation(
            parms(key + proc.get("engine", ""), key, **proc), verbose=False,
            devices=["cpu"] * 4)
        runs[key + proc.get("engine", "")] = float(
            abs(vs.skyvis - one.skyvis).max() / abs(one.skyvis).max())
    def output(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tools.main(argv)
        return buf.getvalue()

    listing = json.loads(output(["ls", os.path.join(root, "proj")]))
    grep = output(["grep", os.path.join(root, "proj"), "pp.key=bl"])
    ok = tools.mesh_check(4, device="cpu")
    fits = os.path.join(root, "proj", "one", "simdata", "simvis.fits")
    tools.update_noise(fits, os.path.join(root, "noisy.fits"), seed=1,
                       device="cpu")
    tools.expand_redundant_file(fits, os.path.join(root, "full.npz"))
    errors = []
    for call in (lambda: altsim.parms_to_pyuvsim(parms("x", "none"), root),
                 lambda: tools.convert(fits, os.path.join(root, "c"),
                                       ["hdf5"])):
        try:
            call()
        except ImportError as exc:
            errors.append(str(exc))
    ex = full_pipeline.main(os.path.join(root, "example"), verbose=False,
                            device="cpu")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib") + %r
                    and sys.modules[m] is not None)
    print("MESHTOOLS", json.dumps(dict(
        runs=runs, sims=listing["sims"], diffs=sorted(listing["diffs"]),
        grep=grep.split(), mesh_ok=ok,
        errors=errors, example=float(ex["round_trip"]),
        example_products=sorted(os.listdir(os.path.join(
            ex["simdir"], "simdata"))))))
    print("LOADED", loaded)
""" % (BLOCKED, BLOCKED))


def test_port_mesh_tools_and_example_without_jax_yaml_h5py(tmp_path):
    """A 4-entry CPU mesh through the driver (pp.key freq, bl, src and the
    banded engine's 'bl' mesh) against the single-device run (bl/chan
    shards bit for bit, src partial sums and the banded engine within
    2e-6 and 1e-4 of max|V|); tools.main ls and grep over the runs' JSON
    metadata; mesh_check; update_noise and expand_redundant_file on the
    FITS product; altsim and an HDF5 convert raise ImportError; the
    example runs to native FITS, NPZ and UVFITS with its round trip."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", MESH_TOOLS, str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("MESHTOOLS", "LOADED")))
    assert lines["LOADED"] == "[]"
    got = json.loads(lines["MESHTOOLS"])
    assert got["runs"]["freq"] == 0.0 and got["runs"]["bl"] == 0.0
    assert got["runs"]["src"] < 2e-6 and got["runs"]["freqnufft"] < 1e-4
    assert got["sims"] == ["bl", "freq", "freqnufft", "one", "src"]
    assert "pp.key" in got["diffs"] and got["grep"] == ["bl"]
    assert got["mesh_ok"] and len(got["errors"]) == 2
    assert "yaml" in got["errors"][0] and "h5py" in got["errors"][1]
    assert got["example"] < 1e-5
    assert got["example_products"] == ["simvis.fits", "simvis.npz",
                                       "simvis.uvfits"]
