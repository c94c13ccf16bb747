"""The port runs with jax, yaml and h5py all unavailable, as on a card
machine that has none of them: a subprocess blocks the three imports,
imports prisim_tpu_torch and runs a small simulation to NPZ, with the
direct engine and with the banded NUFFT engine."""

import os
import subprocess
import sys
import textwrap

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "yaml", "h5py"):
        sys.modules[name] = None
    import prisim_tpu_torch
    from prisim_tpu_torch import driver
    from prisim_tpu_torch.config import load_parms
    parms = load_parms({
        "dirstruct": {"rootdir": sys.argv[1], "simid": "nojax"},
        "telescope": {"id": "hera"},
        "array": {"layout": "HERA-7", "redundant": False},
        "bandpass": {"nchan": 8, "freq_resolution": 97656.25},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "usm", "nside": 4},
        "processing": {"engine": sys.argv[2]},
        "save_formats": {"fmt": "none", "npz": True}})
    vs, out = driver.run_simulation(parms, verbose=False, device="cpu")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "yaml", "h5py")
                    and sys.modules[m] is not None)
    print("LOADED", loaded)
    print("OUT", out)
""")


def _run_blocked(tmp_path, engine):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path),
                           engine], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("LOADED", "OUT")))
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
