"""A cell that writes its product: the native FITS product read back by
the benchmark's own reader (gpubench/reference/products.py) against the
program's reader, the run judged by the files, the product faults caught
from the file while the returned sets stay right, and no product left
behind after a run, whole or failed. On the CPU at a tiny size."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench import faults
from gpubench import harness as H
from gpubench.reference import check as C
from gpubench.reference import products
from gpubench.reference.model import DriftReference

from conftest import tiny

SEED = 2 ** 31 + 91
# the schema stores the noise rms as float32 (io/fitsnative.py), so the
# rms read back is the program's float64 rms rounded to float32: within
# 2^-24 of it relatively; one float32 ulp, 2^-23, is this test cell's
# limit in place of the in-memory cells' 1e-10
RMS_READ_BACK = 2.0 ** -23


def product_cell(**kw):
    """hera37.direct cut to the CPU, writing its native FITS product."""
    cell, config = tiny("hera37.direct", **kw)
    cell = dict(cell, product={"fmt": "fits"},
                limits=dict(cell["limits"], rms_err=RMS_READ_BACK))
    return cell, config


def _written(tmp_path, lst=5.5, seed=11):
    """(sections, the returned VisibilitySet, the product's path) of one
    simulation of the product cell."""
    from prisim_tpu_torch.config import load_parms
    cell, config = product_cell()
    sec = H.cell_sections(cell, config, lst, seed)
    assert sec["save_formats"] == {"fmt": "fits", "npz": False}
    vs, rec = H.simulate(load_parms(sec), torch.device("cpu"), tmp_path)
    assert rec["error"] is None and "write" in rec["spans"]
    return cell, sec, vs, H.product_file(tmp_path)


def test_reader_against_the_programs_reader(tmp_path):
    """Every array the check reads, as products.read_sample reads it and as
    keep_sample takes it from prisim_tpu_torch.io.fitsnative.load_fits's
    set of the same file, bit for bit; and the returned set's, but for the
    rms, which the file holds in float32."""
    from prisim_tpu_torch.io.fitsnative import load_fits
    cell, sec, vs, path = _written(tmp_path)
    ref = DriftReference(sec)
    idx = C.sample_indices(ref, np.random.default_rng(3), cell["sample"])
    got = products.read_sample(path, idx)
    fl = load_fits(str(path))
    want = C.keep_sample(SimpleNamespace(
        skyvis=fl.skyvis.astype(np.complex64),
        vis=fl.vis.astype(np.complex64),
        vis_noise=fl.vis_noise.astype(np.complex64),
        projected_baselines=fl.projected_baselines, vis_rms=fl.vis_rms,
        lst=fl.lst), idx)
    memory = C.keep_sample(vs, idx)
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
        if k != "rms":
            assert np.array_equal(a, np.asarray(memory[k])), k
    assert not np.array_equal(got["rms"], memory["rms"])
    np.testing.assert_allclose(got["rms"], memory["rms"], rtol=2.0 ** -24,
                               atol=0)
    # the same readings but the rms's
    read, mem = C.readings(got, ref, 5.5, idx), C.readings(memory, ref, 5.5,
                                                           idx)
    assert {k: v for k, v in read.items() if k != "rms_err"} == \
        {k: v for k, v in mem.items() if k != "rms_err"}
    assert 0 < read["rms_err"] <= RMS_READ_BACK


def test_reader_imports_nothing_of_the_program():
    src = Path(products.__file__).read_text()
    assert "prisim_tpu" not in src and "jax" not in src
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         "from gpubench.reference import products;"
         "import json; print(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))",
         str(H.ROOT)], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout))
    assert not top & {"prisim_tpu_torch", "prisim_tpu", "jax", "torch"}


@pytest.mark.parametrize("damage", ["missing", "truncated", "not_fits",
                                    "no_sky"])
def test_an_unreadable_product_reads_inf(tmp_path, damage):
    """A product that is missing, cut short, not FITS, or lacks a cube the
    check reads gives the inf readings of a sample of the wrong shape."""
    cell, sec, vs, path = _written(tmp_path / "p")
    data = path.read_bytes()
    bad = tmp_path / "bad.fits"
    if damage == "truncated":
        bad.write_bytes(data[:len(data) - 3 * 2880])
    elif damage == "not_fits":
        bad.write_bytes(b"\x00" * 2880)
    elif damage == "no_sky":
        bad.write_bytes(data.replace(b"real_freq_sky_visibility",
                                     b"real_freq_sky_vXsibility"))
    ref = DriftReference(sec)
    idx = C.sample_indices(ref, np.random.default_rng(3), cell["sample"])
    with pytest.raises((OSError, ValueError)):
        products.read_sample(bad, idx)
    got = H.judged(bad, ref, 5.5, idx, open(os.devnull, "w"))
    assert got == dict.fromkeys(C.NUMBERS, float("inf"))
    assert not C.judge(got, cell["limits"])


def _run(cell, config, fault="none", seconds=1.0):
    """run_cell with `fault` planted, and the sets that run_simulation
    returned to the harness in its window (the warm one left out)."""
    returned = []
    inner = H.simulate

    def keep(parms, device, outdir=None):
        vs, rec = inner(parms, device, outdir)
        if vs is not None and parms["obsparm"]["n_acc"] == cell["n_acc"]:
            returned.append((float(parms["pointing"]["lst_init"]), vs))
        return vs, rec
    undo = faults.plant(fault)
    H.simulate = keep
    try:
        res = H.run_cell(cell, config, SEED, seconds, False, device="cpu",
                         log=open(os.devnull, "w"))
    finally:
        H.simulate = inner
        undo()
    return res, returned


def test_a_clean_product_run_is_correct_and_leaves_nothing():
    cell, config = product_cell()
    res, returned = _run(cell, config)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 2 and len(returned) == res["attempted"]
    assert 0 < res["checks"]["rms_err"]["value"] <= RMS_READ_BACK
    assert not H.products_dir().exists()


@pytest.mark.parametrize("fault,fails", [("product_sky_zeroed", "vis_err"),
                                         ("product_stale", "lst_err")])
def test_product_faults_fail_from_the_file(fault, fails):
    """The faulted run is not correct, by the number the fault moves, while
    every set that run_simulation returned in the same run passes the
    cell's limits: the failure comes from the file read back."""
    cell, config = product_cell()
    res, returned = _run(cell, config, fault)
    checks = res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert not res["correct"], checks
    assert np.isfinite(checks[fails]["value"])
    assert checks[fails]["value"] > checks[fails]["limit"], checks
    ref = DriftReference(H.cell_sections(cell, config, 0.0, SEED))
    idx = C.sample_indices(ref, np.random.default_rng(0), cell["sample"])
    for lst, vs in returned:
        got = C.readings(C.keep_sample(vs, idx), ref, lst, idx)
        assert C.judge(got, cell["limits"]), got
    assert not H.products_dir().exists()


def test_products_removed_after_failures(monkeypatch):
    """A simulation that raises after it wrote, a warm simulation that
    fails, and a check that raises: build/products/<pid> is gone each
    time."""
    from prisim_tpu_torch import driver
    cell, config = product_cell()
    inner = driver._save_products
    calls = []

    def save(vs, parms, outdir=None):
        out = inner(vs, parms, outdir)
        calls.append(outdir)
        if len(calls) == 3:
            raise OSError("disk full")
        return out
    monkeypatch.setattr(driver, "_save_products", save)
    res = H.run_cell(cell, config, SEED, 1.0, False, device="cpu",
                     log=open(os.devnull, "w"))
    assert res["failed"] == 1 and res["correct"], res["checks"]
    assert len(calls) >= 3 and not H.products_dir().exists()

    def broken(*a, **k):
        raise RuntimeError("no engine")
    monkeypatch.setattr(driver, "_save_products", inner)
    monkeypatch.setattr(driver, "simulate_drift", broken)
    assert H.run_cell(cell, config, SEED, 0.3, False, device="cpu",
                      log=open(os.devnull, "w")) is None
    assert not H.products_dir().exists()

    monkeypatch.undo()
    monkeypatch.setattr(H, "reference_class", broken)
    with pytest.raises(RuntimeError):
        H.run_cell(cell, config, SEED, 0.3, False, device="cpu",
                   log=open(os.devnull, "w"))
    assert not H.products_dir().exists()


def test_calibrate_reads_the_file():
    """calibrate.py on a product cell: each seed's readings of the file,
    beside those of the returned set; the stale product caught from the
    second fault seed on; the files removed."""
    from gpubench import calibrate
    cell, config = product_cell(nchan=64)
    rows = list(calibrate.calibrate(
        cell, config, [2 ** 33 + 1, 7], 1, "cpu", n_phase32=0,
        fault_names=["product_stale"], n_fault=2,
        log=open(os.devnull, "w")))
    assert [r["fault"] for r in rows] == [None, None, "product_stale",
                                          "product_stale"]
    lim = cell["limits"]
    for r in rows:
        assert r["product_bytes"] > 0 and r["write_s"] >= 0
        assert C.judge(r["memory"], lim)
    assert C.judge(rows[0]["readings"], lim)
    assert rows[0]["memory"]["rms_err"] < rows[0]["readings"]["rms_err"]
    assert not C.judge(rows[0]["control"], lim)
    assert "control" not in rows[1] and "phase32" not in rows[0]
    assert C.judge(rows[2]["readings"], lim)
    assert rows[3]["readings"]["lst_err"] > lim["lst_err"]
    assert not H.products_dir().exists()
