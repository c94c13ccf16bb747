"""The harness: cells, configurations and metrics by name, BENCHMARK.json
against the files, the bound arithmetic, and the guarantees of run.py."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpubench import harness as H
from gpubench import peaks
from gpubench.reference.check import NUMBERS

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_names_its_files():
    assert BENCH["paths"] == ["gpubench"]
    assert {c["name"] for c in BENCH["configs"]} == \
        {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        cfg = H.load_config(c["name"])
        assert c["file"] == "gpubench/configs/%s.json" % c["name"]
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = H.load_workload(w["name"])
        for key in ("name", "config", "traffic", "chips", "why"):
            assert cell[key] == w[key], key
        assert set(cell["limits"]) == set(NUMBERS)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_modules_by_name(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = H.load_metric(metric)
    assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
        entry["unit"], entry["source"], entry["moves"], entry["layer"])
    assert callable(mod.read)


def test_entries_of_a_cell():
    e2e, per_layer = H.benchmark_entries("hera37.direct")
    assert e2e == ["vis_rate", "peak_gb", "setup_s"]
    assert "k1a_roofline" in per_layer and "k2_roofline" not in per_layer
    assert "gate_s" not in per_layer
    _, banded = H.benchmark_entries("hera331.banded")
    assert "k2_roofline" in banded and "gate_s" in banded


def test_bound_arithmetic_against_hand_counts():
    k1a = H.load_metric("k1a_roofline")
    # 24,576 live of 49,152 sources x 666 bl x 1024 ch: 10 ops a term at
    # 34 TFLOP/s = 4.9295 ms (chip_smoke.py's slice count, PERF.md)
    t = k1a.snapshot_bound_s(24576, 49152, 666, 1024)
    assert t == pytest.approx(10 * 24576 * 666 * 1024 / 34e12, rel=1e-12)
    assert t == pytest.approx(4.9295e-3, rel=1e-4)
    k2 = H.load_metric("k2_roofline")
    plan = dict(rank=32, K=9, ndir=384, nbl=630, R_max=840, n_chunks=3,
                src_chunk=262144, truth=True)
    # 393,216 live x 630 = 247,726,080 pairs x 2r(2K+1) = 1,216 ops at 67
    # TFLOP/s = 4.4960 ms (PERF.md's north-star K2 bound)
    t2 = k2.snapshot_bound_s(393216, plan)
    assert t2 == pytest.approx(247726080 * 1216 / 67e12, rel=1e-12)
    assert t2 == pytest.approx(4.4960e-3, rel=1e-4)
    # bytes bound when there are few operations
    assert peaks.bound_s(1.0, 3.35e12, 67e12) == pytest.approx(1.0)


def test_phase_spans_from_timed_lines():
    p = "[prisim_tpu_torch] ... "
    lines = [(1.0, "[prisim_tpu_torch] 7 bl x 8 chan"),
             (1.5, p + "inputs built and on cpu (0.50 s)"),
             (1.6, "[prisim_tpu_torch] banded NUFFT: 7 bl -> 3 swept"),
             (2.1, p + "banded shared-amps gate (0.50 s)"),
             (4.0, p + "visibilities computed + transferred (2.50 s)"),
             (4.5, p + "Tsys, rms and noise (0.50 s)"),
             (5.5, p + "gains, container, phasing, projection (1.00 s)")]
    spans = H.phase_spans(lines, 0.9)
    assert spans["inputs"][0][2] == pytest.approx(0.6)
    assert spans["gate"][0][2] == pytest.approx(0.5)
    assert spans["vis"][0][2] == pytest.approx(2.5)
    assert spans["noise"][0][2] == pytest.approx(0.5)
    assert spans["post"][0][2] == pytest.approx(1.0)
    assert H.engine_of("\n".join(l for _, l in lines)) == "banded"


def _run_py(cwd, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "gpubench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


ARGS = ("--workload", "hera37.direct", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0")


def test_run_exits_nonzero_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = _run_py(ROOT, *ARGS)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    """A directory that holds BENCHMARK.json and gpubench/ alone: the
    program is missing, so no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path, *ARGS)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


IMPORTS = r'''
import json, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + "/gpubench/tests")
import runpy
run = runpy.run_path(sys.argv[1] + "/gpubench/run.py", run_name="gpubench_run")
from gpubench import harness as H
from conftest import tiny
cell, config = tiny("hera331.banded", engine="nufft")
e2e, per_layer = H.benchmark_entries("hera331.banded")
res = H.run_cell(cell, config, 5, 0.5, True, device="cpu",
                 per_layer=per_layer, end_to_end=e2e, log=open("/dev/null", "w"))
for name in per_layer:
    H.load_metric(name)
print(json.dumps(dict(correct=res["correct"],
                      top=sorted({m.split(".")[0] for m in sys.modules}))))
'''


def test_nothing_run_loads_is_jax_or_the_jax_package(tmp_path):
    """Every module that run.py, the harness, a traced run and the metric
    readers load, by top-level name compared whole: prisim_tpu_torch
    begins with prisim_tpu and is the port."""
    script = tmp_path / "imports.py"
    script.write_text(IMPORTS)
    out = subprocess.run([sys.executable, str(script), str(ROOT)],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    top = set(got["top"])
    assert "prisim_tpu_torch" in top and "gpubench" in top
    assert not top & set(H.FORBIDDEN), top & set(H.FORBIDDEN)


ACCEPTED = ("hera331.banded", "hera37.direct", "hera331.direct",
            "hera331.sorted")


def _sections_as_built_before(cell, config, lst_hours, seed, n_acc=None):
    """cell_sections as the harness built them before a cell could write
    its product: every accepted cell must still get exactly these."""
    import copy
    s = copy.deepcopy(config["sections"])
    s["obsparm"]["n_acc"] = int(n_acc or cell["n_acc"])
    s["pointing"]["lst_init"] = float(lst_hours)
    s.setdefault("processing", {})["engine"] = cell["engine"]
    s["skyparm"]["seed"] = int(seed)
    s["save_formats"] = {"fmt": "none", "npz": False}
    return s


@pytest.mark.parametrize("name", ACCEPTED)
def test_accepted_cells_run_what_they_ran(name):
    """Each accepted cell: the same sections, the same reference, no
    product, and run_simulation called without an outdir and with
    save=False."""
    cell = H.load_workload(name)
    config = H.load_config(cell["config"])
    assert "product" not in cell and "reference_class" not in config
    assert {w["name"] for w in BENCH["workloads"]} == set(ACCEPTED)
    for lst, seed, n_acc in ((0.0, 1, None), (17.25, 2 ** 33 + 5, 1),
                             (23.9, 7, None)):
        assert H.cell_sections(cell, config, lst, seed, n_acc) == \
            _sections_as_built_before(cell, config, lst, seed, n_acc)
    from gpubench.reference.model import DriftReference
    assert H.reference_class(config) is DriftReference
    assert H.sim_dir(cell, 0) is None and H.product_format(cell) is None


def test_simulate_without_a_product_calls_run_simulation_as_before(
        monkeypatch):
    from prisim_tpu_torch import driver
    calls = []

    def spy(*a, **k):
        calls.append((a, k))
        return None, None
    monkeypatch.setattr(driver, "run_simulation", spy)
    vs, rec = H.simulate({"x": 1}, "cpu")
    assert calls == [(({"x": 1},), dict(save=False, verbose=True,
                                        device="cpu"))]
    assert rec["error"] is None and rec["outdir"] is None
    H.simulate({"x": 1}, "cpu", Path("/nowhere"))
    assert calls[-1] == (({"x": 1},), dict(outdir="/nowhere", save=True,
                                           verbose=True, device="cpu"))


def test_a_cell_without_a_product_writes_none(monkeypatch):
    """A whole run of an accepted cell, cut to the CPU: every call of
    run_simulation (the warm one too) with save=False and no outdir."""
    from prisim_tpu_torch import driver
    from conftest import tiny
    inner = driver.run_simulation
    calls = []

    def spy(parms, *a, **k):
        calls.append((a, k))
        return inner(parms, *a, **k)
    monkeypatch.setattr(driver, "run_simulation", spy)
    cell, config = tiny("hera37.direct", n_acc=2)
    res = H.run_cell(cell, config, 3, 0.3, False, device="cpu",
                     log=open(os.devnull, "w"))
    assert res["correct"] and len(calls) == res["attempted"] + 1
    assert all(a == () and k == dict(save=False, verbose=True,
                                      device=torch.device("cpu"))
               for a, k in calls)


@pytest.mark.parametrize("product,reason", [
    ({"fmt": "npz"}, "no noise rms"), ({"fmt": "hdf5"}, "h5py"),
    ({"fmt": "HDF5"}, "h5py"), ({"fmt": "fits", "npz": True}, "only"),
    ({"fmt": "uvfits"}, "only"), ("fits", "only")])
def test_only_a_fits_product_is_written(product, reason):
    cell = dict(H.load_workload("hera37.direct"), product=product)
    config = H.load_config(cell["config"])
    with pytest.raises(SystemExit, match=reason):
        H.cell_sections(cell, config, 1.0, 1)
    cell["product"] = {"fmt": "fits"}
    assert H.cell_sections(cell, config, 1.0, 1)["save_formats"] == \
        {"fmt": "fits", "npz": False}
    assert H.sim_dir(cell, 4) == H.products_dir() / "sim4"
    assert H.products_dir().parent == ROOT / "build" / "products"


class StubReference:
    """A reference with the interface the harness reads, which counts the
    instances built: DriftReference's arithmetic under another class."""

    built = []

    def __init__(self, sections, device="cpu"):
        from gpubench.reference.model import DriftReference
        self._ref = DriftReference(sections, device=device)
        StubReference.built.append(sections)

    def __getattr__(self, name):
        return getattr(self._ref, name)


def test_a_configuration_names_its_reference(monkeypatch):
    """reference_class resolves "<module>.<Class>" of gpubench/reference/,
    and run_cell judges by the class it names."""
    import types
    from conftest import tiny
    mod = types.ModuleType("gpubench.reference.stub_for_test")
    mod.StubReference = StubReference
    monkeypatch.setitem(sys.modules, "gpubench.reference.stub_for_test", mod)
    cell, config = tiny("hera37.direct", n_acc=2)
    config = dict(config, reference_class="stub_for_test.StubReference")
    assert H.reference_class(config) is StubReference
    StubReference.built.clear()
    res = H.run_cell(cell, config, 5, 0.3, False, device="cpu",
                     log=open(os.devnull, "w"))
    assert res["correct"] and len(StubReference.built) == 1


@pytest.mark.parametrize("name", ["model.NoSuchReference", "nomodule.Ref",
                                  "DriftReference", "model.PRECISIONS",
                                  "../model.DriftReference",
                                  "model.DriftReference.x", ""])
def test_an_unknown_reference_stops_the_run(name):
    config = dict(H.load_config("hera37-nside128"), reference_class=name)
    with pytest.raises(SystemExit, match="hera37-nside128.*reference_class"):
        H.reference_class(config)


def test_write_phase_of_a_product_run():
    p = "[prisim_tpu_torch] ... "
    lines = [(1.5, p + "inputs built and on cpu (0.50 s)"),
             (4.0, p + "visibilities computed + transferred (2.50 s)"),
             (4.5, p + "Tsys, rms and noise (0.50 s)"),
             (5.5, p + "gains, container, phasing, projection (1.00 s)"),
             (7.0, p + "products saved (1.50 s)")]
    assert "write" not in H.phase_spans(lines, 1.0)
    spans = H.phase_spans(lines, 1.0, H.PRODUCT_PHASES)
    assert spans["write"] == [(5.5, 7.0, 1.5)]
    assert set(H.SHORT) >= set(H.PRODUCT_PHASES)


def test_span_metrics_list_the_accepted_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in ("inputs_s", "snap_ms", "finalize_s", "idle_share"):
        assert entries[name]["workloads"] == list(ACCEPTED), name
    for cell in ACCEPTED:
        _, per_layer = H.benchmark_entries(cell)
        assert {"inputs_s", "snap_ms", "finalize_s", "idle_share",
                "finalize_kernel_share"} <= set(per_layer)
    # a cell BENCHMARK.json does not list reports the metrics of no list
    assert H.benchmark_entries("no.such.cell")[1] == ["finalize_kernel_share"]
