"""The span recorder of the port (prisim_tpu_torch.tracing) on the CPU:
tiny run_simulation calls on the direct engine and the banded engine
(engine nufft, plain K2), their spans and counters, a demotion, the
recorder off, phase_timer, the diagnosis.jax_profile export, the launch
attribution of the spans file, and the driver's verbose phase lines,
which the benchmark's harness parses (gpubench/harness.py PHASE_LINE)."""

import contextlib
import io
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from prisim_tpu_torch import _build, diagnostics, tracing
from prisim_tpu_torch import driver as drv
from prisim_tpu_torch.config import load_parms
from prisim_tpu_torch.engine.observe import schedule_tensors, \
    snapshot_nudft_inputs

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N_ACC = 3
_SECTIONS = {
    "telescope": {"id": "custom"},
    "bandpass": {"nchan": 32, "freq": 150e6, "freq_resolution": 3.125e6},
    "array": {"layout": "HERA-7"},
    "obsparm": {"n_acc": N_ACC, "t_acc": 60.0},
    "skyparm": {"model": "random", "nsrc": 128, "seed": 5},
    "save_formats": {"fmt": "none", "npz": False},
}
CHILDREN = {"direct": ["beam_flux", "k1a"], "nufft": ["prep", "k2", "post"]}


def _parms(engine, tmp_path=None, **processing):
    sec = dict(_SECTIONS, processing=dict(engine=engine, **processing))
    if tmp_path is not None:
        sec["dirstruct"] = {"rootdir": str(tmp_path)}
    return load_parms(sec)


@pytest.fixture(autouse=True)
def _clean_recorder():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _recorded(parms):
    with tracing.on():
        vs, _ = drv.run_simulation(parms, verbose=False, save=False,
                                   device="cpu")
    return vs, tracing.take()


def _kids(records, rec):
    return [r for r in records if r["parent"] == rec["id"]]


def _subtree_count(records, rec, name):
    total, todo = 0, [rec]
    while todo:
        r = todo.pop()
        total += r["counts"].get(name, 0)
        todo.extend(_kids(records, r))
    return total


@pytest.fixture(scope="module", params=["direct", "nufft"])
def run(request):
    tracing.take()
    with tracing.on():
        vs, _ = drv.run_simulation(_parms(request.param), verbose=False,
                                   save=False, device="cpu")
    return request.param, vs, tracing.take()


def test_spans_nest_under_one_trace(run):
    engine, _, records = run
    roots = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in roots] == ["simulation"]
    root = roots[0]
    assert {r["trace"] for r in records} == {root["trace"]}
    by_id = {r["id"]: r for r in records}
    assert len(by_id) == len(records)
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
        if r is root:
            continue
        parent = by_id[r["parent"]]
        assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= parent["end_ns"]
    assert root["attrs"]["engine"] == {"direct": "direct",
                                       "nufft": "banded"}[engine]
    assert (root["attrs"]["nbl"], root["attrs"]["nchan"],
            root["attrs"]["n_acc"], root["attrs"]["nsrc"]) == (9, 32, N_ACC,
                                                              128)
    names = [r["name"] for r in _kids(records, root)]
    assert names == ["inputs", "visibilities", "finalize.noise",
                     "finalize.post"]
    inputs = by_id[next(r["id"] for r in records if r["name"] == "inputs")]
    assert [r["name"] for r in _kids(records, inputs)] == [
        "inputs.sky", "inputs.upload"]
    vis = next(r for r in records if r["name"] == "visibilities")
    want = (["plan", "gate"] if engine == "nufft" else []) + \
        ["snapshot"] * N_ACC
    assert [r["name"] for r in _kids(records, vis)] == want
    # the cube comes to the host in the finalize, which counts its
    # visibilities
    post = next(r for r in records if r["name"] == "finalize.post")
    assert [r["name"] for r in _kids(records, post)] == ["transfer"]
    assert post["counts"]["finalize.vis"] == 9 * 32 * N_ACC


def test_snapshot_spans_and_their_children(run):
    engine, _, records = run
    snaps = [r for r in records if r["name"] == "snapshot"]
    assert [s["attrs"]["t"] for s in snaps] == list(range(N_ACC))
    for s in snaps:
        assert [r["name"] for r in _kids(records, s)] == CHILDREN[engine]
        assert _subtree_count(records, s, "src.processed") > 0


def test_src_live_is_the_live_rows_at_each_lst(run):
    """src.live of each snapshot is the count of sources whose amplitude
    row is not all zero at that LST, on both engines (the banded engine's
    payload rows are zero exactly where the amplitudes are)."""
    engine, _, records = run
    parms = _parms(engine)
    sim = drv.prepare_simulation(parms, torch.device("cpu"))
    sched = schedule_tensors(sim.obs, sim.inst.latitude, sim.inst.device)
    snaps = [r for r in records if r["name"] == "snapshot"]
    for t, s in enumerate(snaps):
        _, _, amps, _ = snapshot_nudft_inputs(
            sim.inst, sim.sky, *(a[t] for a in sched), sim.beam_fn)
        want = int((amps != 0).any(1).sum())
        assert 0 < want < sim.sky.s_eq_hi.shape[0]
        assert _subtree_count(records, s, "src.live") == want
    if engine == "direct":
        for s in snaps:
            assert _subtree_count(records, s, "src.processed") == 128


def test_gate_failure_counts_one_demotion():
    """A gate forced to fail: one driver.demotions, in a zero-length span
    "demotion" that carries the reason, and the root records the engine
    the run took, the direct one."""
    _, records = _recorded(_parms("nufft", nufft_crosscheck_tol=1e-30))
    root = next(r for r in records if r["parent"] is None)
    assert root["attrs"]["engine"] == "direct"
    assert sum(r["counts"].get("driver.demotions", 0)
               for r in records) == 1
    (dem,) = [r for r in records if r["name"] == "demotion"]
    assert "cross-check FAILED" in dem["attrs"]["reason"]
    assert dem["counts"] == {"driver.demotions": 1}
    gate = next(r for r in records if r["id"] == dem["parent"])
    assert gate["name"] == "gate" and gate["error"] == "_EngineDemotion"
    assert len([r for r in records if r["name"] == "snapshot"]) == N_ACC


def test_sorted_route_spans():
    _, records = _recorded(_parms("nufft", nufft_spread="sorted"))
    root = next(r for r in records if r["parent"] is None)
    assert root["attrs"]["engine"] == "sorted"
    gate = next(r for r in records if r["name"] == "gate")
    assert [r["name"] for r in _kids(records, gate)] == ["beam_flux", "k1a"]
    block = next(r for r in records if r["name"] == "snapshots")
    assert [r["name"] for r in _kids(records, block)] == ["snapshot"] * N_ACC


def test_take_empties_the_recorder():
    _recorded(_parms("direct"))
    assert tracing.take() == []
    with tracing.on():
        for _ in range(tracing.MAX_TRACES + 2):
            with tracing.span("simulation"):
                pass
    got = tracing.take()
    assert len({r["trace"] for r in got}) == tracing.MAX_TRACES
    assert tracing.take() == []


def test_off_keeps_nothing(monkeypatch):
    """Off: span is the shared no-op, nothing is kept, no record_function
    opens and no counter is computed, through a whole run."""
    assert not tracing.recording()
    assert tracing.span("snapshot", t=0) is tracing.span("k2")
    assert tracing.span("x") is tracing._NOOP

    def opened(*a, **k):
        raise AssertionError("record_function opened")
    monkeypatch.setattr(tracing._profiler, "record_function", opened)
    calls = []
    monkeypatch.setattr(tracing, "count_device",
                        lambda *a: calls.append(a))
    for engine in CHILDREN:
        drv.run_simulation(_parms(engine), verbose=False, save=False,
                           device="cpu")
    assert calls == []
    assert tracing.take() == []


def test_counters_go_to_the_innermost_span():
    with tracing.on():
        with tracing.span("simulation"):
            tracing.count("a", 2)
            with tracing.span("inner", k=1) as sp:
                sp.set(m=2)
                tracing.count("a", 3)
                tracing.count_device("b", torch.tensor(4))
                tracing.count_device("b", torch.tensor([5], dtype=torch.int32))
    root, inner = tracing.take()
    assert root["counts"] == {"a": 2}
    assert inner["counts"] == {"a": 3, "b": 9}
    assert inner["attrs"] == {"k": 1, "m": 2}


def test_launch_deltas(monkeypatch):
    n = [0]
    monkeypatch.setitem(tracing._launch_counters, "fake", lambda: n[0])
    with tracing.on():
        with tracing.span("simulation"):
            with tracing.span("k"):
                n[0] += 3
            with tracing.span("none"):
                pass
    root, k, none = tracing.take()
    assert root["launches"]["fake"] == 3 and k["launches"]["fake"] == 3
    assert "fake" not in none["launches"]


def test_kernels_load_span(monkeypatch):
    def load(name):
        _build._INFO[name] = dict(path="x", seconds=0.0, built=True,
                                  report="")
        _build._LOADED[name] = lib = object()
        return lib
    monkeypatch.setattr(_build, "_load", load)
    monkeypatch.delitem(_build._LOADED, "fake", raising=False)
    with tracing.on():
        with tracing.span("simulation"):
            lib = _build.load_kernel_library("fake")
            assert _build.load_kernel_library("fake") is lib
    _build._LOADED.pop("fake")
    _build._INFO.pop("fake")
    _, load_span = tracing.take()
    assert load_span["name"] == "kernels.load"
    assert load_span["attrs"] == {"kernel": "fake", "built": True}


@pytest.mark.parametrize("sink", [[], {}])
def test_phase_timer_keeps_its_sink_and_print(sink, capsys):
    with diagnostics.phase_timer("stage1", sink, verbose=False):
        pass
    with diagnostics.phase_timer("stage1", sink, verbose=True):
        pass
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith(
        "[prisim_tpu_torch] stage1                   ")
    assert out[0].endswith(" s") and len(out[0]) == len(
        "[prisim_tpu_torch] %-24s %8.3f s" % ("stage1", 0.0))
    if isinstance(sink, list):
        assert [k for k, _ in sink] == ["stage1", "stage1"]
        assert all(dt >= 0 for _, dt in sink)
    else:
        assert list(sink) == ["stage1"] and sink["stage1"] >= 0
    with tracing.on():
        with diagnostics.phase_timer("stage2", None, verbose=False):
            pass
    (rec,) = tracing.take()
    assert rec["name"] == "stage2"


def test_phase_timer_times_a_failed_phase():
    sink = []
    with pytest.raises(KeyError):
        with diagnostics.phase_timer("bad", sink, verbose=False):
            raise KeyError("x")
    assert [k for k, _ in sink] == ["bad"]


def test_jax_profile_writes_the_spans(tmp_path):
    parms = _parms("nufft", tmp_path)
    prof = tmp_path / "prof"
    parms["diagnosis"]["jax_profile"] = str(prof)
    drv.run_simulation(parms, verbose=False, save=False, device="cpu")
    assert not tracing.recording()
    names = sorted(os.listdir(prof))
    assert [n.split("_")[0] for n in names] == ["spans", "trace"]
    with open(prof / names[0]) as f:
        got = json.load(f)
    assert got["trace_start_ns"] > 0
    spans = got["spans"]
    assert spans[0]["name"] == "simulation" and spans[0]["parent"] is None
    assert len([r for r in spans if r["name"] == "snapshot"]) == N_ACC
    assert all(r["kernel_ms"] == 0.0 for r in spans)     # no card
    assert tracing.take() == []
    with open(prof / names[1]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "prisim/snapshot" for e in events)


def test_plan_spans_and_counters_in_the_spans_file(tmp_path):
    """A truth-amps banded run (HERA dish, power-law sky) writes the plan's
    four spans and its two counters to its spans file: plan.grid and
    plan.fns under plan, plan.sort and plan.nodes under plan.fns; every
    source ordered, none of them by a card."""
    parms = _parms("nufft", tmp_path)
    parms["telescope"]["id"] = "hera"
    prof = tmp_path / "prof"
    parms["diagnosis"]["jax_profile"] = str(prof)
    drv.run_simulation(parms, verbose=False, save=False, device="cpu")
    name = next(n for n in os.listdir(prof) if n.startswith("spans"))
    with open(prof / name) as f:
        spans = json.load(f)["spans"]
    plan = next(r for r in spans if r["name"] == "plan")
    assert [r["name"] for r in _kids(spans, plan)] == ["plan.grid",
                                                       "plan.fns"]
    fns = next(r for r in spans if r["name"] == "plan.fns")
    assert [r["name"] for r in _kids(spans, fns)] == ["plan.sort",
                                                      "plan.nodes"]
    assert _subtree_count(spans, plan, "plan.src") == 128
    assert fns["counts"] == {"plan.src": 128, "plan.src_card": 0}


def _kineto(events):
    """A finished profiler holding these kineto events."""
    from torch.autograd import DeviceType
    evs = []
    for dev, name, corr, start, dur, ann in events:
        evs.append(SimpleNamespace(
            device_type=lambda d=dev: getattr(DeviceType, d),
            name=lambda n=name: n, correlation_id=lambda c=corr: c,
            start_ns=lambda s=start: s, duration_ns=lambda d=dur: d,
            is_user_annotation=lambda a=ann: a))
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


def test_kernel_ms_follow_the_launch_not_the_device_clock():
    """A kernel launched inside a span counts for that span and its
    parents even when the card runs it after the span closed; one launched
    after it, for the parent alone; annotations count for none."""
    recs = [dict(id=1, parent=None, start_ns=0, end_ns=1000),
            dict(id=2, parent=1, start_ns=100, end_ns=200),
            dict(id=3, parent=1, start_ns=300, end_ns=400)]
    prof = _kineto([
        ("CPU", "cudaLaunchKernel", 7, 150, 5, False),
        ("CUDA", "late_kernel", 7, 900, 2_000_000, False),
        ("CPU", "cudaLaunchKernel", 8, 250, 5, False),
        ("CUDA", "between", 8, 260, 1_000_000, False),
        ("CUDA", "prisim/x", 9, 120, 5_000_000, True),
        ("CPU", "aten::add", 8, 10, 1, False),
    ])
    got = tracing.kernel_ms_by_span(prof, recs)
    assert got == {1: 3.0, 2: 2.0}


CASES = {
    "direct": (_parms("direct"), False,
               ["inputs built and on cpu",
                "visibilities computed + transferred", "Tsys, rms and noise",
                "gains, container, phasing, projection"]),
    "banded": (_parms("nufft"), False,
               ["inputs built and on cpu", "banded shared-amps gate",
                "visibilities computed + transferred", "Tsys, rms and noise",
                "gains, container, phasing, projection"]),
    "saved": (None, True,
              ["inputs built and on cpu",
               "visibilities computed + transferred", "Tsys, rms and noise",
               "gains, container, phasing, projection", "products saved"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("record", [False, True])
def test_verbose_phase_lines(case, record, tmp_path):
    """The driver's phase lines, printed by its spans as they close: each
    matches the harness's PHASE_LINE, in the order and with the labels
    the driver printed before the spans, the harness finds the keys it
    reads, and the run ends with its "done in" line."""
    from gpubench import harness as H
    parms, save, labels = CASES[case]
    if parms is None:
        parms = _parms("direct", tmp_path)
        parms["save_formats"]["fmt"] = "fits"
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            (tracing.on() if record else contextlib.nullcontext()):
        drv.run_simulation(parms, verbose=True, save=save, device="cpu")
    lines = out.getvalue().splitlines()
    got = [H.PHASE_LINE.match(line) for line in lines]
    assert [m.group(1) for m in got if m] == labels
    assert all(float(m.group(2)) >= 0 for m in got if m)
    assert not [line for line in lines if line.startswith(
        "[prisim_tpu_torch] ... ") and not H.PHASE_LINE.match(line)]
    assert lines[-1].startswith("[prisim_tpu_torch] done in ")
    spans = H.phase_spans([(float(i), line) for i, line in enumerate(lines)],
                          -1.0)
    keys = {"inputs", "vis", "noise", "post"} | (
        {"gate"} if case == "banded" else set())
    assert set(spans) == keys
