"""The benchmark's readers of the program's spans and counters
(gpubench/spans.py, gpubench/metrics/{plan_s, prep_ms, k2_tiles,
snap_idle_share, live_src_share, noise_s, phasing_s, amps_kernel_share,
amps_roofline, spread_roofline, nufft_snap_ms, sort_ms, prep_kernel_share,
prep_roofline, finalize_kernel_share, write_s, write_gbps,
plan_card_share, payload_ms, gate_amps_s, beam_gevals, k2_item_share}.py)
on hand-built
records and a synthetic device trace, on a checkout without the recorder,
and in a traced tiny cell on the CPU, where the recorder keeps the
profiled simulation alone."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import harness as H  # noqa: E402
from gpubench import spans  # noqa: E402
from prisim_tpu_torch import tracing  # noqa: E402

NEW = ("plan_s", "prep_ms", "k2_tiles", "snap_idle_share", "live_src_share",
       "noise_s", "phasing_s")
MS = 1_000_000          # ns


def _rec(rid, parent, name, a_ms, b_ms, counts=None, device_ms=None,
         trace="t1"):
    r = dict(id=rid, parent=parent, name=name, trace=trace,
             start_ns=10_000 * MS + a_ms * MS, end_ns=10_000 * MS + b_ms * MS,
             attrs={}, counts=counts or {}, launches={})
    if device_ms is not None:
        r["device_ms"] = device_ms
    return r


def _banded():
    """A banded simulation: plan, a gate whose chunk has a prep, two
    snapshots of two source chunks each, the finalize."""
    recs = [_rec(1, None, "simulation", 0, 1000),
            _rec(2, 1, "inputs", 0, 100),
            _rec(3, 1, "visibilities", 100, 800),
            _rec(4, 3, "plan", 100, 350),
            _rec(5, 3, "gate", 350, 500),
            _rec(6, 5, "gate.chunk", 350, 500),
            _rec(7, 6, "prep", 350, 400, {"src.processed": 100},
                 device_ms=99.0),
            _rec(8, 6, "k2", 400, 450, {"src.live": 50}),
            _rec(9, 8, "k2.worklist", 410, 420, {"k2.tiles": 999})]
    rid = 10
    for t, a in enumerate((500, 650)):
        snap = rid
        recs.append(_rec(snap, 3, "snapshot", a, a + 100))
        rid += 1
        for c in range(2):
            recs.append(_rec(rid, snap, "prep", a + 40 * c, a + 40 * c + 20,
                             {"src.processed": 100}, device_ms=10.0 + t))
            recs.append(_rec(rid + 1, snap, "k2", a + 40 * c + 20,
                             a + 40 * c + 40, {"src.live": 40 + t}))
            recs.append(_rec(rid + 2, rid + 1, "k2.worklist", a + 40 * c + 30,
                             a + 40 * c + 31,
                             {"k2.tiles": 7 + t, "k2.items_live": 3}))
            rid += 3
        recs.append(_rec(rid, snap, "post", a + 80, a + 100))
        rid += 1
    recs += [_rec(rid, 3, "transfer", 800, 810),
             _rec(rid + 1, 1, "finalize.noise", 810, 900),
             _rec(rid + 2, 1, "finalize.post", 900, 1000)]
    return recs


def _direct():
    recs = [_rec(1, None, "simulation", 0, 100),
            _rec(2, 1, "visibilities", 0, 80)]
    for t in range(2):
        recs += [_rec(3 + 3 * t, 2, "snapshot", 10 + 30 * t, 30 + 30 * t),
                 _rec(4 + 3 * t, 3 + 3 * t, "beam_flux", 10 + 30 * t,
                      20 + 30 * t, {"src.processed": 200}),
                 _rec(5 + 3 * t, 3 + 3 * t, "k1a", 20 + 30 * t, 30 + 30 * t,
                      {"src.live": 90 + 20 * t})]
    recs += [_rec(9, 1, "finalize.noise", 80, 90),
             _rec(10, 1, "finalize.post", 90, 100)]
    return recs


def _device(busy_ms):
    """A DeviceTrace's fields: busy intervals on the host clock (s)."""
    busy = [[10.0 + a / 1e3, 10.0 + b / 1e3] for a, b in busy_ms]
    return SimpleNamespace(ops=[("k", a, b) for a, b in busy], busy=busy)


def _info(monkeypatch, records, device=None):
    monkeypatch.setattr(tracing, "take", lambda: list(records))
    return SimpleNamespace(trace=device, cell={}, profiled={"ok": True})


def _read(name, info):
    return H.load_metric(name).read(info)


def test_banded_readers(monkeypatch):
    info = _info(monkeypatch, _banded())
    assert _read("plan_s", info) == pytest.approx(0.25)
    # the gate's prep (99 ms) is no snapshot's: (2 x 10 + 2 x 11) / 2
    assert _read("prep_ms", info) == pytest.approx(21.0)
    # the gate's 999 tiles likewise: (2 x 7 + 2 x 8) / 2
    assert _read("k2_tiles", info) == pytest.approx(15.0)
    # (2 x 40 + 2 x 41) / (4 x 100)
    assert _read("live_src_share", info) == pytest.approx(40.5)
    assert _read("noise_s", info) == pytest.approx(0.09)
    assert _read("phasing_s", info) == pytest.approx(0.1)
    assert _read("snap_idle_share", info) is None      # no device trace


def test_direct_readers_and_absent_spans(monkeypatch):
    info = _info(monkeypatch, _direct())
    for name in ("plan_s", "prep_ms", "k2_tiles"):
        assert _read(name, info) is None, name
    assert _read("live_src_share", info) == pytest.approx(50.0)
    assert _read("noise_s", info) == pytest.approx(0.01)
    assert _read("phasing_s", info) == pytest.approx(0.01)


def test_snap_idle_share(monkeypatch):
    """Busy inside the snapshots only: the busy outside them (the inputs
    and the finalize) and the idle between them do not count."""
    dev = _device([(0, 10), (12, 20), (25, 35), (40, 55), (70, 200)])
    info = _info(monkeypatch, _direct(), dev)
    # snapshots [10, 30] and [40, 60]: busy 8 + 5 and 15 of 40 ms
    assert _read("snap_idle_share", info) == pytest.approx(30.0)
    info = _info(monkeypatch, _direct(), _device([]))
    assert _read("snap_idle_share", info) is None


def test_the_records_are_taken_once_per_run(monkeypatch):
    calls = []

    def take():
        calls.append(1)
        return _banded()
    monkeypatch.setattr(tracing, "take", take)
    info = SimpleNamespace(trace=None)
    for name in NEW:
        _read(name, info)
    assert len(calls) == 1


def test_the_last_simulation_trace_is_read(monkeypatch):
    """Records of two roots (the profiled simulation, and a span of
    something else after it): the last "simulation" root's are read."""
    other = [dict(r, trace="t0") for r in _direct()]
    tail = [_rec(900, None, "stage", 0, 1, trace="t2")]
    info = _info(monkeypatch, other + _banded() + tail)
    assert _read("plan_s", info) == pytest.approx(0.25)
    assert {r["trace"] for r in spans.of(info).records} == {"t1"}


@pytest.mark.parametrize("records", [[], None])
def test_nothing_where_nothing_was_recorded(monkeypatch, records):
    """No record (the recorder kept none), or no recorder at all (a
    checkout older than prisim_tpu_torch.tracing): every reader reads
    nothing and none raises."""
    if records is None:
        monkeypatch.setitem(sys.modules, "prisim_tpu_torch.tracing", None)
    else:
        monkeypatch.setattr(tracing, "take", lambda: records)
    info = SimpleNamespace(trace=_device([(0, 1)]))
    for name in NEW + AMPS[:1] + PREP[:1] + PAYLOAD + (
            "finalize_kernel_share", "write_gbps", "plan_card_share"):
        assert _read(name, info) is None, name


def test_benchmark_lists_the_new_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        mod = H.load_metric(name)
        e = entries[name]
        assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
            e["unit"], e["source"], e["moves"], e["layer"])
        assert e["moves"] == "vis_rate"
        assert set(e["workloads"]) <= {w["name"] for w in bench["workloads"]}
    names = [m["name"] for m in bench["per_layer"]]
    start = names.index(NEW[0])
    assert names[start:start + len(NEW)] == list(NEW)


AMPS = ("amps_kernel_share", "amps_roofline")


def _direct_with_kernel(kernel_snapshots):
    """_direct's records, with one airy_amps launch in the beam_flux spans
    (and so in the snapshot spans) of `kernel_snapshots`."""
    recs = _direct()
    for r in recs:
        t = (r["id"] - 3) // 3
        if r["name"] in ("snapshot", "beam_flux") and t in kernel_snapshots:
            r["launches"]["airy_amps"] = 1
    return recs


@pytest.mark.parametrize("kernel_snapshots,want", [
    ((0, 1), 100.0), ((1,), 50.0), ((), None)])
def test_amps_kernel_share(monkeypatch, kernel_snapshots, want):
    """src.processed of the snapshots whose beam_flux launched airy_amps,
    over all snapshots'; nothing where no snapshot took the kernel (the
    parent, or another beam)."""
    info = _info(monkeypatch, _direct_with_kernel(kernel_snapshots))
    got = _read("amps_kernel_share", info)
    assert got == (None if want is None else pytest.approx(want))


def _kernel_info(ops, engine="direct"):
    """A direct cell's TraceInfo fields: device ops (name, start s, end s),
    and a reference of 1000 sources x 8 channels with 400 and 600 above
    the horizon in its two snapshots."""
    trace = SimpleNamespace(ops=ops)
    trace.kernel_seconds = lambda pattern: H.DeviceTrace.kernel_seconds(
        trace, pattern)
    ref = SimpleNamespace(nsrc=1000, nchan=8,
                          live_counts=lambda lst: [400, 600])
    return SimpleNamespace(trace=trace, cell={"expect_engine": engine},
                           profiled={"ok": True, "lst_init": 3.0}, ref=ref)


def test_amps_roofline():
    """The least bytes over the kernel's own device time: each snapshot's
    live flux rows read, the table written, directions and channel factors
    read once, at 3.35 TB/s; nothing without the kernel or the trace, or in
    a banded cell."""
    mod = H.load_metric("amps_roofline")
    kernel = "void (anonymous namespace)::airy_amps_kernel<true>(...)"
    ops = [(kernel, 0.0, 2e-6), ("nudft_k1<false, false>", 2e-6, 1.0),
           (kernel, 1.0, 1.0 + 3e-6)]
    nbytes = (400 + 600) * 8 * 4 + 2 * (1000 * 8 * 4 + 1000 * 12 + 8 * 4)
    assert mod.read(_kernel_info(ops)) == pytest.approx(
        100.0 * nbytes / 3.35e12 / 5e-6, rel=1e-9)
    # the north star: 393,216 live of 786,432 sources x 1024 channels
    assert mod.snapshot_bound_s(393216, 786432, 1024) == pytest.approx(
        (393216 + 786432) * 4096 / 3.35e12 + (786432 * 12 + 4096) / 3.35e12,
        rel=1e-12)
    assert mod.read(_kernel_info(ops[1:2])) is None
    assert mod.read(_kernel_info(ops, engine="banded")) is None
    assert mod.read(SimpleNamespace(trace=None)) is None


def test_benchmark_lists_the_amps_metrics():
    """The two readers of the airy_amps kernel, together in per_layer, in the
    snapshots' layer, in the two direct cells."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    snap = entries["snap_ms"]["layer"]
    for name in AMPS:
        mod = H.load_metric(name)
        e = entries[name]
        assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
            e["unit"], e["source"], e["moves"], e["layer"])
        assert e["layer"] == snap and e["moves"] == "vis_rate"
        assert e["workloads"] == ["hera37.direct", "hera331.direct"]
    names = [m["name"] for m in bench["per_layer"]]
    start = names.index(AMPS[0])
    assert names[start:start + len(AMPS)] == list(AMPS)


SORTED = ("spread_roofline", "nufft_snap_ms", "sort_ms")


def _sorted_route(device_ms=True):
    """A sorted-route simulation: the gate's direct snapshot 0 (beam_flux,
    k1a, no "snapshot"), then under "snapshots" two snapshots of two
    blocks of baselines each; stream milliseconds on every span, or on
    none."""
    def dm(v):
        return v if device_ms else None
    recs = [_rec(1, None, "simulation", 0, 1000),
            _rec(2, 1, "visibilities", 0, 900),
            _rec(3, 2, "gate", 0, 200, device_ms=dm(150.0)),
            _rec(4, 3, "beam_flux", 0, 50, device_ms=dm(40.0)),
            _rec(5, 3, "k1a", 50, 200, device_ms=dm(110.0)),
            _rec(6, 2, "snapshots", 200, 900, device_ms=dm(600.0))]
    rid = 7
    for t, a in enumerate((200, 500)):
        snap = rid
        recs.append(_rec(snap, 6, "snapshot", a, a + 300,
                         {"spread.blocks": 2}, device_ms=dm(250.0 + 50 * t)))
        recs += [_rec(rid + 1, snap, "beam_flux", a, a + 10, device_ms=dm(5.0)),
                 _rec(rid + 2, snap, "project", a + 10, a + 20,
                      device_ms=dm(2.0))]
        rid += 3
        for b in range(2):
            c = a + 20 + 130 * b
            recs += [_rec(rid, snap, "delays", c, c + 10, device_ms=dm(3.0)),
                     _rec(rid + 1, snap, "spread.sort", c + 10, c + 50,
                          device_ms=dm(30.0 + 10 * t + b)),
                     _rec(rid + 2, snap, "spread", c + 50, c + 120,
                          {"spread.pairs": 1000}, device_ms=dm(60.0)),
                     _rec(rid + 3, snap, "post", c + 120, c + 130,
                          device_ms=dm(2.0))]
            rid += 4
    return recs


def test_sorted_span_readers(monkeypatch):
    """nufft_snap_ms: the snapshots' stream ms, the mean (the gate's
    snapshot 0 is none of them); sort_ms: each snapshot's spread.sort
    spans summed over its blocks, then the mean."""
    info = _info(monkeypatch, _sorted_route())
    assert _read("nufft_snap_ms", info) == pytest.approx(275.0)
    # (30 + 31 + 40 + 41) / 2
    assert _read("sort_ms", info) == pytest.approx(71.0)
    # the other engines' readers find nothing of theirs here
    for name in ("prep_ms", "k2_tiles", "plan_s"):
        assert _read(name, info) is None, name


@pytest.mark.parametrize("records", ["no_device_ms", "direct", "none"])
def test_sorted_span_readers_read_nothing_without_their_spans(monkeypatch,
                                                             records):
    """No stream times (a CPU run), another engine's simulation, or no
    recorder at all (a checkout older than it): nothing, and no raise."""
    if records == "none":
        monkeypatch.setitem(sys.modules, "prisim_tpu_torch.tracing", None)
        info = SimpleNamespace(trace=_device([(0, 1)]))
    else:
        info = _info(monkeypatch, _sorted_route(device_ms=False)
                     if records == "no_device_ms" else _direct())
    for name in ("nufft_snap_ms", "sort_ms"):
        assert _read(name, info) is None, name


def test_spread_roofline():
    """The benchmark's count of the spread over the kernels' own device
    time: live pairs at 4 K r ops on the FP64 tensor cores and 2 K
    (ncoef - 1) on the FP64 units, or the delays, payload and grid at the
    HBM peak, whichever is longer, a snapshot at a time; nothing without
    the kernel or the trace, or in another engine's cell."""
    mod = H.load_metric("spread_roofline")
    kernel = "void (anonymous namespace)::delay_spread_kernel(...)"
    ops = [(kernel, 0.0, 2e-3), ("nudft_k1<false, false>", 2e-3, 1.0),
           (kernel, 1.0, 1.0 + 3e-3)]
    info = _kernel_info(ops, engine="sorted")
    info.cell["config"] = "hera331-nside256-sorted"
    info.ref.nbl = 30
    want = 0.0
    for live in (400, 600):
        pairs = live * 30.0
        t_ops = pairs * 4 * 13 * 32 / 67e12 + pairs * 2 * 13 * 12 / 34e12
        nbytes = pairs * 8 + live * 32 * 8 + 30 * 2 * 8 * 32 * 16
        want += max(t_ops, nbytes / 3.35e12)
    assert mod.read(info) == pytest.approx(100.0 * want / 5e-3, rel=1e-12)
    # the north star: ops-bound, 8.43 ms a snapshot of 393,216 live sources
    ns = mod.snapshot_bound_s(393216, 630, 1024, 32)
    pairs = 393216 * 630.0
    assert ns == pytest.approx(pairs * 1664 / 67e12 + pairs * 312 / 34e12,
                               rel=1e-12)
    assert 8.4e-3 < ns < 8.45e-3
    assert mod.read(_kernel_info(ops[1:2], engine="sorted")) is None
    assert mod.read(_kernel_info(ops, engine="direct")) is None
    assert mod.read(SimpleNamespace(trace=None)) is None


def test_benchmark_lists_the_sorted_metrics():
    """The three readers of the sorted route, together in per_layer, in the
    route's own layer, in its cell alone."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SORTED:
        mod = H.load_metric(name)
        e = entries[name]
        assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
            e["unit"], e["source"], e["moves"], e["layer"])
        assert e["layer"] == \
            "engine snapshots: engine/nufft_delay -> csrc/spread.cu"
        assert e["moves"] == "vis_rate" and e["workloads"] == ["hera331.sorted"]
    names = [m["name"] for m in bench["per_layer"]]
    start = names.index(SORTED[0])
    assert names[start:start + len(SORTED)] == list(SORTED)


PREP = ("prep_kernel_share", "prep_roofline")


def _banded_with_kernel(kernel_preps):
    """_banded's records, with one banded_prep launch in the prep spans
    numbered `kernel_preps` (0-3: the snapshots' chunks in order) and in
    the gate's."""
    recs = _banded()
    preps = [r for r in recs if r["name"] == "prep" and r["parent"] != 6]
    for i, r in enumerate(preps):
        if i in kernel_preps:
            r["launches"]["banded_prep"] = 1
    recs[6]["launches"]["banded_prep"] = 1
    return recs


@pytest.mark.parametrize("kernel_preps,want", [
    ((0, 1, 2, 3), 100.0), ((1, 2, 3), 75.0), ((), None)])
def test_prep_kernel_share(monkeypatch, kernel_preps, want):
    """src.processed of the snapshots' prep spans that launched
    banded_prep, over all their prep spans'; the gate's chunk is no
    snapshot's; nothing where no snapshot's prep took the kernel (the
    parent) or no snapshot has a prep span (the direct engine)."""
    info = _info(monkeypatch, _banded_with_kernel(kernel_preps))
    got = _read("prep_kernel_share", info)
    assert got == (None if want is None else pytest.approx(want))
    info = _info(monkeypatch, _direct())
    assert _read("prep_kernel_share", info) is None


def _prep_plan(truth=True):
    return dict(K=9, rank=32, ndir=384, nbl=630, R_max=840, n_chunks=3,
                src_chunk=262144, truth=truth)


def test_prep_roofline():
    """The least bytes of every chunk's prep (u streams, source vectors
    and, with truth amps, the payload rows and node fluxes) in the cell's
    snapshots and the gate's, over the kernel's own device time at
    3.35 TB/s; nothing without the kernel, the trace or the plan."""
    mod = H.load_metric("prep_roofline")
    kernel = "void (anonymous namespace)::banded_prep_kernel<true>(...)"
    ops = [(kernel, 0.0, 2e-3), ("banded_k2_kernel", 2e-3, 1.0),
           (kernel, 1.0, 1.0 + 3e-3)]
    info = _kernel_info(ops, engine="banded")
    info.cell["n_acc"] = 25
    info.plan = _prep_plan()
    # the north star: 262,144 x (384 x 8 + 24 + 32 x 16) = 945.8 MB a chunk
    nbytes = 262144 * (384 * 8 + 24 + 32 * 16)
    assert mod.chunk_bytes(info.plan) == nbytes == 945815552
    assert mod.read(info) == pytest.approx(
        100.0 * 3 * 26 * nbytes / 3.35e12 / 5e-3, rel=1e-12)
    assert mod.chunk_bytes(_prep_plan(truth=False)) == 262144 * (384 * 8
                                                                 + 24)
    info.plan = None
    assert mod.read(info) is None
    info.plan = _prep_plan()
    info.trace = SimpleNamespace(kernel_seconds=lambda pattern: 0.0)
    assert mod.read(info) is None
    assert mod.read(SimpleNamespace(trace=None, plan=_prep_plan())) is None


def test_benchmark_lists_the_prep_metrics():
    """The two readers of the banded_prep kernel, together in per_layer, in
    the snapshots' layer, in the banded cell alone."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in PREP:
        mod = H.load_metric(name)
        e = entries[name]
        assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
            e["unit"], e["source"], e["moves"], e["layer"])
        assert e["layer"] == entries["prep_ms"]["layer"]
        assert e["moves"] == "vis_rate" and e["workloads"] == ["hera331.banded"]
    names = [m["name"] for m in bench["per_layer"]]
    start = names.index(PREP[0])
    assert names[start:start + len(PREP)] == list(PREP)


CELLS = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/gpubench/tests")
from gpubench import harness as H, spans
from conftest import tiny
from prisim_tpu_torch import tracing
seen = {}
orig = H.TraceInfo.__init__
def keep(self, *a, **k):
    orig(self, *a, **k)
    seen["info"] = self
H.TraceInfo.__init__ = keep
cell, config = tiny("hera331.banded", engine="nufft")
e2e, per_layer = H.benchmark_entries("hera331.banded")
res = H.run_cell(cell, config, 5, 1.0, True, device="cpu", per_layer=per_layer,
                 end_to_end=e2e, log=open("/dev/null", "w"))
tr = spans.of(seen["info"])
prof = seen["info"].profiled["spans"]
out = dict(correct=res["correct"], metrics=res["metrics"],
           roots=len(tr.named("simulation")), snaps=len(tr.snapshots()),
           n_acc=cell["n_acc"], left=len(tracing.take()),
           finalize=prof["noise"][0][2] + prof["post"][0][2])
cell, config = tiny("hera37.direct", n_acc=2)
res = H.run_cell(cell, config, 6, 0.3, False, device="cpu",
                 log=open("/dev/null", "w"))
out.update(untraced_correct=res["correct"], untraced_left=len(tracing.take()))
print(json.dumps(out))
'''


def test_traced_and_untraced_tiny_cells_on_the_cpu(tmp_path):
    """The banded cell cut to the CPU, traced: the recorder keeps the
    profiled simulation alone (the warm and the other simulations of the
    window run with it off), the span readers read it, and the finalize
    split adds up to that simulation's finalize phase lines. An untraced
    run of the small direct cell records nothing. In a process of its own,
    as the harness refuses a process that holds JAX."""
    import os
    import subprocess
    script = tmp_path / "cells.py"
    script.write_text(CELLS)
    proc = subprocess.run([sys.executable, str(script), str(ROOT)],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["untraced_correct"]
    m = got["metrics"]
    for name in ("plan_s", "live_src_share", "noise_s", "phasing_s"):
        assert m[name]["value"] >= 0, name
    # the CPU made the plan's order: no source of it on a card
    assert m["plan_card_share"]["value"] == 0.0
    # the card's readers: stream times, K2's worklist, the device trace
    for name in ("prep_ms", "k2_tiles", "snap_idle_share",
                 "prep_kernel_share", "prep_roofline", "k2_item_share"):
        assert name not in m
    assert got["roots"] == 1 and got["snaps"] == got["n_acc"]
    assert m["noise_s"]["value"] + m["phasing_s"]["value"] == \
        pytest.approx(got["finalize"], abs=0.01)
    assert got["left"] == 0 and got["untraced_left"] == 0


def _finalized(records, launched):
    """`records` with finalize.vis counted in each finalize.post span
    (B x C x T of a north-star simulation) and a phase_cubes launch in
    those numbered `launched`."""
    posts = [r for r in records if r["name"] == "finalize.post"]
    for i, r in enumerate(posts):
        r["counts"]["finalize.vis"] = 630 * 1024 * 25
        if i in launched:
            r["launches"]["phase_cubes"] = 1
    return records


@pytest.mark.parametrize("engine", ["banded", "direct"])
@pytest.mark.parametrize("launched,want", [((0,), 100.0), ((), None)])
def test_finalize_kernel_share(monkeypatch, engine, launched, want):
    """finalize.vis of the finalize.post spans that launched phase_cubes,
    over all of theirs: 100 where the card finalized the cubes, nothing
    without the launch (the parent, or the host finalize), in every
    engine's simulation."""
    recs = _banded() if engine == "banded" else _direct()
    info = _info(monkeypatch, _finalized(recs, launched))
    got = _read("finalize_kernel_share", info)
    assert got == (None if want is None else pytest.approx(want))


def test_finalize_kernel_share_over_sub_simulations(monkeypatch):
    """Two finalizes under one root (the components of a pol run), one of
    them on the card: half the visibilities; none counted: nothing."""
    recs = _direct() + [_rec(11, 1, "finalize.post", 95, 100)]
    info = _info(monkeypatch, _finalized(recs, (1,)))
    assert _read("finalize_kernel_share", info) == pytest.approx(50.0)
    info = _info(monkeypatch, _direct())
    assert _read("finalize_kernel_share", info) is None


def test_benchmark_lists_finalize_kernel_share():
    """The reader in per_layer, in the finalize's layer, moving vis_rate,
    listing the four cells that report vis_rate and read it."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e = {m["name"]: m for m in bench["per_layer"]}["finalize_kernel_share"]
    mod = H.load_metric("finalize_kernel_share")
    assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
        e["unit"], e["source"], e["moves"], e["layer"])
    finalize = {m["name"]: m for m in bench["per_layer"]}["finalize_s"]
    assert e["layer"] == finalize["layer"] and e["moves"] == "vis_rate"
    assert e["workloads"] == ["hera331.banded", "hera37.direct",
                              "hera331.direct", "hera331.sorted"]


WRITE = ("write_s", "write_gbps")
GB = 10 ** 9


def _saved(file_bytes=(645 * GB // 1000,), file_ms=(1290,), meta_bytes=2048):
    """_banded's records with a product write after the finalize: a
    "write" span holding one "write.file" span a (bytes, ms) pair, each
    counting write.bytes, then "write.meta" counting the metadata's."""
    recs = _banded()
    recs[0]["end_ns"] += 3000 * MS
    a = 1000
    recs.append(_rec(100, 1, "write", a, a + sum(file_ms) + 10))
    for i, (n, ms) in enumerate(zip(file_bytes, file_ms)):
        recs.append(_rec(101 + i, 100, "write.file", a, a + ms,
                         {"write.bytes": n}))
        a += ms
    recs.append(_rec(199, 100, "write.meta", a, a + 10,
                     {"write.bytes": meta_bytes}))
    return recs


def test_write_gbps(monkeypatch):
    """write.bytes of the write.file spans over their seconds, in 1e9
    bytes a second; the metadata's bytes and seconds are not the writer's.
    Nothing without a write.file span (the parent, or a run that wrote no
    product) or where it counted no byte."""
    info = _info(monkeypatch, _saved())
    assert _read("write_gbps", info) == pytest.approx(0.645 / 1.29)
    info = _info(monkeypatch, _saved((GB, 3 * GB), (500, 1500)))
    assert _read("write_gbps", info) == pytest.approx(2.0)
    info = _info(monkeypatch, _banded())
    assert _read("write_gbps", info) is None
    info = _info(monkeypatch, [r for r in _saved() if r["name"] not in
                               ("write.file", "write.meta")])
    assert _read("write_gbps", info) is None
    info = _info(monkeypatch, _saved((0,), (1290,)))
    assert _read("write_gbps", info) is None


def test_write_s():
    """The mean over the window's simulations of the "products saved"
    phase; nothing where no simulation printed it (a cell without a
    product)."""
    sims = [dict(spans={"post": [(0.0, 1.0, 1.0)],
                        "write": [(1.0, 2.0 + k, 1.0 + k)]})
            for k in (0.2, 0.4, 0.9)]
    info = H.TraceInfo({}, None, sims, None, None, None)
    assert _read("write_s", info) == pytest.approx(1.5)
    info = H.TraceInfo({}, None, [dict(spans={"post": [(0.0, 1.0, 1.0)]})],
                       None, None, None)
    assert _read("write_s", info) is None


def test_benchmark_lists_the_write_metrics():
    """The two readers of the product write, together in per_layer, in
    its layer, moving vis_rate, in the product cell alone."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in WRITE:
        mod = H.load_metric(name)
        e = entries[name]
        assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
            e["unit"], e["source"], e["moves"], e["layer"])
        assert e["layer"] == "driver._save_products: product write"
        assert e["moves"] == "vis_rate"
        assert e["workloads"] == ["hera331.product"]
    names = [m["name"] for m in bench["per_layer"]]
    start = names.index(WRITE[0])
    assert names[start:start + len(WRITE)] == list(WRITE)
    configs = {c["name"] for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    assert "hera331-nside256-fits" in configs
    assert cells["hera331.product"]["config"] == "hera331-nside256-fits"
    assert cells["hera331.product"]["chips"] == 1


def _planned(counts):
    """_banded's records with a plan.fns span under the plan counting
    `counts` (the sort's and the node fluxes' counters)."""
    recs = _banded()
    recs.append(_rec(100, 4, "plan.fns", 200, 350, dict(counts)))
    return recs


@pytest.mark.parametrize("counts,want", [
    ({"plan.src": 786432, "plan.src_card": 786432}, 100.0),
    ({"plan.src": 1000, "plan.src_card": 999}, 99.9),
    ({"plan.src": 1000, "plan.src_card": 0}, 0.0),
    ({"plan.src": 1000}, 0.0),
    ({}, None)])
def test_plan_card_share(monkeypatch, counts, want):
    """plan.src_card over plan.src, summed below the plan spans, in %: 100
    where the card made the order and node fluxes of every source; nothing
    without a plan.src counter (the parent) or without a plan span (the
    direct engine)."""
    info = _info(monkeypatch, _planned(counts))
    got = _read("plan_card_share", info)
    assert got == (None if want is None else pytest.approx(want))
    info = _info(monkeypatch, _direct())
    assert _read("plan_card_share", info) is None


def test_benchmark_lists_plan_card_share():
    """The reader in per_layer, after the write's, in the plan's layer
    (plan_s's), moving vis_rate, in the banded cell alone."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    e = entries["plan_card_share"]
    mod = H.load_metric("plan_card_share")
    assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
        e["unit"], e["source"], e["moves"], e["layer"])
    assert e["layer"] == entries["plan_s"]["layer"]
    assert e["moves"] == "vis_rate" and e["workloads"] == ["hera331.banded"]
    names = [m["name"] for m in bench["per_layer"]]
    assert names.index("plan_card_share") == names.index("write_gbps") + 1


PAYLOAD = ("payload_ms", "gate_amps_s", "beam_gevals")


def _payloads(device=True):
    """_banded's records as the f32 node model's banded run leaves them:
    a prep.payload span in each prep (the gate's and the snapshots'), each
    counting beam.evals at the rank's 16 nodes of 100 sources, and a
    gate.amps span in the gate's chunk counting the full 256 channels;
    with `device`, stream milliseconds on both."""
    recs = _banded()
    rid = 200
    for r in [r for r in recs if r["name"] == "prep"]:
        ms = 3.0 if r["parent"] == 6 else 1.5 + (r["device_ms"] - 10.0)
        recs.append(_rec(rid, r["id"], "prep.payload", 0, 1,
                         {"beam.evals": 1600},
                         device_ms=ms if device else None))
        rid += 1
    recs.append(_rec(rid, 6, "gate.amps", 450, 480, {"beam.evals": 25600},
                     device_ms=4.0 if device else None))
    return recs


def test_payload_readers(monkeypatch):
    """payload_ms: the prep.payload spans' stream ms summed over each
    snapshot's chunks, the mean over the snapshots (the gate's is none of
    them); gate_amps_s: the gate.amps spans' stream ms in s; beam_gevals:
    beam.evals of both over their stream seconds, in 1e9 a second."""
    info = _info(monkeypatch, _payloads())
    # snapshots: 2 x 1.5 and 2 x 2.5 ms
    assert _read("payload_ms", info) == pytest.approx(4.0)
    assert _read("gate_amps_s", info) == pytest.approx(0.004)
    evals = 5 * 1600 + 25600
    ms = 3.0 + 2 * 1.5 + 2 * 2.5 + 4.0
    assert _read("beam_gevals", info) == pytest.approx(evals / ms * 1e3
                                                       / 1e9)


@pytest.mark.parametrize("records", ["airy", "cpu", "direct"])
def test_payload_readers_read_nothing_without_their_spans(monkeypatch,
                                                          records):
    """The Airy cells (no prep.payload span; a gate.amps span without
    beam.evals, as the airy_amps launch counts none), a run on the CPU
    (no stream times) and the direct engine: nothing where there is
    nothing to read, and no reader raises; the Airy gate's launch is read
    as the gate's beam all the same."""
    if records == "airy":
        recs = _banded() + [_rec(300, 6, "gate.amps", 450, 480,
                                 device_ms=0.5)]
    elif records == "cpu":
        recs = _payloads(device=False)
    else:
        recs = _direct()
    info = _info(monkeypatch, recs)
    assert _read("payload_ms", info) is None
    assert _read("beam_gevals", info) is None
    want = 0.0005 if records == "airy" else None
    got = _read("gate_amps_s", info)
    assert got == (None if want is None else pytest.approx(want))


def test_benchmark_lists_the_payload_metrics():
    """The three readers of the torch payload, together at the end of
    per_layer: payload_ms and beam_gevals in the snapshots' layer,
    gate_amps_s in the gate's, each moving vis_rate in the MWA cell
    alone."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    layers = dict(payload_ms="prep_ms", gate_amps_s="gate_s",
                  beam_gevals="prep_ms")
    for name in PAYLOAD:
        mod = H.load_metric(name)
        e = entries[name]
        assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
            e["unit"], e["source"], e["moves"], e["layer"])
        assert e["layer"] == entries[layers[name]]["layer"]
        assert e["moves"] == "vis_rate" and e["workloads"] == [
            "mwa128.catalog"]
    names = [m["name"] for m in bench["per_layer"]]
    start = names.index(PAYLOAD[0])
    assert names[start:start + len(PAYLOAD)] == list(PAYLOAD)
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["mwa128.catalog"]["config"] == "mwa128-catalog"
    assert cells["mwa128.catalog"]["chips"] == 1


def _items(items, gate_items=None):
    """_banded's records with each snapshot worklist counting `items`
    (k2.items, beside its 3 live items), and the gate's `gate_items`."""
    recs = _banded()
    for r in recs:
        if r["name"] == "k2.worklist":
            if r["parent"] == 8:
                if gate_items is not None:
                    r["counts"].update({"k2.items": gate_items,
                                        "k2.items_live": gate_items})
            elif items is not None:
                r["counts"]["k2.items"] = items
    return recs


@pytest.mark.parametrize("items,gate_items,want", [
    (12, None, 25.0), (3, None, 100.0), (12, 40, 25.0), (None, 40, None)])
def test_k2_item_share(monkeypatch, items, gate_items, want):
    """k2.items_live over k2.items below the snapshots' k2.worklist spans,
    in %: (4 x 3) / (4 x items); the gate's worklist is no snapshot's;
    nothing without a k2.items counter (the parent) or without K2 (the
    direct engine)."""
    info = _info(monkeypatch, _items(items, gate_items))
    got = _read("k2_item_share", info)
    assert got == (None if want is None else pytest.approx(want))
    info = _info(monkeypatch, _direct())
    assert _read("k2_item_share", info) is None


def test_benchmark_lists_k2_item_share():
    """The reader at the end of per_layer, in K2's layer (k2_tiles's),
    moving vis_rate, in the banded north-star and MWA cells."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    e = entries["k2_item_share"]
    mod = H.load_metric("k2_item_share")
    assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER) == (
        e["unit"], e["source"], e["moves"], e["layer"])
    assert e["layer"] == entries["k2_tiles"]["layer"]
    assert (e["better"], e["moves"]) == ("lower", "vis_rate")
    assert e["workloads"] == ["hera331.banded", "mwa128.catalog"]
    assert [m["name"] for m in bench["per_layer"]][-1] == "k2_item_share"
