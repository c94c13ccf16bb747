"""The north star's sorted delay-space NUFFT route as a configuration of
the benchmark (gpubench/configs/hera331-nside256-sorted.json, cell
hera331.sorted), cut to the CPU: run_simulation on the route against the
benchmark's plain float64 reference (gpubench/reference/model.py), the
spans and counters inside the sorted snapshot, and the configuration and
cell as the harness loads them."""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import harness as H  # noqa: E402
from gpubench.reference import check as C  # noqa: E402
from gpubench.reference.model import DriftReference  # noqa: E402
from prisim_tpu_torch import tracing  # noqa: E402
from prisim_tpu_torch.config import load_parms  # noqa: E402
from prisim_tpu_torch.driver import run_simulation  # noqa: E402
from prisim_tpu_torch.engine import nufft_delay as nd  # noqa: E402

CELL = "hera331.sorted"
LST = 13.0
SEED = 2 ** 33 + 11
# max|V - V_ref| / max|V_ref| of the route against the float64 reference
# at the cut below: the program reads 4.6e-6 to 6.6e-6 (the float32 beam x
# flux, as the direct engine's 3.7e-6 to 6.4e-6 there, its rank-32
# float32 projection and the spread's KB error); the control (float32
# phases, bfloat16 amplitudes) reads 1.1e-3 to 1.3e-3. 3e-5 leaves 4.5x
# above the one and 38x below the other.
VIS_TOL = 3e-5


def _cut():
    """(cell, sections) of hera331.sorted cut to the CPU: HERA-19 (30
    baselines), nside 16 (3072 sources), 64 channels over the same
    100-200 MHz, 2 accumulations; rank 32 and the gate as configured."""
    cell = H.load_workload(CELL)
    config = copy.deepcopy(H.load_config(cell["config"]))
    s = config["sections"]
    s["array"]["layout"] = "HERA-19"
    s["bandpass"].update(nchan=64, freq_resolution=100e6 / 64)
    s["skyparm"]["nside"] = 16
    return cell, H.cell_sections(cell, config, LST, SEED, n_acc=2)


@pytest.fixture(scope="module")
def traced():
    """One traced run of the cut: (sections, VisibilitySet, records)."""
    _, sec = _cut()
    tracing.take()
    with tracing.on():
        vs, _ = run_simulation(load_parms(sec), save=False, verbose=False,
                               device="cpu")
    return sec, vs, tracing.take()


def test_config_and_cell_load_through_the_harness():
    cell = H.load_workload(CELL)
    config = H.load_config(cell["config"])
    assert (cell["engine"], cell["expect_engine"]) == ("nufft", "sorted")
    sec = H.cell_sections(cell, config, 3.5, 7)
    assert sec["processing"] == {"nufft_spread": "sorted", "nufft_rank": 32,
                                 "engine": "nufft"}
    # the north star's sections, and the route's two keys beside them
    north = H.load_config("hera331-nside256")["sections"]
    assert {k: v for k, v in config["sections"].items()
            if k != "processing"} == north
    parms = load_parms(sec)
    assert parms["processing"]["nufft_spread"] == "sorted"
    ref = DriftReference(sec)
    assert (ref.nbl, ref.nchan, ref.nsrc) == (630, 1024, 786432)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    assert conf["file"] == "gpubench/configs/%s.json" % cell["config"]
    assert (conf["source"], conf["reduced"]) == (config["source"],
                                                 config["reduced"])
    work = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (work["config"], work["traffic"], work["chips"],
            work["why"]) == (cell["config"], cell["traffic"], 1, cell["why"])
    _, per_layer = H.benchmark_entries(CELL)
    assert {"spread_roofline", "nufft_snap_ms", "sort_ms"} <= set(per_layer)


def test_route_against_the_reference():
    """run_simulation on the sorted route (the plain spread on the CPU)
    under VIS_TOL of the float64 reference on every baseline, channel and
    accumulation, with the finalize's numbers exact; the control in the
    program's place fails VIS_TOL."""
    cell, sec = _cut()
    vs, rec = H.simulate(load_parms(sec), torch.device("cpu"))
    assert rec["error"] is None and rec["engine"] == "sorted"
    ref = DriftReference(sec)
    idx = dict(bl=np.arange(ref.nbl), ch=np.arange(ref.nchan),
               t=np.arange(ref.n_acc))
    got = C.readings(C.keep_sample(vs, idx), ref, LST, idx)
    assert got["vis_err"] < VIS_TOL
    assert got["uvw_err"] < 1e-13 and got["lst_err"] < 1e-12
    assert got["rms_err"] < 1e-14 and got["sum_err"] == 0.0
    assert got["noise_z"] < cell["limits"]["noise_z"]
    ctl = C.readings(C.keep_sample(vs, idx), ref, LST, idx, "control")
    assert ctl["vis_err"] > VIS_TOL
    assert not C.judge(ctl, dict(cell["limits"], vis_err=VIS_TOL))


def _tree(records):
    kids = {}
    for r in records:
        kids.setdefault(r["parent"], []).append(r)
    return kids


BLOCK = ["delays", "spread.sort", "spread", "post"]


def test_sorted_snapshot_spans_and_counters(traced):
    """Under the route's "snapshots" span, each "snapshot" holds
    beam_flux, project and one block's delays, spread.sort, spread and
    post, in that order; spread.pairs is the reference's live sources x
    baselines; spread.blocks is 1; the spread span holds the launch
    counter's delta only on a card."""
    sec, _, recs = traced
    kids = _tree(recs)
    outer = [r for r in recs if r["name"] == "snapshots"]
    assert len(outer) == 1
    snaps = kids[outer[0]["id"]]
    assert [s["name"] for s in snaps] == ["snapshot", "snapshot"]
    live = DriftReference(sec).live_counts(LST)
    for t, snap in enumerate(snaps):
        names = [r["name"] for r in kids[snap["id"]]]
        assert names == ["beam_flux", "project"] + BLOCK
        spread = [r for r in kids[snap["id"]] if r["name"] == "spread"]
        assert spread[0]["counts"] == {"spread.pairs": int(live[t]) * 30}
        assert snap["counts"]["spread.blocks"] == 1
        assert not spread[0]["launches"]
    # the gate's direct snapshot 0 is no "snapshot"
    gate = [r for r in recs if r["name"] == "gate"]
    assert [r["name"] for r in kids[gate[0]["id"]]] == ["beam_flux", "k1a"]


def test_blocks_of_baselines_have_their_spans(traced, monkeypatch):
    """With blocks of at most 7 x (the most live sources of a snapshot)
    pairs, 5 blocks of the 30 baselines: each block's four spans in
    order, the pairs summed over the blocks as before, and the
    visibilities of the blocked run those of the one-block run."""
    sec, vs1, recs1 = traced
    live = DriftReference(sec).live_counts(LST)
    monkeypatch.setattr(nd, "_BLOCK_PAIRS", 7 * int(live.max()))
    tracing.take()
    with tracing.on():
        vs, _ = run_simulation(load_parms(sec), save=False, verbose=False,
                               device="cpu")
    recs = tracing.take()
    kids = _tree(recs)
    snaps = [r for r in recs if r["name"] == "snapshot"]
    for t, snap in enumerate(snaps):
        n_blk = snap["counts"]["spread.blocks"]
        assert n_blk == -(-30 // max(1, 7 * int(live.max()) // int(live[t])))
        assert n_blk > 1
        names = [r["name"] for r in kids[snap["id"]]]
        assert names == ["beam_flux", "project"] + BLOCK * n_blk
        pairs = sum(r["counts"].get("spread.pairs", 0)
                    for r in kids[snap["id"]])
        assert pairs == int(live[t]) * 30
    np.testing.assert_allclose(vs.skyvis, vs1.skyvis, rtol=0,
                               atol=1e-6 * np.abs(vs1.skyvis).max())


def test_mesh_snapshot_has_the_same_spans():
    """The sorted route on a two-shard 'bl' mesh of the CPU: each snapshot
    holds each shard's beam_flux, project and block spans, and the shards'
    pairs add up to the live sources x all baselines."""
    _, sec = _cut()
    sec = dict(sec, pp={"key": "bl"})
    tracing.take()
    with tracing.on():
        run_simulation(load_parms(sec), save=False, verbose=False,
                       devices=["cpu", "cpu"])
    recs = tracing.take()
    kids = _tree(recs)
    live = DriftReference(sec).live_counts(LST)
    snaps = [r for r in recs if r["name"] == "snapshot"]
    assert len(snaps) == 2
    for t, snap in enumerate(snaps):
        names = [r["name"] for r in kids[snap["id"]]]
        assert names == (["beam_flux", "project"] + BLOCK) * 2
        pairs = sum(r["counts"].get("spread.pairs", 0)
                    for r in kids[snap["id"]])
        assert pairs == int(live[t]) * 30
        assert snap["counts"]["spread.blocks"] == 2
