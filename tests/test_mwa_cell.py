"""MWA-128 over a GLEAM-sized point-source catalog with the MWA tile beam,
as a configuration of the benchmark (gpubench/configs/mwa128-catalog.json,
cell mwa128.catalog), cut to the CPU: its plain reference
(gpubench/reference/catalog.py, which imports neither package) against
the program's catalog, tile beam and simulations on both engines; the
configuration and cell as the harness loads them; and the spans and the
counter on the banded payload that torch computes."""

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
from gpubench.reference import catalog as R  # noqa: E402
from gpubench.reference import check as C  # noqa: E402
from gpubench.reference.catalog import CatalogReference  # noqa: E402
from prisim_tpu_torch import driver as drv  # noqa: E402
from prisim_tpu_torch import tracing  # noqa: E402
from prisim_tpu_torch.beams.dispatch import primary_beam  # noqa: E402
from prisim_tpu_torch.config import load_parms  # noqa: E402
from prisim_tpu_torch.skymodel import random_point_source_model  # noqa: E402

CELL = "mwa128.catalog"
LST = 7.25
SEED = 2 ** 31 + 11
# The program evaluates the tile in float32: the sixteen phasors of the
# array factor carry phases of up to 2 pi nu |x| / c ~ 9 rad at 192 MHz
# (|x| <= 2.33 m), each rounded to ~2^-24 of that, and the dipole and
# ground factors a few roundings more, so its power (peak 1) lies within
# about 1e-6 of the float64 pattern (8.7e-7 at 20,000 directions x 256
# channels); 2e-5 leaves room, and is under 1e-3 of either change of the
# pattern that the test below plants.
TILE_F32 = 2e-5


def _cut(engine, nant=12, nchan=16, nsrc=2000, n_acc=2):
    """(cell, sections) of mwa128.catalog cut to the CPU: the first 12
    tiles of the layout (66 baselines), 16 channels, 2,000 sources, 2
    accumulations."""
    cell = dict(H.load_workload(CELL), engine=engine)
    config = copy.deepcopy(H.load_config(cell["config"]))
    s = config["sections"]
    s["array"]["layout_positions"] = s["array"]["layout_positions"][:nant]
    s["bandpass"]["nchan"] = nchan
    s["skyparm"]["nsrc"] = nsrc
    return cell, H.cell_sections(cell, config, LST, SEED, n_acc=n_acc)


@pytest.fixture(autouse=True)
def _clean_recorder():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


@pytest.mark.parametrize("seed", [7, 2 ** 32 - 5])
def test_the_catalog_is_the_programs(seed):
    """The reference's catalog, drawn by its own recipe, equals the
    program's random model at the configuration's parameters, and the
    program's sky built from the sections (precessed to the date) holds
    the reference's directions."""
    _, sec = _cut("direct", nsrc=3000)
    sp = dict(sec["skyparm"], seed=seed)
    ra, dec, flux, index = R.random_catalog(
        3000, sp["flux_min"], sp["flux_max"], sp["spindex"],
        sp["spindex_rms"], seed)
    sm = random_point_source_model(
        3000, flux_min=sp["flux_min"], flux_max=sp["flux_max"],
        spindex_mean=sp["spindex"], spindex_rms=sp["spindex_rms"],
        seed=seed)
    np.testing.assert_array_equal(sm.location, np.stack([ra, dec], -1))
    np.testing.assert_array_equal(sm.spec_parms["flux-scale"], flux)
    np.testing.assert_array_equal(sm.spec_parms["power-law-index"], index)
    np.testing.assert_array_equal(sm.spec_parms["freq-ref"], R.SKY_FREQ_REF)
    assert not np.any(sm.spec_parms["flux-offset"])
    assert flux.min() >= 0.05 and flux.max() <= 100.0
    assert 0.09 < index.std() < 0.11
    parms = load_parms(dict(sec, skyparm=sp))
    freqs = drv.build_frequencies(parms)
    obs = drv.build_schedule(parms, parms["telescope"]["latitude"])
    sky = drv.build_observed_sky(parms, freqs, obs)
    ref = CatalogReference(dict(sec, skyparm=sp))
    s_ref = ref.sky_vectors(ref.schedule(LST)[1])
    rad = np.radians(sky.location)
    s_prog = np.stack([np.cos(rad[:, 1]) * np.cos(rad[:, 0]),
                       np.cos(rad[:, 1]) * np.sin(rad[:, 0]),
                       np.sin(rad[:, 1])], -1)
    assert np.abs(s_prog - s_ref).max() < 1e-12


def _directions(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2])
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_the_tile_pattern_is_the_programs():
    """The reference's float64 tile pattern against primary_beam for the
    configuration's telescope (id mwa, the ground plane, the X dipole east
    to west, the 4 x 4 tile steered to the zenith), as the driver builds
    it, at seeded directions above the horizon and frequencies across the
    band: within float32 rounding (TILE_F32); the same pattern without
    the ground plane, or with the dipole turned north, is far outside."""
    _, sec = _cut("direct")
    parms = load_parms(sec)
    tel = drv._telescope(parms)
    obs = drv.build_schedule(parms, parms["telescope"]["latitude"])
    pinfo = drv._pointing_info(parms, tel, obs)
    s = _directions(4000, 3)
    s[:4] = [[0, 0, 1], [1, 0, 0], [0, 1, 0], [0.6, 0, 0.8]]
    nu = 150e6 + 160e3 * (np.arange(256) - 128)
    nu = nu[np.random.default_rng(4).choice(256, 24, replace=False)]
    got = primary_beam(torch.as_tensor(s, dtype=torch.float32),
                       torch.as_tensor(nu, dtype=torch.float32), tel,
                       pointing_info=pinfo).double().numpy()
    ref = CatalogReference(sec)

    def pattern(axis, ground):
        return R.tile_power(torch.as_tensor(s), torch.as_tensor(nu),
                            torch.as_tensor(axis), torch.as_tensor(
                                ref.pointing), ground).numpy()
    want = pattern(ref.axis, ref.ground_height)
    assert want[0] == pytest.approx(1.0, abs=1e-12)      # the zenith
    assert np.abs(want[1:3]).max() < 1e-12               # the horizon
    err = np.abs(got - want).max()
    assert err < TILE_F32
    for wrong in (pattern(ref.axis, None),
                  pattern(np.array([0.0, 1.0, 0.0]), ref.ground_height)):
        assert np.abs(got - wrong).max() > 1000 * TILE_F32


def _readings(engine, precision="float64"):
    cell, sec = _cut(engine)
    vs, rec = H.simulate(load_parms(sec), torch.device("cpu"))
    assert rec["error"] is None
    assert rec["engine"] == ("banded" if engine == "nufft" else "direct")
    ref = CatalogReference(sec)
    idx = dict(bl=np.arange(ref.nbl), ch=np.arange(ref.nchan),
               t=np.arange(ref.n_acc))
    got = C.keep_sample(vs, idx)
    return cell, C.readings(got, ref, LST, idx), C.readings(
        got, ref, LST, idx, "control")


@pytest.mark.parametrize("engine", ["direct", "nufft"])
def test_simulations_pass_against_the_reference(engine):
    """One simulation of the cut on each engine (nufft drives the banded
    engine the cell takes on a card, with its gate and the torch payload)
    passes the cell's limits against the float64 reference, at float32's
    accuracy; the control (float32 phases, bfloat16 amplitudes) in the
    program's place fails vis_err."""
    cell, got, control = _readings(engine)
    assert C.judge(got, cell["limits"])
    assert got["vis_err"] < 2e-6
    assert got["uvw_err"] == 0.0 and got["lst_err"] == 0.0
    assert got["sum_err"] == 0.0 and got["rms_err"] < 1e-14
    assert control["vis_err"] > cell["limits"]["vis_err"]
    assert not C.judge(control, cell["limits"])


def test_config_and_cell_load_through_the_harness():
    cell = H.load_workload(CELL)
    config = H.load_config(cell["config"])
    assert (cell["engine"], cell["expect_engine"], cell["n_acc"],
            cell["chips"]) == ("auto", "banded", 10, 1)
    assert H.product_format(cell) is None
    assert H.reference_class(config) is CatalogReference
    sec = H.cell_sections(cell, config, 3.5, 2 ** 31 + 3)
    assert sec["skyparm"]["seed"] == 2 ** 31 + 3
    parms = load_parms(sec)
    bls = drv.build_baselines(drv.build_layout(parms), redundant=False)
    assert bls.nbl == 8128
    assert drv.build_frequencies(parms).size == 256
    ref = CatalogReference(sec)
    assert (ref.nbl, ref.nchan, ref.n_acc, ref.nsrc) == (8128, 256, 10,
                                                         307455)
    np.testing.assert_array_equal(ref.bl, np.asarray(bls.vectors))
    assert set(ref.precisions) == {"float64", "control", "phase32"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    assert conf["file"] == "gpubench/configs/%s.json" % cell["config"]
    assert (conf["source"], conf["reduced"]) == (config["source"],
                                                 config["reduced"])
    work = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (work["config"], work["traffic"], work["chips"],
            work["why"]) == (cell["config"], "drift10-auto-catalog", 1,
                             cell["why"])
    e2e, per_layer = H.benchmark_entries(CELL)
    assert e2e == ["vis_rate", "peak_gb", "setup_s"]
    assert per_layer == ["payload_ms", "gate_amps_s", "beam_gevals",
                         "k2_item_share"]


def _tree(records):
    by_id = {r["id"]: r for r in records}
    return by_id, lambda r: by_id.get(r["parent"], {}).get("name")


def test_banded_payload_spans_and_beam_evals():
    """A banded run of the cut on the CPU: each chunk's torch payload is a
    prep.payload span, under the snapshots' prep spans and under the
    gate's chunks; the gate's full-channel beam a gate.amps span; the
    torch beam chain counts sources x frequencies as beam.evals in both,
    the node model at the rank's nodes and the gate at every channel."""
    _, sec = _cut("nufft")
    with tracing.on():
        drv.run_simulation(load_parms(sec), save=False, verbose=False,
                           device="cpu")
    recs = tracing.take()
    _, parent = _tree(recs)
    pays = [r for r in recs if r["name"] == "prep.payload"]
    amps = [r for r in recs if r["name"] == "gate.amps"]
    n_chunks = len([r for r in recs if r["name"] == "gate.chunk"])
    assert n_chunks >= 1 and len(amps) == n_chunks
    assert sorted(parent(r) for r in pays) == \
        ["gate.chunk"] * n_chunks + ["prep"] * (2 * n_chunks)
    assert {parent(r) for r in amps} == {"gate.chunk"}
    src_chunk = 2048
    rank = 8                              # 16 channels: half of them
    assert [r["counts"] for r in pays] == \
        [{"beam.evals": src_chunk * rank}] * len(pays)
    assert [r["counts"] for r in amps] == \
        [{"beam.evals": src_chunk * 16}] * len(amps)


def test_airy_banded_run_opens_no_payload_span():
    """A HERA Airy banded run (the truth payload, which the banded prep
    computes itself) opens no prep.payload span; its gate's beam is a
    gate.amps span all the same."""
    cell = dict(H.load_workload("hera331.banded"), engine="nufft")
    config = copy.deepcopy(H.load_config(cell["config"]))
    s = config["sections"]
    s["array"]["layout"] = "HERA-19"
    s["bandpass"].update(nchan=64, freq_resolution=100e6 / 64)
    s["skyparm"]["nside"] = 16
    sec = H.cell_sections(cell, config, LST, SEED, n_acc=2)
    with tracing.on():
        vs, _ = drv.run_simulation(load_parms(sec), save=False,
                                   verbose=False, device="cpu")
    recs = tracing.take()
    names = [r["name"] for r in recs]
    assert [r["attrs"].get("engine") for r in recs
            if r["name"] == "simulation"] == ["banded"]
    assert "prep.payload" not in names
    assert names.count("gate.amps") == names.count("gate.chunk") >= 1
