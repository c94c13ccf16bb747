"""The plain reference against the program on the CPU, and its frozen
host copies against the program's host modules."""

import numpy as np
import pytest
import torch

from gpubench import harness as H
from gpubench.reference import check as C
from gpubench.reference import geometry as G
from gpubench.reference.model import DriftReference

from conftest import tiny


def test_healpix_centres_match_the_program():
    from prisim_tpu_torch import healpix as hp
    for nside in (1, 2, 8, 16):
        ra, dec = G.healpix_ring_radec(nside)
        theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
        np.testing.assert_allclose(ra, np.degrees(phi), atol=1e-10)
        np.testing.assert_allclose(dec, 90.0 - np.degrees(theta), atol=1e-10)


@pytest.mark.parametrize("layout,redundant", [("HERA-7", True),
                                              ("HERA-37", False),
                                              ("HERA-331", True)])
def test_baselines_match_the_program(layout, redundant):
    from prisim_tpu_torch.baselines import build_baselines
    from prisim_tpu_torch.layouts import preset_layout
    got = build_baselines(preset_layout(layout), redundant=redundant).vectors
    np.testing.assert_array_equal(
        G.baselines(G.layout_positions(layout), redundant), got)


def test_schedule_and_precession_match_the_program():
    from prisim_tpu_torch import ephemeris as eph
    from prisim_tpu_torch.config import load_parms
    from prisim_tpu_torch.driver import build_schedule
    cell, config = tiny("hera331.banded")
    sec = H.cell_sections(cell, config, 17.25, 1)
    obs = build_schedule(load_parms(sec), sec["telescope"]["latitude"])
    ref = DriftReference(sec)
    lst, jd = ref.schedule(17.25)
    np.testing.assert_array_equal(lst, obs.lst_deg)
    np.testing.assert_array_equal(jd, obs.jd)
    ra, dec = np.array([10.0, 200.0]), np.array([-30.0, 45.0])
    want = eph.precess_radec(ra, dec, eph.jyear_to_jd(2000.0), jd.mean())
    got = G.precess_radec(ra, dec, G.jyear_to_jd(2000.0), jd.mean())
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("engine,expect", [("direct", "direct"),
                                           ("nufft", "banded")])
def test_reference_against_a_tiny_run(engine, expect):
    """Every number of the check, the program's run against the reference,
    far under the cell's limits; the control far over them."""
    from prisim_tpu_torch.config import load_parms
    cell, config = tiny("hera331.banded", engine=engine)
    sec = H.cell_sections(cell, config, 5.5, 11)
    vs, rec = H.simulate(load_parms(sec), torch.device("cpu"))
    assert rec["error"] is None and rec["engine"] == expect
    ref = DriftReference(sec)
    idx = C.sample_indices(ref, np.random.default_rng(3), cell["sample"])
    got = C.readings(C.keep_sample(vs, idx), ref, 5.5, idx)
    assert got["vis_err"] < 3e-5
    assert got["uvw_err"] < 1e-13 and got["lst_err"] < 1e-12
    assert got["rms_err"] < 1e-14
    assert got["sum_err"] == 0.0
    assert got["noise_z"] < cell["limits"]["noise_z"]
    assert C.judge(got, cell["limits"])
    ctl = C.readings(C.keep_sample(vs, idx), ref, 5.5, idx, "control")
    assert ctl["vis_err"] > cell["limits"]["vis_err"]
    assert not C.judge(ctl, cell["limits"])
    # the phases alone in float32: the sky visibilities move, the noise
    # and the sum are the program's own draw
    p32 = C.readings(C.keep_sample(vs, idx), ref, 5.5, idx, "phase32")
    assert 0.0 < p32["vis_err"] < ctl["vis_err"]
    assert p32["sum_err"] == 0.0 and p32["noise_z"] == got["noise_z"]


def test_pick_simulations():
    rng = np.random.default_rng(5)
    assert C.pick_simulations(3, rng, 8) == [0, 1, 2]
    got = C.pick_simulations(40, rng, 8)
    assert len(got) == 8 == len(set(got))
    assert got[0] == 0 and got[-1] == 39 and got == sorted(got)
    again = C.pick_simulations(40, np.random.default_rng(5), 8)
    assert again == C.pick_simulations(40, np.random.default_rng(5), 8)


def test_calibrate_on_the_cpu():
    """calibrate.py's readings: the program under the limits, the control
    over them, and a planted fault over them."""
    from gpubench import calibrate
    cell, config = tiny("hera37.direct", nchan=128, n_acc=4)
    rows = list(calibrate.calibrate(
        cell, config, [2 ** 33 + 1, 7], 1, "cpu", n_phase32=1,
        fault_names=["noise_doubled"], n_fault=1,
        log=open("/dev/null", "w")))
    assert [r["fault"] for r in rows] == [None, None, "noise_doubled"]
    assert all(r["engine"] == "direct" and r["error"] is None for r in rows)
    lim = cell["limits"]
    assert C.judge(rows[0]["readings"], lim)
    assert C.judge(rows[1]["readings"], lim)
    assert "control" in rows[0] and "control" not in rows[1]
    assert "phase32" in rows[0]
    assert not C.judge(rows[0]["control"], lim)
    assert rows[2]["readings"]["noise_z"] > lim["noise_z"]


def test_sample_spans_lengths_channels_and_snapshots():
    cell, config = tiny("hera37.direct", n_acc=5)
    ref = DriftReference(H.cell_sections(cell, config, 0.0, 1))
    idx = C.sample_indices(ref, np.random.default_rng(0), cell["sample"])
    lens = np.sqrt((ref.bl ** 2).sum(axis=1))
    assert lens[idx["bl"]].min() == lens.min()
    assert lens[idx["bl"]].max() == lens.max()
    assert idx["ch"][0] == 0 and idx["ch"][-1] == ref.nchan - 1
    assert idx["t"][0] == 0 and idx["t"][-1] == 4 and len(idx["t"]) == 3
    again = C.sample_indices(ref, np.random.default_rng(0), cell["sample"])
    assert all(np.array_equal(idx[k], again[k]) for k in idx)


class Float64Only(DriftReference):
    """A reference that offers no precision below float64."""

    precisions = ("float64",)


def test_calibrate_without_a_control(monkeypatch):
    """A configuration whose reference has no control or phase32:
    calibrate.py judges by that class and reports them as not computed."""
    import sys
    import types
    from gpubench import calibrate
    mod = types.ModuleType("gpubench.reference.float64_only")
    mod.Float64Only = Float64Only
    monkeypatch.setitem(sys.modules, "gpubench.reference.float64_only", mod)
    cell, config = tiny("hera37.direct", n_acc=2)
    config = dict(config, reference_class="float64_only.Float64Only")
    rows = list(calibrate.calibrate(cell, config, [5, 6], 1, "cpu",
                                    n_phase32=2, log=open("/dev/null", "w")))
    assert C.judge(rows[0]["readings"], cell["limits"])
    assert rows[0]["control"] == "not computed"
    assert [r["phase32"] for r in rows] == ["not computed"] * 2
    assert "control" not in rows[1]
