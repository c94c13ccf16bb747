"""The port's Jones/Mueller beams (beams/jones.py) and its polarization
routes (beam.pol: XY and full) against prisim_tpu's: the Mueller weights
within 1e-6 of max per component on the keyword cases of
tests/test_jones.py, the XY, XX/YY/XY runs against JAX's on HERA-7, the
sign-indefinite XY component through the banded engine against the
direct engine, the zenith-source leakage case, and the combined 2-pol and
4-pol exports."""

import copy
import os

import numpy as np
import pytest
import torch

import prisim_tpu.beams.jones as jones_jax
from prisim_tpu import config as cfg_jax
from prisim_tpu import driver as drv_jax
from prisim_tpu.io import uvfits as uvfits_jax

from prisim_tpu_torch import config as cfg_t
from prisim_tpu_torch import driver as drv_t
from prisim_tpu_torch.beams import jones as jones_t
from prisim_tpu_torch.io import uvfits as uvfits_t
from prisim_tpu_torch.io.fitsio import read_fits

from test_jones import _f64_mueller, _grid_dircos

MUELLER_BAR = 1e-6     # max|d B| / max|B| per component, port vs JAX
# the runs against JAX's f32 XLA engine (its own error on these small sums
# reads up to ~4e-6 of max|V|; tests/test_torch_driver.py JAX_F32_BAR)
RUN_BAR = 1e-5
GATE_TOL = 2e-6        # the banded gate: max|dV| / max_c sum_s |A|

# tests/test_jones.py:99-106
KW_CASES = {
    "half_wave": dict(half_wave=True, short_dipole=False,
                      ground_height=None),
    "short": dict(half_wave=False, short_dipole=True, ground_height=None),
    "finite_ground": dict(half_wave=False, short_dipole=False,
                          ground_height=0.3, length=1.3),
    "misaligned": dict(half_wave=True, short_dipole=False,
                       ground_height=None, y_orientation_deg=75.0),
}


def _dircos(n=64, seed=0):
    """tests/test_jones.py's directions plus the zenith, the horizon and
    a direction along each dipole axis (the clips' edges)."""
    extra = np.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                        [np.sqrt(0.5), np.sqrt(0.5), 0.0]])
    return np.concatenate([_grid_dircos(n, seed), extra])


@pytest.mark.parametrize("case", sorted(KW_CASES))
def test_mueller_matches_jax(case):
    d = _dircos()
    f = np.asarray([120e6, 150e6, 180e6])
    want = jones_jax.mueller_unpol_weights(d, f, **KW_CASES[case])
    got = jones_t.mueller_unpol_weights(d, f, **KW_CASES[case])
    kw = dict(KW_CASES[case])
    ref = _f64_mueller(d, f, length=kw.pop("length", 1.3),
                       ground_height=kw["ground_height"], ax_deg=0.0,
                       ay_deg=kw.get("y_orientation_deg", 90.0),
                       half_wave=kw["half_wave"],
                       short_dipole=kw["short_dipole"])
    for pq in ("XX", "YY", "XY"):
        g, w = got[pq], np.asarray(want[pq])
        assert g.dtype == torch.float32 and g.shape == w.shape == (68, 3)
        scale = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= MUELLER_BAR * scale, pq
        assert np.abs(g.numpy() - ref[pq]).max() <= 2e-5, pq


@pytest.mark.parametrize("case", sorted(KW_CASES))
def test_dipole_jones_matches_jax(case):
    d = _dircos(seed=4)
    kw = dict(KW_CASES[case])
    kw.pop("y_orientation_deg", None)
    for orient in ((1.0, 0.0, 0.0), (0.3, 0.9, 0.0)):
        amp_j, ev_j = jones_jax.dipole_jones(d, [150e6, 170e6],
                                             orientation_dircos=orient, **kw)
        amp_t, ev_t = jones_t.dipole_jones(d, [150e6, 170e6],
                                           orientation_dircos=orient, **kw)
        assert amp_t.dtype == ev_t.dtype == torch.float32
        for g, w in ((amp_t, amp_j), (ev_t, ev_j)):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= MUELLER_BAR * np.abs(w).max()


def test_mueller_zenith_and_cauchy_schwarz():
    """tests/test_jones.py's zenith and Cauchy-Schwarz checks on the port:
    ideal feeds XX = YY = 1 and XY = 0 at zenith, cos(60 deg) leakage for a
    Y feed at 60 deg, and |B_XY|^2 <= B_XX B_YY everywhere."""
    z = torch.tensor([[0.0, 0.0, 1.0]])
    w = jones_t.mueller_unpol_weights(z, torch.tensor([150e6]))
    assert float(w["XX"]) == pytest.approx(1.0, abs=1e-6)
    assert float(w["YY"]) == pytest.approx(1.0, abs=1e-6)
    assert abs(float(w["XY"])) < 1e-6
    w = jones_t.mueller_unpol_weights(z, [150e6], y_orientation_deg=60.0)
    assert float(w["XY"]) == pytest.approx(0.5, abs=1e-6)
    w = jones_t.mueller_unpol_weights(_grid_dircos(128, seed=3), [150e6])
    xx, yy, xy = (w[k].numpy() for k in ("XX", "YY", "XY"))
    assert (xy ** 2 <= xx * yy + 1e-7).all()
    assert (xy < 0).any() and (xy > 0).any()       # sign-indefinite


def test_mueller_from_jones_matches_jax():
    rng = np.random.default_rng(1)
    shp = (32, 4)
    j = [rng.normal(size=shp) + 1j * rng.normal(size=shp) for _ in range(4)]
    got = jones_t.mueller_from_jones(*j)
    want = jones_jax.mueller_from_jones(*j)
    assert got["XX"].dtype == torch.float32
    assert got["XY"].dtype == torch.complex64
    for pq in ("XX", "YY", "XY"):
        w = np.asarray(want[pq])
        assert np.abs(got[pq].numpy() - w).max() <= 1e-6 * np.abs(w).max()
    swapped = jones_t.mueller_from_jones(j[2], j[3], j[0], j[1])
    np.testing.assert_array_equal(swapped["XY"].numpy(),
                                  np.conj(got["XY"].numpy()))
    real = jones_t.mueller_from_jones(*(x.real for x in j))
    assert real["XY"].dtype == torch.complex64
    assert float(real["XY"].imag.abs().max()) == 0.0


# --------------------------------------------------------------------------
# the driver's polarization routes
# --------------------------------------------------------------------------

def _pol_parms(root, pol, **sections):
    """HERA-7 redundant, 16 ch over 6.25 MHz, 2 accumulations of 600 s, 96
    random sources, no products; `sections` update the sections. An
    unresolved dict: each package loads it."""
    p = {"dirstruct": {"rootdir": str(root), "project": "pol"},
         "telescope": {"id": "hera", "latitude": -30.7},
         "array": {"layout": "HERA-7"},
         "bandpass": {"nchan": 16, "freq": 150e6,
                      "freq_resolution": 390625.0},
         "obsparm": {"n_acc": 2, "t_acc": 600.0},
         "skyparm": {"model": "random", "nsrc": 96, "seed": 7},
         "beam": {"pol": pol},
         "pp": {"key": "none"},
         "save_formats": {"fmt": "none", "npz": False}}
    for sec, val in sections.items():
        p[sec] = dict(p.get(sec, {}), **val)
    return p


POL_RUNS = {
    "xy_hera": ("XY", {}),
    # a dipole along east (antenna.orientation alt 0, az 90; the default
    # zenith orientation is the same for both feeds)
    "dual_mwa_dipole": ("dual", {"telescope": {"id": "mwa_dipole",
                                               "latitude": -26.7},
                                 "antenna": {"orientation": [0.0, 90.0]}}),
    "full_default": ("full", {}),
    "full_ground_misaligned": ("full", {"beam": {"pol": "full", "feeds": {
        "height": 0.3, "half_wave": False, "y_orientation_deg": 75.0}}}),
}


@pytest.mark.parametrize("case", sorted(POL_RUNS))
def test_pol_runs_match_jax(tmp_path, case):
    pol, sections = POL_RUNS[case]
    p = _pol_parms(tmp_path, pol, **sections)
    outs_j, _ = drv_jax.run_simulation(cfg_jax.load_parms(copy.deepcopy(p)),
                                       verbose=False, save=False)
    outs_t, dir_t = drv_t.run_simulation(cfg_t.load_parms(copy.deepcopy(p)),
                                         verbose=False, save=False,
                                         device="cpu")
    assert dir_t is None
    assert len(outs_t) == len(outs_j) == (3 if pol == "full" else 2)
    for vt, vj in zip(outs_t, outs_j):
        assert vt.skyvis.shape == vj.skyvis.shape == (9, 16, 2)
        assert vt.skyvis.dtype == np.complex64
        scale = np.abs(vj.skyvis).max()
        assert scale > 0
        assert np.abs(vt.skyvis - vj.skyvis).max() / scale < RUN_BAR
    if case == "xy_hera":          # a circular dish: X and Y are one beam
        np.testing.assert_array_equal(outs_t[0].skyvis, outs_t[1].skyvis)
    if case == "dual_mwa_dipole":  # a dipole: X and Y differ
        assert np.abs(outs_t[0].skyvis - outs_t[1].skyvis).max() > 1e-3 * \
            np.abs(outs_t[0].skyvis).max()


def test_sectors_split_before_the_pol_route(tmp_path):
    """processing.n_sky_sectors with beam.pol full: the sectors split
    first, each sector's run is a full-pol run (a list of the XX, YY and
    XY outputs, or None for an empty sector), as in JAX; each output
    against JAX's, and the sectors of each component sum to its full
    run."""
    p = _pol_parms(tmp_path, "full", processing={"n_sky_sectors": 2})
    outs_j, _ = drv_jax.run_simulation(cfg_jax.load_parms(copy.deepcopy(p)),
                                       verbose=False, save=False)
    outs_t, _ = drv_t.run_simulation(cfg_t.load_parms(copy.deepcopy(p)),
                                     verbose=False, save=False, device="cpu")
    assert len(outs_t) == len(outs_j) == 2
    for sec_t, sec_j in zip(outs_t, outs_j):
        assert (sec_t is None) == (sec_j is None)
        if sec_t is None:
            continue
        assert len(sec_t) == len(sec_j) == 3
        for vt, vj in zip(sec_t, sec_j):
            scale = np.abs(vj.skyvis).max()
            assert np.abs(vt.skyvis - vj.skyvis).max() / scale < RUN_BAR
    full, _ = drv_t.run_simulation(cfg_t.load_parms(_pol_parms(
        tmp_path, "full")), verbose=False, save=False, device="cpu")
    for k, vf in enumerate(full):
        tot = sum(sec[k].skyvis for sec in outs_t if sec is not None)
        assert np.abs(tot - vf.skyvis).max() <= 2e-4 * np.abs(vf.skyvis).max()


def test_component_beams_are_the_mueller_weights(tmp_path):
    """A full-pol component run's beam is mueller_unpol_weights(...)[comp]
    of the beam.feeds keywords, takes no pointing and no truth beam, and a
    bad component raises."""
    p = cfg_t.load_parms(_pol_parms(tmp_path, "X", beam={"feeds": {
        "height": 0.3, "y_orientation_deg": 80.0, "length": 2.0,
        "half_wave": False}}))
    d = torch.as_tensor(_dircos(), dtype=torch.float32)
    f = torch.tensor([140e6, 160e6])
    for comp in ("XX", "YY", "XY"):
        p["_mueller_component"] = comp
        sim = drv_t.prepare_simulation(p, torch.device("cpu"))
        assert not sim.beam_fn.needs_pointing
        assert not hasattr(sim.beam_fn, "df_eval")
        want = jones_t.mueller_unpol_weights(
            d, f, length=2.0, ground_height=0.3, y_orientation_deg=80.0,
            half_wave=False)[comp]
        torch.testing.assert_close(sim.beam_fn(d, f), want, rtol=0, atol=0)
    p["_mueller_component"] = "YX"
    with pytest.raises(ValueError, match="_mueller_component"):
        drv_t.prepare_simulation(p, torch.device("cpu"))


def _run_dumped(parms, dump, **kw):
    os.environ["PRISIM_DEBUG_XCHECK_DUMP"] = str(dump)
    try:
        out = drv_t.run_simulation(parms, verbose=False, save=False,
                                   device="cpu", **kw)
    finally:
        del os.environ["PRISIM_DEBUG_XCHECK_DUMP"]
    with np.load(dump) as d:
        return out, dict(d)


def _amplitudes(parms):
    """The (T, S, C) amplitudes of a run's snapshots."""
    from prisim_tpu_torch.engine import observe
    sim = drv_t.prepare_simulation(parms, torch.device("cpu"))
    Mh, Ml, pch, pcl = observe.schedule_tensors(sim.obs, sim.inst.latitude,
                                                "cpu")
    return torch.stack([observe.snapshot_nudft_inputs(
        sim.inst, sim.sky, Mh[t], Ml[t], pch[t], pcl[t], sim.beam_fn)[2]
        for t in range(Mh.shape[0])])


def _coherent_scale(parms):
    """max over snapshots and channels of sum_s |A_sc| of a run."""
    return float(_amplitudes(parms).abs().sum(dim=1).max())


@pytest.mark.parametrize("comp", ["XX", "XY"])
def test_xy_component_banded_matches_direct(tmp_path, comp):
    """The sign-indefinite XY Mueller weight (and XX beside it) through the
    banded engine (plain K2 behind its gate, f32 amplitudes: a component
    run has no truth beam) against the direct engine: the gate passes
    without demotion and the whole run agrees within the gate's 2e-6 of
    the coherent scale. HERA-7 non-redundant, 32 ch over 12.5 MHz, 256
    random sources, 3 accumulations."""
    base = _pol_parms(tmp_path, "X", array={"layout": "HERA-7",
                                            "redundant": False},
                      bandpass={"nchan": 32}, obsparm={"n_acc": 3},
                      skyparm={"nsrc": 256})
    runs = {}
    for engine in ("nufft", "direct"):
        p = cfg_t.load_parms(dict(copy.deepcopy(base),
                                  processing={"engine": engine}))
        p["_mueller_component"] = comp
        runs[engine] = p
    (vb, _), gate = _run_dumped(runs["nufft"], tmp_path / "gate.npz")
    vd, _ = drv_t.run_simulation(runs["direct"], verbose=False, save=False,
                                 device="cpu")
    assert bool(gate["ok0"]) and not bool(gate["truth_on"])
    cs0 = float(gate["csA0"])
    assert np.abs(gate["fast0"] - gate["direct0"]).max() / cs0 <= GATE_TOL
    amps = _amplitudes(runs["direct"])
    if comp == "XY":                       # both signs across the sky
        assert float(amps.min()) < 0 < float(amps.max())
    coherent = float(amps.abs().sum(dim=1).max())
    assert np.abs(vb.skyvis - vd.skyvis).max() / coherent <= GATE_TOL
    np.testing.assert_array_equal(vb.vis_noise, vd.vis_noise)


def test_full_pol_engine_nufft_runs_every_component_banded(tmp_path, capsys):
    """beam.pol full on engine nufft: each of the three component runs takes
    the banded engine behind its gate (none demotes), and each agrees with
    the direct engine's component within 2e-6 of its coherent scale."""
    p = _pol_parms(tmp_path, "full", array={"layout": "HERA-7",
                                             "redundant": False},
                   bandpass={"nchan": 32})
    out_b, _ = drv_t.run_simulation(cfg_t.load_parms(dict(
        copy.deepcopy(p), processing={"engine": "nufft"})), verbose=True,
        save=False, device="cpu")
    log = capsys.readouterr().out
    assert log.count("banded NUFFT:") == 3 and log.count("cross-check ok") == 3
    assert "falling back" not in log
    pd = cfg_t.load_parms(dict(copy.deepcopy(p),
                               processing={"engine": "direct"}))
    out_d, _ = drv_t.run_simulation(pd, verbose=False, save=False,
                                    device="cpu")
    for comp, vb, vd in zip(("XX", "YY", "XY"), out_b, out_d):
        pc = copy.deepcopy(pd)
        pc["beam"]["pol"] = "X"
        pc["_mueller_component"] = comp
        coherent = _coherent_scale(pc)
        assert np.abs(vb.skyvis - vd.skyvis).max() / coherent <= GATE_TOL


def _zenith_parms(root, cat, y_deg=90.0, simid=None, **save):
    """tests/test_jones.py:161's full-pol run: a delta element, HERA-7, 8
    ch, one 10 s accumulation at LST 40 deg, the catalog `cat`."""
    return cfg_t.load_parms({
        "dirstruct": {"rootdir": str(root), "project": "fp", "simid": simid},
        "telescope": {"id": "custom", "latitude": -30.7224},
        "antenna": {"shape": "delta"},
        "beam": {"pol": "full",
                 "feeds": {"length": 1.3, "height": None,
                           "y_orientation_deg": y_deg}},
        "bandpass": {"nchan": 8, "freq": 150e6,
                     "freq_resolution": 97656.25},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 10.0},
        "pointing": {"lst_init": 40.0 / 15.0},
        "skyparm": {"model": "custom", "flux_min": None, "epoch": None},
        "catalog": {"custom_file": cat},
        "save_formats": dict({"fmt": "none", "npz": False}, **save),
    })


def test_fullpol_zenith_source_leakage(tmp_path):
    """tests/test_jones.py:181 on the port: one zenith source gives
    V_XX = flux and V_XY = 0 for ideal feeds, V_XY / V_XX = cos(60 deg)
    with the Y feed at 60 deg."""
    cat = str(tmp_path / "zen.txt")
    np.savetxt(cat, np.asarray([[40.0, -30.7224, 10.0, 0.0]]))
    out, _ = drv_t.run_simulation(_zenith_parms(tmp_path, cat),
                                  verbose=False, save=False, device="cpu")
    assert np.abs(np.abs(out[0].skyvis) - 10.0).max() < 1e-3
    assert np.abs(out[1].skyvis - out[0].skyvis).max() < 1e-3
    assert np.abs(out[2].skyvis).max() < 1e-3
    out2, _ = drv_t.run_simulation(_zenith_parms(tmp_path, cat, y_deg=60.0),
                                   verbose=False, save=False, device="cpu")
    ratio = np.abs(out2[2].skyvis) / np.abs(out2[0].skyvis)
    np.testing.assert_allclose(ratio, np.cos(np.radians(60.0)), atol=1e-3)


def _fitscube(path, npol):
    (gh,) = [h for h in read_fits(path) if "pars" in h]
    assert int(gh["header"]["NAXIS3"]) == npol
    return gh["data"].reshape(gh["data"].shape[0], -1, npol, 3)


@pytest.mark.parametrize("uvh5", [False, True])
def test_fullpol_exports(tmp_path, uvh5):
    """tests/test_jones.py:204 on the port's combined 4-pol export: real,
    unflagged cross-pols that round-trip to the simulated XY cube, XY = YX.
    The UVFITS file is always written, the UVH5 one only with
    save_formats.uvh5 (the reference writes it always); both packages
    read the UVFITS file."""
    import h5py
    cat = str(tmp_path / "two.txt")
    np.savetxt(cat, np.asarray([[40.0, -30.7224, 10.0, 0.0],
                                [43.0, -25.0, 6.0, -0.7]]))
    (vs_xx, vs_yy, vs_xy), outdir = drv_t.run_simulation(
        _zenith_parms(tmp_path, cat, y_deg=70.0, simid="fp", uvh5=uvh5),
        verbose=False, device="cpu")
    assert outdir == os.path.join(str(tmp_path), "fp", "fp_xx")
    base = os.path.join(outdir, "simdata", "simvis_fullpol")
    nbl, nchan = vs_xy.nbl, vs_xy.nchan
    d = _fitscube(base + ".uvfits", 4)
    assert (d[:, :, :, 2] > 0).all()
    for p, vs in enumerate((vs_xx, vs_yy, vs_xy, vs_xy)):
        v = np.conj(d[:, :, p, 0] + 1j * d[:, :, p, 1])
        np.testing.assert_array_equal(v.reshape(1, nbl, nchan).transpose(
            1, 2, 0), vs.skyvis)
    assert np.abs(vs_xy.skyvis).max() > 0.1
    for mod in (uvfits_jax, uvfits_t):
        np.testing.assert_array_equal(mod.load_uvfits(base + ".uvfits")
                                      .skyvis, vs_xx.skyvis)
    assert os.path.exists(base + ".uvh5") == uvh5
    if uvh5:
        with h5py.File(base + ".uvh5", "r") as f:
            np.testing.assert_array_equal(f["Header/polarization_array"][()],
                                          [-5, -6, -7, -8])
            vis = f["Data/visdata"][()]
            assert not f["Data/flags"][()][:, :, 2:].any()
            assert (f["Data/nsamples"][()][:, :, 2:] == 1.0).all()
        np.testing.assert_array_equal(np.conj(vis[:, :, 2]).reshape(
            1, nbl, nchan).transpose(1, 2, 0), vs_xy.skyvis)
        np.testing.assert_array_equal(vis[:, :, 2], vis[:, :, 3])


def test_dualpol_exports(tmp_path):
    """beam.pol XY with products: each feed's own products under
    <simid>_polX / _polY, the combined 2-pol (XX, YY) and 4-pol (the
    cross-pols flagged zeros) UVFITS files under the X run, as JAX writes
    them (the same bytes but the HISTORY card on the same sky, noise
    aside: the noiseless cubes are held to each other)."""
    p = _pol_parms(tmp_path, "XY", dirstruct={"simid": "dual"},
                   save_formats={"fmt": "none", "npz": True})
    (vx, vy), outdir = drv_t.run_simulation(cfg_t.load_parms(p),
                                            verbose=False, device="cpu")
    assert outdir == os.path.join(str(tmp_path), "pol", "dual_polX")
    assert os.path.exists(os.path.join(str(tmp_path), "pol", "dual_polY",
                                       "simdata", "simvis.npz"))
    sd = os.path.join(outdir, "simdata")
    assert sorted(os.listdir(sd)) == ["simvis.npz", "simvis_4pol.uvfits",
                                      "simvis_dualpol.uvfits"]
    d2 = _fitscube(os.path.join(sd, "simvis_dualpol.uvfits"), 2)
    d4 = _fitscube(os.path.join(sd, "simvis_4pol.uvfits"), 4)
    np.testing.assert_array_equal(d4[:, :, :2], d2)
    assert (d4[:, :, 2:, :2] == 0).all() and (d4[:, :, 2:, 2] < 0).all()
    for p_, vs in enumerate((vx, vy)):
        v = np.conj(d2[:, :, p_, 0] + 1j * d2[:, :, p_, 1])
        np.testing.assert_array_equal(
            v.reshape(vs.n_acc, vs.nbl, vs.nchan).transpose(1, 2, 0),
            vs.skyvis)
