"""The port's run_simulation against prisim_tpu.driver.run_simulation on
the small HERA-19 example (shrunk as tests/test_driver.py shrinks it), on
HERA-7 gradient and extended-source runs (a 7-column custom catalog, a DSM
FITS map, an NVSS catalog), on the banded NUFFT engine's example, on the
beam routes, and with the products (native FITS, UVFITS/UVH5 with
save_redundant, figures) and the FITS inputs (HI cubes, PFB tables)."""

import copy
import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

from prisim_tpu import config as cfg_jax
from prisim_tpu import driver as drv_jax
from prisim_tpu import io as io_jax
from prisim_tpu import vis as vis_jax

from prisim_tpu_torch import config as cfg_t
from prisim_tpu_torch import driver as drv_t
from prisim_tpu_torch.vis import delay_transform

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "prisim_tpu",
                       "examples", "simparms", "hera19_random.yaml")
NUFFT_EXAMPLE = os.path.join(os.path.dirname(EXAMPLE), "hera7_nufft.yaml")
BAR = 2e-6     # max|dskyvis| / max|skyvis|


def _parms(root, **over):
    p = cfg_jax.load_parms(os.path.abspath(EXAMPLE))
    p["bandpass"]["nchan"] = 16
    p["obsparm"]["n_acc"] = 2
    p["skyparm"]["nsrc"] = 32
    p["dirstruct"]["rootdir"] = str(root)
    p["save_formats"]["uvfits"] = False
    p["save_formats"]["uvh5"] = False
    p["processing"]["engine"] = "direct"
    for dotted, val in over.items():
        if "." not in dotted:
            p[dotted] = val
            continue
        sec, key = dotted.split(".")
        p[sec][key] = val
    return p


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("drv")
    vj, dj = drv_jax.run_simulation(_parms(root / "jax"), verbose=False)
    vt, dt = drv_t.run_simulation(_parms(root / "torch"), verbose=False,
                                  device="cpu")
    vt2, _ = drv_t.run_simulation(_parms(root / "t2"), verbose=False,
                                  save=False, device="cpu")
    return dict(vj=vj, dj=dj, vt=vt, dt=dt, vt2=vt2, root=root)


def test_skyvis_matches_jax(runs):
    vj, vt = runs["vj"], runs["vt"]
    assert vt.skyvis.shape == vj.skyvis.shape == (30, 16, 2)
    assert vt.skyvis.dtype == np.complex64
    scale = np.abs(vj.skyvis).max()
    assert np.abs(vt.skyvis - vj.skyvis).max() / scale < BAR


def test_metadata_matches_jax(runs):
    vj, vt = runs["vj"], runs["vt"]
    np.testing.assert_array_equal(vt.vis_rms, vj.vis_rms)
    for name in ("baselines", "freqs", "lst", "timestamps", "t_acc", "bp",
                 "bp_wts", "Tsys", "projected_baselines", "phase_center"):
        np.testing.assert_array_equal(getattr(vt, name), getattr(vj, name),
                                      err_msg=name)
    np.testing.assert_array_equal(vt.labels, vj.labels)
    assert vt.blgroups == vj.blgroups


def test_noise_statistics_and_seed(runs):
    vt, vt2 = runs["vt"], runs["vt2"]
    for part in (vt.vis_noise.real, vt.vis_noise.imag):
        ratio = np.std(part) / (vt.vis_rms.mean() / np.sqrt(2))
        assert 0.8 < ratio < 1.2
    np.testing.assert_array_equal(vt.vis_noise, vt2.vis_noise)
    np.testing.assert_array_equal(vt.vis, vt.skyvis * 1.0 + vt.vis_noise)


def test_other_seed_other_noise(tmp_path):
    vs, _ = drv_t.run_simulation(_parms(tmp_path, **{"skyparm.seed": 7}),
                                 verbose=False, save=False, device="cpu")
    vs2, _ = drv_t.run_simulation(_parms(tmp_path, **{"skyparm.seed": 8}),
                                  verbose=False, save=False, device="cpu")
    assert not np.array_equal(vs.vis_noise, vs2.vis_noise)


def _h5_keys(path):
    keys = []
    with h5py.File(path, "r") as f:
        f.visit(keys.append)
    return sorted(keys)


def test_products_load_with_jax_readers(runs):
    vt = runs["vt"]
    base_t = os.path.join(runs["dt"], "simdata", "simvis")
    base_j = os.path.join(runs["dj"], "simdata", "simvis")
    back = io_jax.load_hdf5(base_t + ".hdf5")
    np.testing.assert_array_equal(back.skyvis, vt.skyvis)
    np.testing.assert_array_equal(back.vis, vt.vis)
    np.testing.assert_array_equal(back.projected_baselines,
                                  vt.projected_baselines)
    assert _h5_keys(base_t + ".hdf5") == _h5_keys(base_j + ".hdf5")
    npz = io_jax.load_npz(base_t + ".npz")
    np.testing.assert_array_equal(npz.skyvis, vt.skyvis)
    with np.load(base_t + ".npz") as a, np.load(base_j + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
    assert os.path.exists(os.path.join(runs["dt"], "metainfo",
                                       "simparms.yaml"))


def test_port_readers_round_trip(runs):
    from prisim_tpu_torch.io import load_hdf5, load_npz
    base_t = os.path.join(runs["dt"], "simdata", "simvis")
    back = load_hdf5(base_t + ".hdf5")
    np.testing.assert_array_equal(back.vis_rms, runs["vt"].vis_rms)
    np.testing.assert_array_equal(load_npz(base_t + ".npz").skyvis,
                                  runs["vt"].skyvis)


def test_delay_transform_matches_jax(runs):
    vt = runs["vt"]
    vj = vis_jax.VisibilitySet(**{f.name: getattr(vt, f.name)
                                  for f in dataclasses.fields(vt)})
    dt_t = delay_transform(vt, pad=1.0, device="cpu")
    dt_j = vis_jax.delay_transform(vj, pad=1.0)
    np.testing.assert_array_equal(dt_t.lags, dt_j.lags)
    for name in ("skyvis_lag", "vis_lag", "vis_noise_lag", "lag_kernel"):
        a, b = getattr(dt_t, name), np.asarray(getattr(dt_j, name))
        assert a.shape == b.shape
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-5, name


@pytest.mark.parametrize("over", [
    {"processing.engine": "nufft", "processing.nufft_spread": "bogus"},
    {"pp.mesh_axes": ["bl"]},
])
def test_unported_branches_raise_before_compute(tmp_path, monkeypatch,
                                                over):
    """An unknown processing.nufft_spread, and a pp.mesh_axes that does not
    fit the run's devices (here one axis for one CPU device), raise
    ValueError before any compute (the sorted spread is ported:
    tests/test_torch_nufft_delay.py)."""
    def no_compute(*a, **k):
        raise AssertionError("compute reached")
    monkeypatch.setattr(drv_t, "simulate_drift", no_compute)
    monkeypatch.setattr(drv_t, "prepare_simulation", no_compute)
    match = "mesh_axes" if "pp.mesh_axes" in over else "nufft_spread"
    with pytest.raises(ValueError, match=match):
        drv_t.run_simulation(_parms(tmp_path, **over), verbose=False,
                             device="cpu")


@pytest.mark.parametrize("over", [
    {"pp.n_chunks": 2},
    {"diagnosis.jax_profile": "profile_dir"},
    {"diagnosis.resource_monitor": True},
])
def test_chunked_and_diagnosis_branches_are_accepted(tmp_path, over):
    """pp.n_chunks and the diagnosis section are ported (chunked runs,
    tests/test_torch_chunked.py): check_supported lets them through."""
    drv_t.check_supported(_parms(tmp_path, **over), torch.device("cpu"))


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        drv_t.run_simulation(_parms(tmp_path), verbose=False)


def test_use_pallas_false_on_cuda_raises(tmp_path):
    parms = _parms(tmp_path, **{"processing.use_pallas": False})
    with pytest.raises(ValueError, match="K1a"):
        drv_t.check_supported(parms, torch.device("cuda"))
    drv_t.check_supported(parms, torch.device("cpu"))


def test_config_schema_matches_jax():
    assert cfg_t.DEFAULT_PARMS == cfg_jax.DEFAULT_PARMS
    custom = {"array": {"layout": "HERA-37", "redundant": False},
              "bandpass": {"nchan": 1024}, "skyparm": {"model": "usm"}}
    assert cfg_t.load_parms(custom) == cfg_jax.load_parms(custom)
    with pytest.raises(KeyError):
        cfg_t.load_parms({"array": {"no_such_key": 1}})


def test_cli_runs_on_cpu(tmp_path):
    import yaml
    p = _parms(tmp_path)
    p["save_formats"]["fmt"] = "none"
    path = tmp_path / "parms.yaml"
    path.write_text(yaml.safe_dump(p))
    drv_t.main(["-i", str(path), "-q", "--device", "cpu",
                "-o", str(tmp_path / "out")])
    with np.load(tmp_path / "out" / "simdata" / "simvis.npz") as d:
        assert d["skyvis_freq"].shape == (30, 16, 2)


def test_roi_radius_matches_jax(tmp_path):
    over = {"skyparm.roi_radius": 40.0, "skyparm.nsrc": 64}
    vj, _ = drv_jax.run_simulation(_parms(tmp_path / "j", **over),
                                   verbose=False, save=False)
    vt, _ = drv_t.run_simulation(_parms(tmp_path / "t", **over),
                                 verbose=False, save=False, device="cpu")
    scale = np.abs(vj.skyvis).max()
    assert scale > 0
    # The cut is what this checks: a different source subset differs at
    # O(1). The JAX XLA engine's own f32 error on this small, strongly
    # cancelling sum is 2.4e-6 of max|V| (the port's is 4e-8), so the
    # bar here is 1e-5 rather than the engines' 2e-6.
    assert np.abs(vt.skyvis - vj.skyvis).max() / scale < 1e-5


@pytest.mark.parametrize("shape", ["delta", "dish", "gaussian"])
def test_generic_beam_shapes_match_jax(shape):
    """The generic element shapes of beams/dispatch.py, fed the same
    f32 direction cosines in both packages."""
    import jax.numpy as jnp
    from prisim_tpu.beams.dispatch import primary_beam as pb_jax
    from prisim_tpu_torch.beams.dispatch import primary_beam as pb_t
    rng = np.random.RandomState(3)
    s = rng.randn(200, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    s = s.astype(np.float32)
    f = (140e6 + 1e6 * np.arange(8)).astype(np.float32)
    tel = {"id": "custom", "shape": shape, "size": 14.0}
    want = np.asarray(pb_jax(jnp.asarray(s), jnp.asarray(f), tel))
    got = pb_t(torch.as_tensor(s), torch.as_tensor(f), tel).numpy()
    assert got.shape == (200, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# --------------------------------------------------------------------------
# the banded NUFFT engine (processing.engine: nufft)
# --------------------------------------------------------------------------

def _nufft_parms(root):
    p = cfg_jax.load_parms(os.path.abspath(NUFFT_EXAMPLE))
    p["plots"] = False
    p["dirstruct"]["rootdir"] = str(root)
    return p


def _run_dumped(run, parms, dump, **kw):
    """run(parms, ...) with the engine gate's pair dumped to `dump`."""
    os.environ["PRISIM_DEBUG_XCHECK_DUMP"] = str(dump)
    try:
        vs, _ = run(parms, verbose=False, save=False, **kw)
    finally:
        del os.environ["PRISIM_DEBUG_XCHECK_DUMP"]
    with np.load(dump) as d:
        return vs, dict(d)


@pytest.fixture(scope="module")
def nufft_runs(tmp_path_factory):
    """examples/simparms/hera7_nufft.yaml (HERA-7 redundant, 128 ch, 512
    random sources, 2 acc, truth amps) without its plots: JAX's banded
    spread (interpret mode, one device), the port's banded engine on the
    CPU, and the port's direct engine."""
    root = tmp_path_factory.mktemp("nufft")
    pj = _nufft_parms(root)
    pj["pp"]["key"] = "none"
    pj["processing"]["nufft_spread"] = "banded"
    vj, gj = _run_dumped(drv_jax.run_simulation, pj, root / "gj.npz")
    vt, gt = _run_dumped(drv_t.run_simulation, _nufft_parms(root),
                         root / "gt.npz", device="cpu")
    pd = _nufft_parms(root)
    pd["processing"]["engine"] = "direct"
    vd, _ = drv_t.run_simulation(pd, verbose=False, save=False,
                                 device="cpu")
    return dict(vj=vj, gj=gj, vt=vt, gt=gt, vd=vd)


def test_nufft_example_matches_jax(nufft_runs):
    """The port's banded run against JAX's, both behind their gates: 2e-6
    of the coherent scale max_c sum_s |A| (JAX's f32 spread and post)."""
    vj, vt, gt = nufft_runs["vj"], nufft_runs["vt"], nufft_runs["gt"]
    assert vt.skyvis.shape == vj.skyvis.shape == (9, 128, 2)
    assert bool(gt["truth_on"]) and bool(gt["ok0"])
    coherent = float(gt["csA0"])
    np.testing.assert_allclose(coherent, float(nufft_runs["gj"]["csA0"]),
                               rtol=1e-6)
    assert np.abs(vt.skyvis - vj.skyvis).max() / coherent <= 2e-6
    # the gate itself: the port's banded snapshot 0 against its direct
    # engine on the same model amps, at the port's 2e-6 default
    dmax = np.abs(gt["fast0"] - gt["direct0"]).max()
    assert dmax / coherent <= 2e-6


def test_nufft_example_matches_direct_engine(nufft_runs):
    """The port's banded run against its own direct run. In truth mode the
    banded engine sums the float64 Airy model and the direct engine the
    f32 hera beam, which differ per element by the gate's amps-space
    residual (5.4e-6 of max|A| here); so the runs differ by at most that
    residual times the coherent scale: 1e-5 of the coherent scale."""
    vt, vd, gt = nufft_runs["vt"], nufft_runs["vd"], nufft_runs["gt"]
    coherent = float(gt["csA0"])
    assert 0 < float(gt["resid0"]) <= 1e-5
    assert np.abs(vt.skyvis - vd.skyvis).max() / coherent <= 1e-5
    np.testing.assert_array_equal(vt.vis_noise, vd.vis_noise)


_OCTAVE = {
    "telescope": {"id": "custom"},
    "bandpass": {"nchan": 32, "freq": 150e6,
                 "freq_resolution": 3.125e6},   # 100-200 MHz octave
    "array": {"layout": "HERA-7"},
    "obsparm": {"n_acc": 1, "t_acc": 60.0},
    "skyparm": {"model": "random", "nsrc": 128, "seed": 5},
    "save_formats": {"fmt": "none", "npz": False},
}


def test_low_rank_demotes_to_direct(capsys):
    """As tests/test_round4.py does for JAX: rank 4 over an octave is far
    too low for the band, the gate (here its amps-space residual) fails,
    and the run is the direct engine's, bit for bit."""
    p = cfg_t.load_parms(dict(_OCTAVE, processing={
        "engine": "nufft", "nufft_rank": 4}))
    vs, _ = drv_t.run_simulation(p, verbose=True, save=False, device="cpu")
    out = capsys.readouterr().out
    assert "cross-check FAILED" in out and "model resid" in out
    assert "falling back to the direct engine" in out
    p2 = cfg_t.load_parms(dict(_OCTAVE, processing={"engine": "direct"}))
    vs2, _ = drv_t.run_simulation(p2, verbose=False, save=False,
                                  device="cpu")
    np.testing.assert_array_equal(vs.skyvis, vs2.skyvis)


def _reject_plans(monkeypatch):
    from prisim_tpu_torch.engine.nufft_banded import PlanRejected

    def reject(*a, **k):
        raise PlanRejected("too many delay rows")
    monkeypatch.setattr(drv_t, "make_banded_plan", reject)


def test_rejected_plan_demotes_to_direct(capsys, monkeypatch):
    _reject_plans(monkeypatch)
    p = cfg_t.load_parms(dict(_OCTAVE, processing={"engine": "nufft"}))
    vs, _ = drv_t.run_simulation(p, verbose=False, save=False, device="cpu")
    out = capsys.readouterr().out
    assert "plan rejected (too many delay rows)" in out
    p2 = cfg_t.load_parms(dict(_OCTAVE, processing={"engine": "direct"}))
    vs2, _ = drv_t.run_simulation(p2, verbose=False, save=False,
                                  device="cpu")
    np.testing.assert_array_equal(vs.skyvis, vs2.skyvis)


def test_engine_auto_on_cpu_is_direct(monkeypatch):
    """'auto' picks the banded engine on a card only; on the CPU it is the
    direct engine and never builds the banded one."""
    def no_banded(*a, **k):
        raise AssertionError("banded engine built")
    monkeypatch.setattr(drv_t, "banded_engine", no_banded)
    p = cfg_t.load_parms(dict(_OCTAVE, processing={"engine": "auto"}))
    vs, _ = drv_t.run_simulation(p, verbose=False, save=False, device="cpu")
    p2 = cfg_t.load_parms(dict(_OCTAVE, processing={"engine": "direct"}))
    vs2, _ = drv_t.run_simulation(p2, verbose=False, save=False,
                                  device="cpu")
    np.testing.assert_array_equal(vs.skyvis, vs2.skyvis)
    assert drv_t._resolve_engine(p, torch.device("cuda")) == "nufft"
    assert drv_t._resolve_engine(p, torch.device("cpu")) == "direct"


CPU8 = ["cpu"] * 8


def test_rejected_plan_on_the_mesh_demotes_to_the_direct_mesh(
        capsys, monkeypatch):
    """A rejected plan on the eight-device banded 'bl' mesh demotes the
    run to the direct engine, which takes pp.key's mesh: the visibilities
    of an engine: direct run on that mesh, bit for bit."""
    _reject_plans(monkeypatch)
    p = cfg_t.load_parms(dict(_OCTAVE, processing={"engine": "nufft"},
                              pp={"key": "freq"}))
    vs, _ = drv_t.run_simulation(p, verbose=True, save=False, devices=CPU8)
    out = capsys.readouterr().out
    assert "banded NUFFT plan rejected (too many delay rows)" in out
    assert "direct engine on a {'bl': 1, 'chan': 8} mesh" in out
    p2 = cfg_t.load_parms(dict(_OCTAVE, processing={"engine": "direct"},
                               pp={"key": "freq"}))
    vs2, _ = drv_t.run_simulation(p2, verbose=False, save=False,
                                  devices=CPU8)
    np.testing.assert_array_equal(vs.skyvis, vs2.skyvis)


_GRAD_NOTE = ("processing.gradient_mode asks for baseline gradients, which "
              "the NUFFT engine does not compute; running the direct engine")
_SHAPE_NOTE = ("the sky has source shapes (extended sources), which the "
               "NUFFT engine does not compute; running the direct engine")
_EXT_NOTE = ("beam.use_external: the external-beam route runs the direct "
             "engine, without gradients")
# name: (devices, processing, pp, beam, shaped sky) -> (engine, mesh shape
# or None, the notice printed or None)
ROUTES = {
    "auto_one": (1, {"engine": "auto"}, {}, {}, False, "direct", None, None),
    "direct_one": (1, {"engine": "direct"}, {}, {}, False, "direct", None,
                   None),
    "nufft_one": (1, {"engine": "nufft"}, {}, {}, False, "banded", None,
                  None),
    "banded_one": (1, {"engine": "nufft", "nufft_spread": "banded"}, {}, {},
                   False, "banded", None, None),
    "sorted_one": (1, {"engine": "nufft", "nufft_spread": "sorted"}, {}, {},
                   False, "sorted", None, None),
    "scatter_one": (1, {"engine": "nufft", "nufft_spread": "scatter"}, {},
                    {}, False, "sorted", None, None),
    "gradient_nufft_one": (1, {"engine": "nufft",
                               "gradient_mode": "baseline"}, {}, {}, False,
                           "direct", None, _GRAD_NOTE),
    "gradient_direct_one": (1, {"engine": "direct",
                                "gradient_mode": "baseline"}, {}, {}, False,
                            "direct", None, None),
    "shaped_nufft_one": (1, {"engine": "nufft"}, {}, {}, True, "direct",
                         None, _SHAPE_NOTE),
    "external_nufft_one": (1, {"engine": "nufft"}, {},
                           {"use_external": True, "file": "b.fits"}, False,
                           "external", None, _EXT_NOTE),
    "external_direct_one": (1, {"engine": "direct"}, {},
                            {"use_external": True, "file": "b.fits"}, False,
                            "external", None, None),
    "external_without_file": (1, {"engine": "nufft"}, {},
                              {"use_external": True}, False, "banded", None,
                              None),
    "auto_freq": (8, {"engine": "auto"}, {"key": "freq"}, {}, False,
                  "direct", {"bl": 1, "chan": 8}, None),
    "direct_freq": (8, {"engine": "direct"}, {"key": "freq"}, {}, False,
                    "direct", {"bl": 1, "chan": 8}, None),
    "direct_bl": (8, {"engine": "direct"}, {"key": "bl"}, {}, False,
                  "direct", {"bl": 8, "chan": 1}, None),
    "direct_src": (8, {"engine": "direct"}, {"key": "src"}, {}, False,
                   "direct", {"bl": 1, "chan": 1, "src": 8}, None),
    "direct_none": (8, {"engine": "direct"}, {"key": "none"}, {}, False,
                    "direct", None, None),
    "direct_freq_2x4": (8, {"engine": "direct"},
                        {"key": "freq", "mesh_axes": [2, 4]}, {}, False,
                        "direct", {"bl": 2, "chan": 4}, None),
    "direct_bl_4x2": (8, {"engine": "direct"},
                      {"key": "bl", "mesh_axes": [4, 2]}, {}, False,
                      "direct", {"bl": 4, "chan": 2}, None),
    "direct_src_2x2x2": (8, {"engine": "direct"},
                         {"key": "src", "mesh_axes": [2, 2, 2]}, {}, False,
                         "direct", {"bl": 2, "chan": 2, "src": 2}, None),
    "nufft_freq": (8, {"engine": "nufft"}, {"key": "freq"}, {}, False,
                   "banded", {"bl": 8, "chan": 1}, None),
    "banded_bl": (8, {"engine": "nufft", "nufft_spread": "banded"},
                  {"key": "bl"}, {}, False, "banded", {"bl": 8, "chan": 1},
                  None),
    "banded_src": (8, {"engine": "nufft", "nufft_spread": "banded"},
                   {"key": "src"}, {}, False, "banded",
                   {"bl": 8, "chan": 1}, None),
    "banded_freq_2x4": (8, {"engine": "nufft"},
                        {"key": "freq", "mesh_axes": [2, 4]}, {}, False,
                        "banded", {"bl": 8, "chan": 1}, None),
    "banded_none": (8, {"engine": "nufft"}, {"key": "none"}, {}, False,
                    "banded", None, None),
    "sorted_freq": (8, {"engine": "nufft", "nufft_spread": "sorted"},
                    {"key": "freq"}, {}, False, "sorted",
                    {"bl": 1, "chan": 8}, None),
    "scatter_src": (8, {"engine": "nufft", "nufft_spread": "scatter"},
                    {"key": "src"}, {}, False, "sorted",
                    {"bl": 1, "chan": 1, "src": 8}, None),
    "sorted_bl_2x4": (8, {"engine": "nufft", "nufft_spread": "sorted"},
                      {"key": "bl", "mesh_axes": [2, 4]}, {}, False,
                      "sorted", {"bl": 2, "chan": 4}, None),
    "sorted_none": (8, {"engine": "nufft", "nufft_spread": "sorted"},
                    {"key": "none"}, {}, False, "sorted", None, None),
    "gradient_direct_freq": (8, {"engine": "direct",
                                 "gradient_mode": "baseline"},
                             {"key": "freq"}, {}, False, "direct", None,
                             None),
    "gradient_nufft_src": (8, {"engine": "nufft",
                               "gradient_mode": "baseline"}, {"key": "src"},
                           {}, False, "direct", None, _GRAD_NOTE),
    "shaped_direct_bl": (8, {"engine": "direct"}, {"key": "bl"}, {}, True,
                         "direct", None, None),
    "shaped_sorted_freq": (8, {"engine": "nufft", "nufft_spread": "sorted"},
                           {"key": "freq"}, {}, True, "direct", None,
                           _SHAPE_NOTE),
    "external_nufft_freq": (8, {"engine": "nufft"}, {"key": "freq"},
                            {"use_external": True, "file": "b.fits"}, False,
                            "external", None, _EXT_NOTE),
    "external_gradient_src": (8, {"engine": "direct",
                                  "gradient_mode": "baseline"},
                              {"key": "src"},
                              {"use_external": True, "file": "b.fits"},
                              False, "external", None, _EXT_NOTE),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route(case, capsys):
    """driver._route, the one place that picks a simulation's engine and
    mesh, on device="cpu" (one device) and devices=["cpu"] * 8: the engine,
    the mesh's axes and shape, and the notice it prints, for every
    processing.engine, nufft_spread, gradient run, shaped sky, external
    beam and pp.key with and without pp.mesh_axes."""
    from types import SimpleNamespace
    n, proc, pp, beam, shaped, engine, shape, note = ROUTES[case]
    p = cfg_t.load_parms(dict(_OCTAVE, processing=proc, pp=pp, beam=beam))
    sim = SimpleNamespace(sky=SimpleNamespace(
        src_shape_sigma=torch.ones(128, 3) if shaped else None))
    devs = drv_t.resolve_devices("cpu", CPU8 if n == 8 else None)
    got, mesh = drv_t._route(p, sim, devs)
    out = capsys.readouterr().out
    assert got == engine
    if shape is None:
        assert mesh is None
    else:
        assert mesh.shape == shape
        assert mesh.axis_names == tuple(shape)
        assert [str(d) for d in mesh.devices.flat] == ["cpu"] * n
    assert out == ("" if note is None else "[prisim_tpu_torch] %s\n" % note)


# --------------------------------------------------------------------------
# gradient runs (kernel K1b) and skies with source shapes (kernel K1c)
# --------------------------------------------------------------------------

# The port's skyvis and gradients against JAX's on HERA-7: JAX's direct
# engine on the CPU is its f32 XLA path, whose own error on these small
# sums reads up to 4.2e-6 of max|V| against the port (2.7e-6 on the
# gradient planes, CPU), while the port sits within 1.1e-7 of the f64
# golden (test_shaped_snapshot_matches_f64_golden). So the bar is 1e-5 of
# the max of the JAX cube; a wrong weight or moment reads O(1).
JAX_F32_BAR = 1e-5


def _write_custom7(path):
    """RA DEC FLUX SPINDEX MAJAX MINAX PA, every fourth source a point
    source (zero axes)."""
    rng = np.random.RandomState(4)
    n = 40
    cat = np.c_[rng.uniform(0, 360, n), rng.uniform(-70, 10, n),
                rng.uniform(1, 10, n), rng.uniform(-1, -0.5, n),
                rng.uniform(0, 1.0, n), rng.uniform(0, 0.5, n),
                rng.uniform(0, 180, n)]
    cat[::4, 4:6] = 0.0
    np.savetxt(path, cat)


@pytest.fixture(scope="module")
def shaped_files(tmp_path_factory):
    from test_torch_catalogs import write_dsm, write_nvss
    root = tmp_path_factory.mktemp("shaped")
    files = {k: str(root / f) for k, f in (("custom", "cat7.txt"),
                                           ("dsm", "dsm8.fits"),
                                           ("nvss", "nvss.fits"))}
    _write_custom7(files["custom"])
    write_dsm(files["dsm"], nside=8)
    write_nvss(files["nvss"], n=30)
    return files


SHAPED = {
    "gradient": {"skyparm": {"model": "random", "nsrc": 32, "seed": 3},
                 "processing": {"gradient_mode": "baseline"}},
    "custom7": {"skyparm": {"model": "custom", "flux_min": None},
                "catalog": {"custom_file": "custom"}},
    "dsm_fits": {"skyparm": {"model": "dsm", "nside": 8},
                 "catalog": {"DSM_file_prefix": "dsm"}},
    "dsm_fits_gradient": {"skyparm": {"model": "dsm", "nside": 8},
                          "catalog": {"DSM_file_prefix": "dsm"},
                          "processing": {"gradient_mode": "baseline"}},
    "nvss": {"skyparm": {"model": "nvss", "flux_min": None},
             "catalog": {"NVSS_file": "nvss"}},
}


def _hera7(files, case, **processing):
    """HERA-7 non-redundant, 16 ch, 2 accumulations, no products."""
    p = {"telescope": {"id": "hera"},
         "array": {"layout": "HERA-7", "redundant": False},
         "bandpass": {"nchan": 16, "freq_resolution": 97656.25},
         "obsparm": {"n_acc": 2, "t_acc": 60.0},
         "save_formats": {"fmt": "none", "npz": False}}
    for sec, val in SHAPED[case].items():
        val = {k: files.get(v, v) if sec == "catalog" else v
               for k, v in val.items()}
        p[sec] = dict(p.get(sec, {}), **val)
    p["processing"] = dict(p.get("processing", {}), **processing)
    return cfg_jax.load_parms(p)


@pytest.fixture(scope="module", params=sorted(SHAPED))
def shaped_runs(request, shaped_files):
    case = request.param
    vj, _ = drv_jax.run_simulation(_hera7(shaped_files, case), verbose=False,
                                   save=False)
    vt, _ = drv_t.run_simulation(_hera7(shaped_files, case), verbose=False,
                                 save=False, device="cpu")
    return dict(case=case, vj=vj, vt=vt, files=shaped_files)


def test_shaped_skyvis_matches_jax(shaped_runs):
    vj, vt = shaped_runs["vj"], shaped_runs["vt"]
    assert vt.skyvis.shape == vj.skyvis.shape == (21, 16, 2)
    assert vt.skyvis.dtype == np.complex64
    scale = np.abs(vj.skyvis).max()
    assert scale > 0
    assert np.abs(vt.skyvis - vj.skyvis).max() / scale < JAX_F32_BAR


def test_gradients_match_jax(shaped_runs):
    vj, vt = shaped_runs["vj"], shaped_runs["vt"]
    if "gradient" not in shaped_runs["case"]:
        assert vt.gradients is None and vj.gradients is None
        return
    gj, gt = vj.gradients["baseline"], vt.gradients["baseline"]
    assert gt.shape == gj.shape == (3, 21, 16, 2)
    assert gt.dtype == np.complex64
    scale = np.abs(gj).max()
    assert np.abs(gt - gj).max() / scale < JAX_F32_BAR


def test_shaped_snapshot_matches_f64_golden(shaped_runs):
    """Each snapshot of the port's direct engine, with the moments and the
    weights on, against the f64 golden on the same inputs: 2e-6 of max|V|
    (3e-6 with shapes) and 5e-6 of max|G|, the bars of
    tests/test_pallas_nudft.py."""
    from prisim_tpu_torch import twofloat as tf
    from prisim_tpu_torch.engine import observe
    from prisim_tpu_torch.engine.nudft import nudft_reference_f64
    parms = _hera7(shaped_runs["files"], shaped_runs["case"])
    sim = drv_t.prepare_simulation(parms, torch.device("cpu"))
    sig = sim.sky.src_shape_sigma
    assert (sig is None) == (shaped_runs["case"] == "gradient")
    Mh, Ml, pch, pcl = observe.schedule_tensors(sim.obs, sim.inst.latitude,
                                                "cpu")
    for t in range(sim.obs.n_acc):
        seh, sel, amps, sh = observe.snapshot_nudft_inputs(
            sim.inst, sim.sky, Mh[t], Ml[t], pch[t], pcl[t], sim.beam_fn)
        v, g = observe.direct_visibilities(seh, sel, sim.inst, amps, s_sky=sh,
                                           src_shape_sigma=sig,
                                           gradient=True)
        gv, gg = nudft_reference_f64(
            tf.join_f64(seh, sel), tf.join_f64(sim.inst.bl_hi, sim.inst.bl_lo),
            amps, sim.inst.freqs, s_sky=sh, src_shape_sigma=sig,
            gradient=True)
        bar = 2e-6 if sig is None else 3e-6
        assert (v - gv).abs().max() / gv.abs().max() < bar
        assert (g - gg).abs().max() / gg.abs().max() < 5e-6
        np.testing.assert_array_equal(v.numpy(), shaped_runs["vt"].skyvis[
            :, :, t])


@pytest.mark.parametrize("case", ["gradient", "dsm_fits"])
def test_gradient_and_shapes_run_direct_engine(shaped_files, monkeypatch,
                                               capsys, case):
    """engine nufft (what auto is on a card) runs the direct engine for a
    gradient run or a shaped sky, says why, and never builds the banded
    engine."""
    def no_banded(*a, **k):
        raise AssertionError("banded engine built")
    monkeypatch.setattr(drv_t, "banded_engine", no_banded)
    vs, _ = drv_t.run_simulation(_hera7(shaped_files, case, engine="nufft"),
                                 verbose=False, save=False, device="cpu")
    out = capsys.readouterr().out
    why = "gradient_mode" if case == "gradient" else "source shapes"
    assert why in out and "running the direct engine" in out
    monkeypatch.undo()
    vd, _ = drv_t.run_simulation(_hera7(shaped_files, case, engine="direct"),
                                 verbose=False, save=False, device="cpu")
    np.testing.assert_array_equal(vs.skyvis, vd.skyvis)


def test_gradient_products_hdf5_not_npz(shaped_files, tmp_path):
    """The gradients go into the HDF5 'gradients' group, which the JAX
    reader loads; the NPZ does not carry them (as in prisim_tpu)."""
    parms = _hera7(shaped_files, "gradient")
    parms["save_formats"].update(fmt="HDF5", npz=True)
    vs, out = drv_t.run_simulation(parms, outdir=str(tmp_path), verbose=False,
                                   device="cpu")
    base = os.path.join(out, "simdata", "simvis")
    back = io_jax.load_hdf5(base + ".hdf5")
    np.testing.assert_array_equal(back.gradients["baseline"],
                                  vs.gradients["baseline"])
    with np.load(base + ".npz") as d:
        assert not any("grad" in k for k in d.files)


@pytest.mark.parametrize("db", [[0.01, -0.005, 0.0], "per_baseline"])
def test_apply_baseline_gradients_matches_jax(shaped_runs, db):
    from prisim_tpu_torch.vis import apply_baseline_gradients
    vt = shaped_runs["vt"]
    if vt.gradients is None:
        with pytest.raises(ValueError, match="gradient"):
            apply_baseline_gradients(vt, [0.01, 0.0, 0.0])
        return
    if db == "per_baseline":
        db = np.random.RandomState(1).randn(vt.nbl, 3) * 0.01
    vj = vis_jax.VisibilitySet(**{f.name: getattr(vt, f.name)
                                  for f in dataclasses.fields(vt)})
    got = apply_baseline_gradients(vt, db)
    np.testing.assert_array_equal(got, vis_jax.apply_baseline_gradients(vj,
                                                                        db))
    assert np.abs(got - vt.skyvis).max() > 0


def test_apply_baseline_gradients_first_order(shaped_files):
    """As tests/test_vis_io.py:201 checks JAX's formula, but end to end:
    the port's stored gradients predict the visibilities re-simulated on
    baselines shifted by 1 cm to first order (HERA-7, 8 ch, 16 random
    sources; phasing to the zenith pointing leaves skyvis unphased)."""
    from prisim_tpu_torch.engine.observe import Instrument, simulate_drift
    from prisim_tpu_torch.vis import apply_baseline_gradients
    parms = cfg_t.load_parms({
        "bandpass": {"nchan": 8, "freq": 150e6, "freq_resolution": 97656.25},
        "array": {"layout": "HERA-7"}, "obsparm": {"n_acc": 1, "t_acc": 10.0},
        "skyparm": {"model": "random", "nsrc": 16, "seed": 9},
        "processing": {"gradient_mode": "baseline"},
        "save_formats": {"fmt": "none", "npz": False}})
    vs, _ = drv_t.run_simulation(parms, verbose=False, save=False,
                                 device="cpu")
    db = np.asarray([0.01, -0.005, 0.0])
    dv_pred = apply_baseline_gradients(vs, db) - vs.skyvis
    sim = drv_t.prepare_simulation(parms, torch.device("cpu"))
    moved = Instrument.build(np.asarray(sim.bls.vectors) + db, sim.freqs,
                             "cpu", latitude=sim.inst.latitude)
    v0 = simulate_drift(sim.inst, sim.sky, sim.obs, sim.beam_fn).numpy()
    v1 = simulate_drift(moved, sim.sky, sim.obs, sim.beam_fn).numpy()
    np.testing.assert_array_equal(vs.skyvis, np.transpose(v0, (1, 2, 0)))
    dv_true = np.transpose(v1 - v0, (1, 2, 0))
    assert np.abs(dv_true).max() > 0
    assert np.abs(dv_pred - dv_true).max() / np.abs(dv_true).max() < 0.02


# --------------------------------------------------------------------------
# beams: BASELINE config #2 (mwa_dipole), phased arrays, sky sectors and
# external HEALPix beams, each against prisim_tpu's run on the CPU
# --------------------------------------------------------------------------

# max|dskyvis| / max|skyvis| against JAX's f32 XLA engine (its own error on
# these small sums reads up to ~4e-6 of max|V|, see JAX_F32_BAR)
BEAM_BAR = 1e-5


def config2_parms(root, nant=32, nchan=32, nsrc=256, n_acc=2, **sections):
    """benchmarks/bench_configs.config2 at its --small sizes: nant
    antennas random-uniform over +-750 m from default_rng(42), the
    seeded Pareto catalog written as a text file, mwa_dipole, chromatic,
    nchan x 160 kHz at 150 MHz, n_acc x 112 s; `sections` update the
    sections. An unresolved dict: each package loads it."""
    rng = np.random.default_rng(42)
    pos = np.zeros((nant, 3))
    pos[:, :2] = rng.uniform(-750, 750, (nant, 2))
    loc = np.stack([rng.uniform(0, 360, nsrc),
                    rng.uniform(-80, 20, nsrc)], axis=-1)
    flux = rng.pareto(1.8, nsrc) + 0.05
    spindex = rng.normal(-0.83, 0.1, nsrc)
    os.makedirs(str(root), exist_ok=True)
    cat = os.path.join(str(root), "cfg2_catalog.txt")
    with open(cat, "w") as f:
        f.write("# ra dec flux spindex\n")
        for i in range(nsrc):
            f.write(f"{loc[i,0]:.6f} {loc[i,1]:.6f} {flux[i]:.4f} "
                    f"{spindex[i]:.4f}\n")
    p = {
        "dirstruct": {"rootdir": str(root), "project": "bench_cfg2"},
        "telescope": {"id": "mwa_dipole", "latitude": -26.7,
                      "A_eff": 21.0, "Trx": 50.0},
        "array": {"layout_positions": pos.tolist()},
        "antenna": {"shape": "dipole", "size": 0.74},
        "beam": {"use_external": False, "chromatic": True},
        "bandpass": {"freq": 150e6, "freq_resolution": 160e3,
                     "nchan": nchan},
        "obsparm": {"obs_mode": "drift", "n_acc": n_acc, "t_acc": 112.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "custom"},
        "catalog": {"custom_file": cat},
        "pp": {"key": "none"},
        "save_formats": {"fmt": "none", "npz": False},
    }
    for sec, val in sections.items():
        p[sec] = dict(p.get(sec, {}), **val)
    return p


def _phased_track(lst_init, n_acc, **phasedarray):
    """tests/test_round4.py's phased-array track run: the MWA tile steered
    at (ra 30, dec -26.7), HERA-7, 8 ch, 3,600 s accumulations."""
    return {
        "telescope": {"id": "mwa", "latitude": -26.7},
        "antenna": {"shape": "dipole", "size": 0.74, "phased_array": True},
        "phasedarray": dict({"delayerr": 0.0, "gainerr": 0.0}, **phasedarray),
        "bandpass": {"nchan": 8, "freq": 150e6, "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": n_acc, "t_acc": 3600.0, "obs_mode": "track"},
        "pointing": {"lst_init": lst_init,
                     "track_init": {"ra": 30.0, "dec": -26.7}},
        "skyparm": {"model": "random", "nsrc": 48, "seed": 3},
        "pp": {"key": "none"},
        "save_formats": {"fmt": "none", "npz": False},
    }


_SECTORS = {
    "telescope": {"latitude": -30.0},
    "bandpass": {"nchan": 8, "freq": 150e6, "freq_resolution": 195312.5},
    "array": {"layout": "HERA-7"},
    "obsparm": {"n_acc": 2, "t_acc": 3600.0},
    "skyparm": {"model": "random", "nsrc": 96, "seed": 7},
    "processing": {"n_sky_sectors": 3},
    "pp": {"key": "none"},
    "save_formats": {"fmt": "none", "npz": False},
}


def write_fits_beam(path, nside=8, bfreqs=(140e6, 150e6, 160e6)):
    """An elliptical gaussian-in-sin(theta) HEALPix power beam at the
    frequencies bfreqs, written with the port's write_image."""
    from prisim_tpu_torch import healpix as hp
    from prisim_tpu_torch.io.fitsio import write_image
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    st = np.sin(theta)
    maps = np.stack([np.exp(-0.5 * ((st * np.cos(phi) / 1.08) ** 2
                                    + (st * np.sin(phi) / 0.94) ** 2)
                            / (0.42 * 2.998e8 / (f * 14.0)) ** 2)
                     for f in bfreqs], axis=1)
    with open(path, "wb") as fh:
        write_image(fh, maps, primary=True)
        write_image(fh, np.asarray(bfreqs), extname="FREQS")
    return str(path)


def _external(path, **sections):
    p = {"telescope": {"id": "hera", "latitude": -30.7},
         "array": {"layout": "HERA-7", "redundant": False},
         "bandpass": {"nchan": 16, "freq": 150e6,
                      "freq_resolution": 390625.0},
         "obsparm": {"n_acc": 2, "t_acc": 600.0},
         "skyparm": {"model": "usm", "nside": 8},
         "beam": {"use_external": True, "file": path, "chromatic": True},
         "pp": {"key": "none"},
         "save_formats": {"fmt": "none", "npz": False}}
    for sec, val in sections.items():
        p[sec] = dict(p.get(sec, {}), **val)
    return p


def _both_runs(p):
    vj, _ = drv_jax.run_simulation(cfg_jax.load_parms(copy.deepcopy(p)),
                                   verbose=False, save=False)
    vt, _ = drv_t.run_simulation(cfg_t.load_parms(copy.deepcopy(p)),
                                 verbose=False, save=False, device="cpu")
    return vj, vt


def _skyvis_close(vt, vj, bar=BEAM_BAR):
    assert vt.skyvis.shape == vj.skyvis.shape
    assert vt.skyvis.dtype == np.complex64
    scale = np.abs(vj.skyvis).max()
    assert scale > 0
    assert np.abs(vt.skyvis - vj.skyvis).max() / scale < bar


@pytest.mark.parametrize("case", ["config2_mwa_dipole", "phased_track",
                                  "external_fits", "external_fits_achromatic",
                                  "paper_groundplane"])
def test_beam_routes_match_jax(tmp_path, case):
    if case == "config2_mwa_dipole":
        p = config2_parms(tmp_path)
    elif case == "phased_track":
        p = _phased_track(0.0, 2)
    elif case.startswith("external_fits"):
        path = write_fits_beam(tmp_path / "beam.fits")
        p = _external(path, beam={"chromatic": case == "external_fits"})
    else:
        p = _external(None, telescope={"id": "paper"},
                      antenna={"ground_plane": 0.3},
                      beam={"use_external": False})
    vj, vt = _both_runs(p)
    _skyvis_close(vt, vj)


@pytest.mark.parametrize("tid", ["vla", "gmrt", "ugmrt"])
def test_pbcor_telescopes_run(tid):
    """The VLA/GMRT ids run in the port's driver, the band picked from the
    host frequencies (prisim_tpu's driver cannot run them: its PBCOR beams
    read the traced frequencies with np.asarray inside the scan). Each
    snapshot is its direct engine on the dispatcher's beam."""
    from prisim_tpu_torch.beams import primary_beam
    from prisim_tpu_torch.engine import observe
    p = cfg_t.load_parms(_external(None, telescope={"id": tid},
                                   bandpass={"freq": 400e6},
                                   beam={"use_external": False},
                                   phasing={"center": None}))
    vs, _ = drv_t.run_simulation(p, verbose=False, save=False, device="cpu")
    assert np.isfinite(vs.skyvis).all() and np.abs(vs.skyvis).max() > 0
    sim = drv_t.prepare_simulation(p, torch.device("cpu"))
    Mh, Ml, pch, pcl = observe.schedule_tensors(sim.obs, sim.inst.latitude,
                                                "cpu")
    v0 = observe.simulate_snapshot(
        sim.inst, sim.sky, Mh[0], Ml[0], pch[0], pcl[0],
        lambda s, f: primary_beam(s, f, {"id": tid})).numpy()
    np.testing.assert_array_equal(vs.skyvis[:, :, 0], v0)


def test_config2_shape_and_engine_auto_on_cpu(tmp_path):
    """Config #2's --small run has 496 baselines (all pairs of a random
    array are unique) and engine auto is the direct engine on the CPU."""
    vs, _ = drv_t.run_simulation(cfg_t.load_parms(config2_parms(
        tmp_path, processing={"engine": "auto"})), verbose=False, save=False,
        device="cpu")
    assert vs.skyvis.shape == (32 * 31 // 2, 32, 2)
    assert np.isfinite(vs.skyvis).all()


def test_sectors_match_jax_and_sum_to_full(tmp_path):
    outs_j, _ = drv_jax.run_simulation(cfg_jax.load_parms(
        copy.deepcopy(_SECTORS)), verbose=False, save=False)
    outs_t, _ = drv_t.run_simulation(cfg_t.load_parms(
        copy.deepcopy(_SECTORS)), verbose=False, save=False, device="cpu")
    assert len(outs_t) == len(outs_j) == 3
    for vt, vj in zip(outs_t, outs_j):
        assert (vt is None) == (vj is None)
        if vt is not None:
            _skyvis_close(vt, vj)
    full = dict(_SECTORS, processing={"n_sky_sectors": 1})
    vf, _ = drv_t.run_simulation(cfg_t.load_parms(full), verbose=False,
                                 save=False, device="cpu")
    tot = sum(v.skyvis for v in outs_t if v is not None)
    assert np.abs(tot - vf.skyvis).max() <= 2e-4 * np.abs(vf.skyvis).max()


def test_sectors_save_products_per_sector(tmp_path):
    p = cfg_t.load_parms(dict(copy.deepcopy(_SECTORS), dirstruct={
        "rootdir": str(tmp_path), "project": "proj", "simid": "sec"},
        save_formats={"fmt": "none", "npz": True}))
    outs, _ = drv_t.run_simulation(p, verbose=False, device="cpu")
    for k, vs in enumerate(outs):
        if vs is None:
            continue
        npz = tmp_path / "proj" / ("sec_sector%d" % k) / "simdata" / \
            "simvis.npz"
        with np.load(npz) as d:
            np.testing.assert_array_equal(d["skyvis_freq"], vs.skyvis)


def test_phased_array_per_snapshot_pointing_both_engines():
    """As tests/test_round4.py checks JAX: snapshot 1 of a 2-accumulation
    track run equals a 1-accumulation run at its LST, and differs from
    snapshot 0: on the direct engine, and on the banded engine (plain K2
    behind its gate), whose steered amplitudes reach the node model and
    the gate."""
    sid = 360.0 / 86164.0905
    runs = {}
    for engine in ("direct", "nufft"):
        for lst, n in ((0.0, 2), (3600.0 * sid / 15.0, 1)):
            p = _phased_track(lst, n)
            p["processing"] = {"engine": engine}
            runs[engine, n], _ = drv_t.run_simulation(
                cfg_t.load_parms(p), verbose=False, save=False, device="cpu")
    for engine in ("direct", "nufft"):
        a = runs[engine, 2].skyvis[..., 1]
        b = runs[engine, 1].skyvis[..., 0]
        scale = np.abs(a).max()
        assert np.abs(a - b).max() <= 2e-5 * scale
        assert np.abs(a - runs[engine, 2].skyvis[..., 0]).max() > 1e-3 * scale
    d, n = runs["direct", 2].skyvis, runs["nufft", 2].skyvis
    assert np.abs(d - n).max() <= 1e-5 * np.abs(d).max()


def test_phased_array_errors_repeat_and_differ():
    """Non-zero delay/gain errors with nrand 4: two runs bit-identical
    (the generator is seeded 0 in every call), and unlike the error-free
    run."""
    p = cfg_t.load_parms(_phased_track(0.0, 2, delayerr=1e-9, gainerr=0.5,
                                       nrand=4))
    a, _ = drv_t.run_simulation(p, verbose=False, save=False, device="cpu")
    b, _ = drv_t.run_simulation(p, verbose=False, save=False, device="cpu")
    np.testing.assert_array_equal(a.skyvis, b.skyvis)
    c, _ = drv_t.run_simulation(cfg_t.load_parms(_phased_track(0.0, 2)),
                                verbose=False, save=False, device="cpu")
    assert np.abs(a.skyvis - c.skyvis).max() > 1e-3 * np.abs(c.skyvis).max()


def test_phased_array_element_file(tmp_path):
    """phasedarray.file: element positions from a layout file (here the
    MWA tile written out) give the default tile's run."""
    from prisim_tpu_torch.beams import mwa_tile_positions
    path = tmp_path / "tile.txt"
    np.savetxt(path, np.c_[np.arange(16), mwa_tile_positions()],
               fmt=["%d", "%.6f", "%.6f", "%.6f"])
    a, _ = drv_t.run_simulation(cfg_t.load_parms(_phased_track(
        0.0, 1, file=str(path))), verbose=False, save=False, device="cpu")
    b, _ = drv_t.run_simulation(cfg_t.load_parms(_phased_track(0.0, 1)),
                                verbose=False, save=False, device="cpu")
    np.testing.assert_allclose(a.skyvis, b.skyvis, rtol=0,
                               atol=1e-6 * np.abs(b.skyvis).max())


@pytest.mark.parametrize("case", ["plain_hera", "sector", "steered",
                                  "external"])
def test_truth_beam_only_for_plain_dishes(tmp_path, monkeypatch, case):
    """The float64 truth Airy (df_eval) is attached only to a plain
    chromatic zenith dish: a sectored, steered (phased-array dish) or
    external-beam run never takes it. A sectored HERA run on the banded
    engine completes with the truth pattern made to raise, and its gate
    held the f32 amps."""
    hera = {"telescope": {"id": "hera", "latitude": -30.7},
            "array": {"layout": "HERA-7"},
            "bandpass": {"nchan": 32, "freq": 150e6,
                         "freq_resolution": 390625.0},
            "obsparm": {"n_acc": 1, "t_acc": 60.0},
            "skyparm": {"model": "random", "nsrc": 64, "seed": 2},
            "processing": {"engine": "nufft"},
            "save_formats": {"fmt": "none", "npz": False}}
    parms = cfg_t.load_parms(hera)
    if case == "sector":
        parms["_sector"] = (0, 2)
    elif case == "steered":
        parms["telescope"]["id"] = "custom"
        parms["antenna"].update(shape="dish", size=14.0, phased_array=True)
    elif case == "external":
        parms["beam"].update(use_external=True,
                             file=write_fits_beam(tmp_path / "b.fits"))
    sim = drv_t.prepare_simulation(parms, torch.device("cpu"))
    assert hasattr(sim.beam_fn, "df_eval") == (case == "plain_hera")
    assert hasattr(sim.beam_fn, "df_airy") == (case == "plain_hera")
    assert sim.beam_fn.needs_pointing == (case == "steered")
    if case != "sector":
        return

    def no_truth(*a, **k):
        raise AssertionError("truth beam evaluated")
    monkeypatch.setattr(drv_t, "airy_beam_df", no_truth)
    dump = tmp_path / "gate.npz"
    p = cfg_t.load_parms(dict(hera, processing={"engine": "nufft",
                                                "n_sky_sectors": 2}))
    os.environ["PRISIM_DEBUG_XCHECK_DUMP"] = str(dump)
    try:
        outs, _ = drv_t.run_simulation(p, verbose=False, save=False,
                                       device="cpu")
    finally:
        del os.environ["PRISIM_DEBUG_XCHECK_DUMP"]
    assert len(outs) == 2
    with np.load(dump) as d:
        assert not bool(d["truth_on"]) and bool(d["ok0"])


_AIRY_ATTACHED = ("hera_zenith", "hera_steered", "hera_pol_y",
                  "hera_pol_y_dircos", "hirax", "dish")
_AIRY_REFUSED = ("sector", "mueller", "external", "achromatic",
                 "ground_plane", "phased_array", "vla", "gmrt", "mwa")


def _airy_case_parms(tmp_path, case):
    """A HERA-7 run whose beam is `case`: a plain chromatic Airy dish
    (_AIRY_ATTACHED) or another beam (_AIRY_REFUSED)."""
    parms = cfg_t.load_parms({
        "telescope": {"id": "hera", "latitude": -30.7},
        "array": {"layout": "HERA-7"},
        "bandpass": {"nchan": 16, "freq": 150e6,
                     "freq_resolution": 390625.0},
        "obsparm": {"n_acc": 1, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 32, "seed": 2},
        "save_formats": {"fmt": "none", "npz": False}})
    tid = {"hirax": "hirax", "vla": "vla", "gmrt": "gmrt", "mwa": "mwa",
           "dish": "custom", "phased_array": "custom"}.get(case)
    if tid is not None:
        parms["telescope"]["id"] = tid
    if case == "hera_steered":
        parms["antenna"]["orientation"] = [80.0, 30.0]
    elif case == "hera_pol_y":
        parms["beam"]["pol"] = "Y"
    elif case == "hera_pol_y_dircos":         # no orientation_dircos
        parms["beam"]["pol"] = "Y"
        parms["antenna"]["ocoords"] = "dircos"
    elif case == "dish":
        parms["antenna"].update(shape="dish", size=10.0)
    elif case == "phased_array":
        parms["antenna"].update(shape="dish", size=14.0, phased_array=True)
    elif case == "sector":
        parms["_sector"] = (0, 2)
    elif case == "mueller":
        parms["_mueller_component"] = "XX"
    elif case == "external":
        parms["beam"].update(use_external=True,
                             file=write_fits_beam(tmp_path / "b.fits"))
    elif case == "achromatic":
        parms["beam"]["chromatic"] = False
    elif case == "ground_plane":
        parms["antenna"]["ground_plane"] = 0.3
    return parms


@pytest.mark.parametrize("case", _AIRY_ATTACHED + _AIRY_REFUSED)
def test_airy_dish_is_marked_for_the_kernel(tmp_path, case):
    """A plain chromatic Airy dish's beam_fn carries airy = (diameter,
    axis): HERA about its (steered, or Y-rotated) orientation, HIRAX, and a
    generic dish about zenith; the amplitudes airy_beam gives from that
    description equal the beam's own chain bit for bit. The truth pattern
    (df_eval) follows the reference's rule, the telescope's own
    orientation_dircos at zenith or absent, whatever the pol. A sector, a
    Mueller component, an external beam, an achromatic beam, a ground
    plane, a phased array and the vla/gmrt/mwa ids carry nothing, and keep
    the chain on a card."""
    from prisim_tpu_torch.beams.analytic import airy_beam
    from prisim_tpu_torch.engine.observe import _beam_and_flux
    sim = drv_t.prepare_simulation(_airy_case_parms(tmp_path, case),
                                   torch.device("cpu"))
    if case in _AIRY_REFUSED:
        assert not hasattr(sim.beam_fn, "airy")
        assert not hasattr(sim.beam_fn, "df_airy")
        return
    odc = sim.telescope.get("orientation_dircos")
    want = {"hera_zenith": (14.0, odc), "hera_steered": (14.0, odc),
            "hera_pol_y": (14.0, (-odc[1], odc[0], odc[2])) if odc else None,
            "hera_pol_y_dircos": (14.0, (0.0, 1.0, 0.0)),
            "hirax": (6.0, odc), "dish": (10.0, None)}[case]
    assert sim.beam_fn.airy == want
    assert (odc is None) == (case == "hera_pol_y_dircos")
    # the float64 truth pattern: the telescope's own dish, about zenith
    assert hasattr(sim.beam_fn, "df_eval") == (case != "hera_steered")
    assert getattr(sim.beam_fn, "df_airy", None) == (
        None if case == "hera_steered" else
        {"hirax": 6.0, "dish": 10.0}.get(case, 14.0))
    if case == "hera_steered":
        assert odc[2] < 0.99            # off zenith
    rng = np.random.RandomState(3)
    s = rng.randn(500, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    s = torch.as_tensor(s, dtype=torch.float32)
    f = torch.as_tensor(sim.freqs, dtype=torch.float32)
    flux = torch.as_tensor(rng.uniform(0, 5, (500, f.shape[0])),
                           dtype=torch.float32)
    pb = airy_beam(s, f, want[0], pointing_dircos=want[1])
    got = torch.where((s[:, 2] > 0.0)[:, None], pb * flux,
                      torch.zeros_like(flux))
    assert torch.equal(got, _beam_and_flux(s, flux, f, sim.beam_fn))
    assert got.abs().max() > 0


def test_y_feed_without_orientation_matches_jax(tmp_path):
    """A Y-feed HERA whose orientation is not given in altaz (no
    orientation_dircos) on the banded engine: as in the reference, the
    truth beam is the telescope's zenith dish, which the gate's model
    residual against the Y feed's own beam refuses, so both demote to the
    direct engine and the run is the reference's (JAX's banded spread in
    interpret mode)."""
    p = {"telescope": {"id": "hera", "latitude": -30.7},
         "array": {"layout": "HERA-7"},
         "antenna": {"ocoords": "dircos"},
         "beam": {"pol": "Y"},
         "bandpass": {"nchan": 32, "freq": 150e6,
                      "freq_resolution": 390625.0},
         "obsparm": {"n_acc": 1, "t_acc": 60.0},
         "skyparm": {"model": "random", "nsrc": 64, "seed": 2},
         "processing": {"engine": "nufft", "nufft_spread": "banded"},
         "pp": {"key": "none"},
         "save_formats": {"fmt": "none", "npz": False}}
    vj, gj = _run_dumped(drv_jax.run_simulation,
                         cfg_jax.load_parms(copy.deepcopy(p)),
                         tmp_path / "gj.npz")
    vt, gt = _run_dumped(drv_t.run_simulation,
                         cfg_t.load_parms(copy.deepcopy(p)),
                         tmp_path / "gt.npz", device="cpu")
    assert bool(gt["truth_on"]) and bool(gj["truth_on"])
    assert float(gt["resid0"]) > 1e-4 and float(gj["resid0"]) > 1e-4
    np.testing.assert_allclose(float(gt["resid0"]), float(gj["resid0"]),
                               rtol=1e-3)
    _skyvis_close(vt, vj)


def test_external_beam_runs_direct_engine(tmp_path, monkeypatch, capsys):
    """engine nufft with an external beam runs the direct engine, says so,
    and never builds the banded engine; the same visibilities as engine
    direct."""
    path = write_fits_beam(tmp_path / "beam.fits")

    def no_banded(*a, **k):
        raise AssertionError("banded engine built")
    monkeypatch.setattr(drv_t, "banded_engine", no_banded)
    vs, _ = drv_t.run_simulation(cfg_t.load_parms(_external(
        path, processing={"engine": "nufft"})), verbose=False, save=False,
        device="cpu")
    assert "external-beam route runs the direct engine" in \
        capsys.readouterr().out
    vd, _ = drv_t.run_simulation(cfg_t.load_parms(_external(
        path, processing={"engine": "direct"})), verbose=False, save=False,
        device="cpu")
    np.testing.assert_array_equal(vs.skyvis, vd.skyvis)


def test_hdf5_beam_without_h5py_raises_before_compute(tmp_path, monkeypatch):
    from prisim_tpu_torch.io import hdf5 as io_hdf5

    def no_compute(*a, **k):
        raise AssertionError("compute reached")
    monkeypatch.setattr(io_hdf5, "h5py", None)
    monkeypatch.setattr(drv_t, "prepare_simulation", no_compute)
    with pytest.raises(ImportError, match="h5py"):
        drv_t.run_simulation(cfg_t.load_parms(_external(
            str(tmp_path / "beam.hdf5"))), verbose=False, device="cpu")


def test_external_hdf5_beam_matches_fits(tmp_path):
    from prisim_tpu_torch.io.fitsio import read_fits
    path = write_fits_beam(tmp_path / "beam.fits")
    maps, bfreqs = (h["data"] for h in read_fits(path))
    h5 = str(tmp_path / "beam.hdf5")
    with h5py.File(h5, "w") as f:
        f["beam"] = maps
        f["freqs"] = bfreqs
    a, _ = drv_t.run_simulation(cfg_t.load_parms(_external(path)),
                                verbose=False, save=False, device="cpu")
    b, _ = drv_t.run_simulation(cfg_t.load_parms(_external(h5)),
                                verbose=False, save=False, device="cpu")
    np.testing.assert_array_equal(a.skyvis, b.skyvis)


# --------------------------------------------------------------------------
# products (native FITS, UVFITS, UVH5 with save_redundant, figures) and the
# FITS inputs (HI cubes, PFB tables), each against prisim_tpu's run
# --------------------------------------------------------------------------

def _hera7_redundant(root, **sections):
    """tests/test_driver.py:163's run: HERA-7 redundant (9 unique of 21
    baselines), 8 ch at 155 MHz, one 10 s accumulation, 8 random sources;
    `sections` update the sections. An unresolved dict."""
    p = {"dirstruct": {"rootdir": str(root), "project": "p", "simid": "s"},
         "bandpass": {"nchan": 8, "freq": 155e6, "freq_resolution": 195312.5},
         "array": {"layout": "HERA-7", "redundant": True},
         "obsparm": {"n_acc": 1, "t_acc": 10.0},
         "skyparm": {"model": "random", "nsrc": 8},
         "pp": {"key": "none"},
         "save_formats": {"fmt": "none", "npz": False}}
    for sec, val in sections.items():
        p[sec] = dict(p.get(sec, {}), **val) if isinstance(val, dict) else val
    return p


def _both_saved(p, root):
    pj, pt = copy.deepcopy(p), copy.deepcopy(p)
    pj["dirstruct"]["rootdir"] = str(root / "jax")
    pt["dirstruct"]["rootdir"] = str(root / "torch")
    vj, dj = drv_jax.run_simulation(cfg_jax.load_parms(pj), verbose=False)
    vt, dt = drv_t.run_simulation(cfg_t.load_parms(pt), verbose=False,
                                  device="cpu")
    return vj, dj, vt, dt


def test_fits_product_matches_jax(tmp_path):
    """save_formats.fmt: FITS writes the native FITS product: it reads back
    (the port's load_fits and JAX's) as the returned VisibilitySet, and
    holds what JAX's product holds (the noiseless cube within BEAM_BAR of
    max|V|; the noise differs value by value, R4)."""
    from prisim_tpu_torch.io import load_fits
    p = _hera7_redundant(tmp_path, save_formats={"fmt": "FITS", "npz": False},
                         processing={"delay_transform": True})
    vj, dj, vt, dt = _both_saved(p, tmp_path)
    path = os.path.join(dt, "simdata", "simvis.fits")
    assert sorted(os.listdir(os.path.join(dt, "simdata"))) == ["simvis.fits"]
    for back in (load_fits(path), io_jax.load_fits(path)):
        np.testing.assert_array_equal(back.skyvis, vt.skyvis)
        np.testing.assert_array_equal(back.vis, vt.vis)
        np.testing.assert_array_equal(back.skyvis_lag,
                                      vt.skyvis_lag.astype(np.complex64))
        np.testing.assert_array_equal(back.projected_baselines,
                                      vt.projected_baselines)
        np.testing.assert_array_equal(back.labels, vt.labels)
    want = io_jax.load_fits(os.path.join(dj, "simdata", "simvis.fits"))
    got = load_fits(path)
    _skyvis_close(got, want)
    for name in ("baselines", "freqs", "lst", "timestamps", "bp", "bp_wts",
                 "Tsys", "projected_baselines", "lags"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)


@pytest.mark.parametrize("redundant", [True, False])
def test_uv_products_with_save_redundant_match_jax(tmp_path, redundant):
    """uvfits and uvh5 with save_redundant: the unique baselines (9 of
    HERA-7) expanded onto all 21 pairs, each copy its exemplar's
    visibilities, as in JAX's files: the same metadata, the noiseless data
    within BEAM_BAR of max|V|; save_redundant: false writes the 9."""
    from prisim_tpu.io.uvh5 import read_uvh5_arrays as read_jax
    from prisim_tpu_torch.io.uvfits import load_uvfits
    from prisim_tpu_torch.io.uvh5 import read_uvh5_arrays
    p = _hera7_redundant(tmp_path, save_redundant=redundant, save_formats={
        "fmt": "none", "npz": False, "uvfits": True, "uvh5": True})
    vj, dj, vt, dt = _both_saved(p, tmp_path)
    assert vt.nbl == 9
    nbl = 21 if redundant else 9
    got = read_uvh5_arrays(os.path.join(dt, "simdata", "simvis.uvh5"))
    want = read_jax(os.path.join(dj, "simdata", "simvis.uvh5"))
    assert got["Nbls"] == want["Nbls"] == nbl
    for k in want:
        if k != "visdata":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    scale = np.abs(want["visdata"]).max()
    assert np.abs(got["visdata"] - want["visdata"]).max() / scale < BEAM_BAR
    uv = load_uvfits(os.path.join(dt, "simdata", "simvis.uvfits"))
    assert uv.nbl == nbl
    np.testing.assert_array_equal(uv.skyvis[:, :, 0], np.conj(
        got["visdata"][:, :, 0]))
    if redundant:
        # each all-pairs baseline carries its unique exemplar's rows
        same = np.all(uv.skyvis[:, None] == vt.skyvis[None], axis=(2, 3))
        assert (same.sum(axis=1) == 1).all()
        assert np.unique(same.argmax(axis=1)).size == 9
    else:
        np.testing.assert_array_equal(uv.labels, vt.labels)


def test_uvh5_without_h5py_raises_before_compute(tmp_path, monkeypatch):
    from prisim_tpu_torch.io import hdf5 as io_hdf5

    def no_compute(*a, **k):
        raise AssertionError("compute reached")
    monkeypatch.setattr(io_hdf5, "h5py", None)
    monkeypatch.setattr(drv_t, "prepare_simulation", no_compute)
    p = cfg_t.load_parms(_hera7_redundant(tmp_path, save_formats={
        "fmt": "none", "npz": True, "uvh5": True}))
    with pytest.raises(ImportError, match="uvh5 needs h5py"):
        drv_t.run_simulation(p, verbose=False, device="cpu")
    p["beam"]["pol"] = "full"
    with pytest.raises(ImportError, match="uvh5 needs h5py"):
        drv_t.run_simulation(p, verbose=False, device="cpu")
    p["save_formats"]["uvh5"] = False
    p["beam"]["pol"] = "XYZ"
    with pytest.raises(ValueError, match="beam.pol"):
        drv_t.run_simulation(p, verbose=False, device="cpu")


@pytest.mark.parametrize("model", ["hi_cube", "hi_fluctuations"])
def test_fits_hi_cube_run_matches_jax(tmp_path, model):
    """A FITS HI cube (tests/test_catalog_fits.py:74's IMAGE layout) as the
    sky of a run in both packages."""
    from test_catalog_fits import _write_hi_cube
    path = str(tmp_path / "hi.fits")
    _write_hi_cube(path)
    p = _external(None, beam={"use_external": False},
                  skyparm={"model": model}, catalog={"spectrum_file": path})
    vj, vt = _both_runs(p)
    _skyvis_close(vt, vj)


def test_pfb_file_run_matches_jax(tmp_path):
    """bandpass.pfb_method: theoretical with a measured PFB FITS table
    (tests/test_aux.py:294's): the same bandpass and flags as JAX's run
    (bp_correct false puts the shape into bp; the coarse-channel edges
    flagged)."""
    from test_torch_io import write_pfb_table
    nchan, f0, df = 32, 150e6, 100e3
    path = write_pfb_table(str(tmp_path / "pfb.fits"),
                           f0 + df * (np.arange(nchan) - nchan / 2))
    p = _hera7_redundant(
        tmp_path, bandpass={"nchan": nchan, "freq": f0, "freq_resolution": df,
                            "pfb_method": "theoretical", "pfb_file": path},
        processing={"bp_correct": False, "coarse_channel_width": 8},
        flags={"n_edge_flag": [1, 1], "flag_repeat_edge_channels": True})
    vj, vt = _both_runs(p)
    np.testing.assert_array_equal(vt.bp, vj.bp)
    np.testing.assert_array_equal(vt.bp_wts, vj.bp_wts)
    assert (vt.bp == 0).any() and 0 < vt.bp[vt.bp > 0].min() < 0.5
    _skyvis_close(vt, vj)


def test_plots_written(tmp_path, monkeypatch, capsys):
    """plots: true writes the figures JAX writes (tests/test_driver.py:266);
    without matplotlib the run completes and says why it has none."""
    p = _hera7_redundant(tmp_path, plots=True,
                         processing={"delay_transform": True})
    vj, dj, vt, dt = _both_saved(p, tmp_path)
    figs = sorted(os.listdir(os.path.join(dt, "figures")))
    assert figs == sorted(os.listdir(os.path.join(dj, "figures"))) == [
        "amp_vs_baseline.png", "delay_waterfall.png", "vis_waterfall.png"]
    for f in figs:
        assert os.path.getsize(os.path.join(dt, "figures", f)) > 5000
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    p["dirstruct"]["simid"] = "noplt"
    _, out = drv_t.run_simulation(cfg_t.load_parms(p), verbose=False,
                                  device="cpu")
    assert "plots failed" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(out, "figures"))
