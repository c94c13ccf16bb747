"""The port's device mesh (prisim_tpu_torch.parallel.mesh and the driver's
mesh branches) on an 8-entry CPU mesh, devices=["cpu"] * 8, against
prisim_tpu's mesh on its 8 virtual CPU devices (tests/conftest.py), with
tests/test_parallel.py's and tests/test_driver_mesh.py's shapes and
inputs, and against the port's own single-device runs.

Tolerances:
- port mesh vs port single device: bl/chan shards are the same sums per
  baseline and channel, equal bit for bit; src shards add partial sums
  (1e-6 of max|V|: the complex64 rounding of the partials);
- port vs JAX: 1e-5 of max|V| (test_torch_driver.py's bar against JAX's
  f32 engines), the banded engine 2e-5 as tests/test_parallel.py holds
  JAX's banded mesh against its direct engine;
- the banded mesh's K2 rows against the unsharded collapse=False plan's:
  1e-12 of max|rows| (both float64 sums);
- the NUFFT with the sorted spread on a mesh against the direct engine and
  JAX's sorted mesh: 2e-5 (tests/test_parallel.py's bar), and against the
  single-device NUFFT snapshot with a channel count the shards do not
  divide, 2e-4 (tests/test_round3_fixes.py's bar)."""

import numpy as np
import pytest
import torch

from prisim_tpu import baselines as bls_j
from prisim_tpu import layouts as lay_j
from prisim_tpu import skymodel as sm_j
from prisim_tpu.beams import airy_beam as airy_j
from prisim_tpu.config import load_parms as load_parms_j
from prisim_tpu.driver import run_simulation as run_j
from prisim_tpu.engine import Instrument as Inst_j
from prisim_tpu.engine import Observation as Obs_j
from prisim_tpu.engine import SkySources as Sky_j
from prisim_tpu.engine import simulate_drift as drift_j
from prisim_tpu.parallel import mesh as mesh_j

from prisim_tpu_torch import baselines as bls_t
from prisim_tpu_torch import driver as drv_t
from prisim_tpu_torch import layouts as lay_t
from prisim_tpu_torch import skymodel as sm_t
from prisim_tpu_torch import twofloat as tf
from prisim_tpu_torch.beams import airy_beam as airy_t
from prisim_tpu_torch.config import load_parms as load_parms_t
from prisim_tpu_torch.engine import nufft_banded as nb
from prisim_tpu_torch.engine.cuda_banded import banded_worklist_cuda
from prisim_tpu_torch.engine.nufft_delay import chebyshev_projection
from prisim_tpu_torch.engine.observe import (Instrument, Observation,
                                             SkySources, df_rotate3,
                                             schedule_tensors, simulate_drift)
from prisim_tpu_torch.parallel import mesh as mesh_t

CPU = torch.device("cpu")
CPU8 = ["cpu"] * 8
SRC_BAR = 1e-6
JAX_BAR = 1e-5
BANDED_BAR = 2e-5
ROWS_BAR = 1e-12


def _problem(pkg, C=24, n_acc=2, nsrc=80):
    """tests/test_parallel.py's problem (HERA-7 non-redundant, 21
    baselines) built by either package."""
    lay, bls, sm, airy = pkg
    layout = lay.preset_layout("HERA-7")
    bset = bls.build_baselines(layout, redundant=False)
    freqs = 150e6 + 390625.0 * np.arange(C)
    model = sm.random_point_source_model(nsrc, seed=11)
    lst = np.linspace(30.0, 40.0, n_acc)
    obs = dict(lst_deg=lst, jd=2457349.5 + lst / 360.0,
               t_acc=np.full(n_acc, 60.0),
               pointing_altaz=np.tile([90.0, 270.0], (n_acc, 1)))
    if airy is airy_t:
        inst = Instrument.build(bset.vectors, freqs, CPU, latitude=-30.72)
        sky = SkySources.from_skymodel(model, freqs, CPU)
        return inst, sky, Observation(**obs), lambda dc, f: airy(dc, f, 14.0)
    inst = Inst_j.build(bset.vectors, freqs, latitude=-30.72)
    sky = Sky_j.from_skymodel(model, freqs)
    return inst, sky, Obs_j(**obs), lambda dc, f: airy(dc, f, 14.0)


JAX = (lay_j, bls_j, sm_j, airy_j)
PORT = (lay_t, bls_t, sm_t, airy_t)

MESHES = {
    "bl_chan_8x1": ((8, 1), ("bl", "chan"), "sharded"),
    "bl_chan_1x8": ((1, 8), ("bl", "chan"), "sharded"),
    "bl_chan_4x2": ((4, 2), ("bl", "chan"), "sharded"),
    "bl_chan_2x4": ((2, 4), ("bl", "chan"), "sharded"),
    "src_chan_4x2": ((4, 2), ("src", "chan"), "src"),
    "src_bl_chan_2x2x2": ((2, 2, 2), ("src", "bl", "chan"), "src"),
}


@pytest.fixture(scope="module")
def singles():
    """Each package's single-device drift scan of the problem."""
    pj, pt = _problem(JAX), _problem(PORT)
    return (pj, np.asarray(drift_j(*pj, src_block=64)),
            pt, simulate_drift(*pt, src_block=64).numpy())


@pytest.mark.parametrize("case", sorted(MESHES))
def test_mesh_matches_single_device_and_jax(singles, case):
    shape, axes, kind = MESHES[case]
    pj, ref_j, pt, ref_t = singles
    fn_t = (mesh_t.simulate_drift_sharded if kind == "sharded"
            else mesh_t.simulate_drift_src_sharded)
    fn_j = (mesh_j.simulate_drift_sharded if kind == "sharded"
            else mesh_j.simulate_drift_src_sharded)
    got = fn_t(*pt, mesh_t.make_mesh(shape, axes, devices=CPU8),
               src_block=64).numpy()
    want = np.asarray(fn_j(*pj, mesh_j.make_mesh(shape, axes),
                           src_block=64))
    assert got.shape == ref_t.shape == want.shape
    scale = np.abs(ref_t).max()
    if kind == "sharded":
        np.testing.assert_array_equal(got, ref_t)
    else:
        assert np.abs(got - ref_t).max() / scale < SRC_BAR
    assert np.abs(got - want).max() / scale < JAX_BAR
    assert np.abs(ref_t - ref_j).max() / scale < JAX_BAR


def test_banded_mesh_matches_jax_and_rejects_chan_axis():
    """simulate_drift_banded_sharded over an (8, 1) 'bl' mesh: 21 baselines
    over 8 shards (padded with copies of baseline 0, trimmed); agrees with
    the port's direct engine and with JAX's banded mesh; a (1, 8) mesh
    raises ValueError in both packages."""
    pj, pt = _problem(JAX, C=32, nsrc=64), _problem(PORT, C=32, nsrc=64)
    got, ok = mesh_t.simulate_drift_banded_sharded(
        *pt, mesh_t.make_mesh((8, 1), ("bl", "chan"), devices=CPU8))
    want, ok_j = mesh_j.simulate_drift_banded_sharded(
        *pj, mesh_j.make_mesh((8, 1), ("bl", "chan")), interpret=True)
    ref = simulate_drift(*pt, src_block=64).numpy()
    got, want = got.numpy(), np.asarray(want)
    assert ok and ok_j and got.shape == ref.shape == want.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < BANDED_BAR
    assert np.abs(got - want).max() / scale < BANDED_BAR
    with pytest.raises(ValueError):
        mesh_t.simulate_drift_banded_sharded(
            *pt, mesh_t.make_mesh((1, 8), ("bl", "chan"), devices=CPU8))
    with pytest.raises(ValueError):
        mesh_j.simulate_drift_banded_sharded(
            *pj, mesh_j.make_mesh((1, 8), ("bl", "chan")), interpret=True)


def test_banded_shard_rows_match_unsharded_plan():
    """Each shard's K2 rows (its slice of the one collapse=False plan) equal
    the unsharded plan's rows of its baselines, and its worklist, rebuilt
    from the sliced tables, lists the same tiles per item, on snapshot 0
    of the problem padded to 24 baselines."""
    inst, sky, obs, beam = _problem(PORT, C=32, nsrc=64)
    bl64 = np.asarray(inst.bl_hi, np.float64) + np.asarray(inst.bl_lo,
                                                           np.float64)
    bl64 = np.concatenate([bl64, np.repeat(bl64[:1], 3, axis=0)])
    plan = nb.make_banded_plan(bl64, inst.nu0, inst.dnu, inst.nchan,
                               rank=16, collapse=False)
    pinvQ, _ = chebyshev_projection(inst.freqs, 16)
    coeffs = nb.make_coeff_fn(inst.freqs, 16, pinvQ, beam)
    Mh, Ml, pch, pcl = (a[0] for a in schedule_tensors(obs, inst.latitude,
                                                       CPU))
    sh, sl = df_rotate3(Mh, Ml, sky.s_eq_hi, sky.s_eq_lo)
    seh, sel = tf.df_add(sh, sl, -pch[None, :], -pcl[None, :])
    P = coeffs(sh, sky.flux, pch)
    prep = nb._prep(plan, seh.contiguous(), sel.contiguous(), P)[:3]
    full = nb.banded_spread_plain(plan, *prep)
    n_rb = -(-plan.R_max // nb.K2_ROWS)
    counts = banded_worklist_cuda(plan, *prep)[1].reshape(-1, n_rb)
    scale = float(full.abs().max())
    assert scale > 0
    for i in range(8):
        rows = slice(3 * i, 3 * i + 3)
        sp = mesh_t._shard_plan(plan, rows)
        assert (sp.nbl, sp.R_max, sp.n, sp.G_blk) == (3, plan.R_max, plan.n,
                                                      plan.G_blk)
        sprep = nb._prep(sp, seh.contiguous(), sel.contiguous(), P)[:3]
        part = nb.banded_spread_plain(sp, *sprep)
        assert float((part - full[rows]).abs().max()) <= ROWS_BAR * scale
        np.testing.assert_array_equal(
            banded_worklist_cuda(sp, *sprep)[1].reshape(-1, n_rb),
            counts[rows])


def test_make_mesh_checks_the_product():
    with pytest.raises(ValueError, match="#devices"):
        mesh_t.make_mesh((2, 3), ("bl", "chan"), devices=CPU8)
    with pytest.raises(ValueError, match="#devices"):
        mesh_j.make_mesh((2, 3), ("bl", "chan"))
    m = mesh_t.make_mesh(axis_names=("bl", "chan", "src"), devices=CPU8)
    assert m.shape == {"bl": 8, "chan": 1, "src": 1}
    assert all(d == CPU for d in m.devices.flat)
    assert mesh_t.__all__ == mesh_j.__all__
    np.testing.assert_array_equal(mesh_t.pad_to_multiple(np.ones((5, 2)), 4),
                                  mesh_j.pad_to_multiple(np.ones((5, 2)), 4))
    vis = mesh_t.simulate_drift_nufft_sharded(
        *_problem(PORT, C=16, nsrc=16), m, rank=8)
    assert vis.shape == (2, 21, 16) and bool(torch.isfinite(vis).all())


NUFFT_MESHES = {
    "bl_8x1": ((8, 1), ("bl", "chan")),
    "chan_1x8": ((1, 8), ("bl", "chan")),
    "src_1x1x8": ((1, 1, 8), ("bl", "chan", "src")),
}


@pytest.mark.parametrize("case", sorted(NUFFT_MESHES))
def test_nufft_mesh_matches_jax_and_direct(case):
    """simulate_drift_nufft_sharded (the sorted spread's plain version on
    every CPU shard) over 'bl', 'chan' and 'src' meshes of 8, against the
    port's direct engine and JAX's sorted mesh on its 8 devices
    (tests/test_parallel.py:106's problem)."""
    shape, axes = NUFFT_MESHES[case]
    pt = _problem(PORT, C=64, nsrc=48)
    pj = _problem(JAX, C=64, nsrc=48)
    got = mesh_t.simulate_drift_nufft_sharded(
        *pt, mesh_t.make_mesh(shape, axes, devices=CPU8), rank=16).numpy()
    want = np.asarray(mesh_j.simulate_drift_nufft_sharded(
        *pj, mesh_j.make_mesh(shape, axes), rank=16))
    ref = simulate_drift(*pt, src_block=64).numpy()
    scale = np.abs(ref).max()
    assert got.shape == ref.shape == want.shape == (2, 21, 64)
    assert np.abs(got - ref).max() / scale < BANDED_BAR
    assert np.abs(got - want).max() / scale < BANDED_BAR


def test_nufft_mesh_nondivisible_channels():
    """30 channels on a (1, 2) 'chan' mesh: the padded channel is
    edge-replicated, so the last shard's spectral fit stays clean; against
    the single-device NUFFT snapshot and JAX's mesh
    (tests/test_round3_fixes.py:165)."""
    import jax
    from prisim_tpu_torch.engine.nufft_delay import (
        chebyshev_projection, simulate_snapshot_nufft_jit)
    pt = _problem(PORT, C=30, n_acc=1, nsrc=64)
    pj = _problem(JAX, C=30, n_acc=1, nsrc=64)
    inst, sky, obs, beam = pt
    got = mesh_t.simulate_drift_nufft_sharded(
        *pt, mesh_t.make_mesh((1, 2), ("bl", "chan"), devices=CPU8[:2]),
        rank=8).numpy()
    want = np.asarray(mesh_j.simulate_drift_nufft_sharded(
        *pj, mesh_j.make_mesh((1, 2), ("bl", "chan"),
                              devices=jax.devices()[:2]), rank=8))
    pinvQ, Q = chebyshev_projection(inst.freqs, 8)
    gold = simulate_snapshot_nufft_jit(
        inst, sky, *(a[0] for a in schedule_tensors(obs, inst.latitude, CPU)),
        beam, pinvQ, Q).numpy()
    scale = np.abs(gold).max()
    assert got.shape == want.shape == (1, 21, 30)
    assert np.abs(got[0] - gold).max() / scale < 2e-4
    assert np.abs(got - want).max() / scale < BANDED_BAR


def _parms(load, key, mesh_axes=None, **proc):
    """tests/test_driver_mesh.py's parameters."""
    return load({
        "bandpass": {"nchan": 16, "freq": 155e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 32, "seed": 4},
        "pp": {"key": key, "mesh_axes": mesh_axes},
        "processing": proc,
    })


DRIVER_CASES = {
    "freq": ("freq", None, {}),
    "bl": ("bl", None, {}),
    "src": ("src", None, {}),
    "freq_2x4": ("freq", [2, 4], {}),
    "banded": ("freq", None, {"engine": "nufft", "nufft_spread": "banded"}),
    "sorted_freq": ("freq", None, {"engine": "nufft",
                                   "nufft_spread": "sorted"}),
    "sorted_src": ("src", None, {"engine": "nufft", "nufft_spread": "sorted"}),
    "sorted_2x4": ("freq", [2, 4], {"engine": "nufft",
                                    "nufft_spread": "sorted"}),
}


@pytest.fixture(scope="module")
def single_run():
    vs, _ = drv_t.run_simulation(_parms(load_parms_t, "none"), verbose=False,
                                 save=False, device="cpu")
    return vs.skyvis


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_driver_mesh_matches_jax_and_key_none(single_run, case, capsys):
    """run_simulation with devices=["cpu"] * 8 takes the mesh of pp.key
    (the banded engine its 'bl' mesh behind the mesh gate, the sorted
    spread pp.key's mesh behind its gate; each gate must pass: a demotion
    prints 'falling back'), against the port's pp.key: none run and JAX's
    run_simulation on its 8 devices."""
    key, axes, proc = DRIVER_CASES[case]
    vs, _ = drv_t.run_simulation(_parms(load_parms_t, key, axes, **proc),
                                 verbose=True, save=False, devices=CPU8)
    out = capsys.readouterr().out
    assert "falling back" not in out
    assert {"banded": "'bl' mesh"}.get(
        case, "sorted spread" if case.startswith("sorted")
        else "direct engine on a") in out
    vj, _ = run_j(_parms(load_parms_j, key, axes, **proc), verbose=False,
                  save=False)
    scale = np.abs(single_run).max()
    assert vs.skyvis.shape == single_run.shape == vj.skyvis.shape
    if case == "banded" or case.startswith("sorted"):
        assert np.abs(vs.skyvis - single_run).max() / scale < BANDED_BAR
        assert np.abs(vs.skyvis - vj.skyvis).max() / scale < BANDED_BAR
    else:
        bar = SRC_BAR if case == "src" else 0.0
        assert np.abs(vs.skyvis - single_run).max() / scale <= bar
        assert np.abs(vs.skyvis - vj.skyvis).max() / scale < JAX_BAR


def test_mesh_axes_mismatch_raises_before_compute(monkeypatch):
    """A pp.mesh_axes whose product is not the device count raises before
    any compute, on the direct and the banded engine."""
    def no_compute(*a, **k):
        raise AssertionError("compute reached")
    monkeypatch.setattr(drv_t, "prepare_simulation", no_compute)
    for proc in ({}, {"engine": "nufft"}):
        with pytest.raises(ValueError, match="mesh_axes"):
            drv_t.run_simulation(_parms(load_parms_t, "freq", [2, 2], **proc),
                                 verbose=False, save=False, devices=CPU8)
        with pytest.raises(ValueError, match="mesh_axes"):
            drv_t.run_simulation(_parms(load_parms_t, "src", [2, 4], **proc),
                                 verbose=False, save=False, devices=CPU8)


def test_one_device_and_key_none_stay_single(monkeypatch):
    """One device (device='cpu'), or pp.key: none on eight, never builds a
    mesh; a gradient run on eight runs on the first device."""
    from prisim_tpu_torch.parallel import mesh as mesh_mod

    def no_mesh(*a, **k):
        raise AssertionError("mesh built")
    monkeypatch.setattr(mesh_mod, "make_mesh", no_mesh)
    drv_t.run_simulation(_parms(load_parms_t, "freq"), verbose=False,
                         save=False, device="cpu")
    drv_t.run_simulation(_parms(load_parms_t, "none"), verbose=False,
                         save=False, devices=CPU8)
    vs, _ = drv_t.run_simulation(
        _parms(load_parms_t, "freq", gradient_mode="baseline"),
        verbose=False, save=False, devices=CPU8)
    assert vs.gradients["baseline"].shape == (3, 9, 16, 2)


def test_chunked_run_on_a_mesh_matches_single(tmp_path):
    """run_simulation_chunked passes devices to every chunk: two frequency
    chunks, each on the (1, 8) mesh, equal the same chunked run on one
    device bit for bit."""
    out = {}
    for name, kw in (("mesh", dict(devices=CPU8)), ("one", dict(device="cpu"))):
        p = _parms(load_parms_t, "freq")
        p["pp"]["n_chunks"] = 2
        p["save_formats"]["fmt"] = "none"
        out[name], _ = drv_t.run_simulation_chunked(
            p, outdir=str(tmp_path / name), verbose=False, **kw)
    np.testing.assert_array_equal(out["mesh"].skyvis, out["one"].skyvis)
