"""The port's delay-space NUFFT engine (prisim_tpu_torch.engine.nufft_delay
and the driver's sorted route) against prisim_tpu's, on the CPU, where the
spread is kernel delay_spread's plain version. The inputs of
tests/test_nufft_delay.py, seeded numpy handed to both packages.

Tolerances (max|dV| / max|V|):
- the port's spread against the float64 reference nufft_delay_visibilities
  on the same joined delays: 1e-9, the reference's own bar against the
  direct sum (the port spreads in float64 and returns complex128);
- the port's sorted, scatter and gather spreads against JAX's on the same
  two-float delays and float32 amplitudes: 1e-5, JAX's bar for its float32
  spreads (they sit ~3e-6 from the truth);
- snapshots and runs against JAX's and against the direct engine: 2e-5
  (tests/test_nufft_delay.py:128, tests/test_driver.py:326)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prisim_tpu.config import load_parms as load_parms_j
from prisim_tpu.driver import run_simulation as run_j
from prisim_tpu.engine import nufft_banded as nb_j
from prisim_tpu.engine import nufft_delay as nd_j
from prisim_tpu.engine import Instrument as Inst_j
from prisim_tpu.engine import SkySources as Sky_j
from prisim_tpu.engine import enu_rotation_from_eq
from prisim_tpu.beams import airy_beam as airy_j
from prisim_tpu import baselines as bls_j
from prisim_tpu import layouts as lay_j
from prisim_tpu import skymodel as sm_j

from prisim_tpu_torch import baselines as bls_t
from prisim_tpu_torch import driver as drv_t
from prisim_tpu_torch import layouts as lay_t
from prisim_tpu_torch import skymodel as sm_t
from prisim_tpu_torch import twofloat as tf
from prisim_tpu_torch.beams import airy_beam as airy_t
from prisim_tpu_torch.config import load_parms as load_parms_t
from prisim_tpu_torch.engine import cuda_spread as cs
from prisim_tpu_torch.engine import nufft_banded as nb
from prisim_tpu_torch.engine import nufft_delay as nd
from prisim_tpu_torch.engine.observe import (Instrument, SkySources,
                                             simulate_snapshot)

F64_BAR = 1e-9
JAX_BAR = 1e-5
SNAP_BAR = 2e-5
NU0, DNU = 100e6, 97656.25


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _delays(seed, S, B, kind):
    """tests/test_nufft_delay.py's delays: uniform over +-1 us, over
    several 1/dnu periods, or half clustered within a few bins."""
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        tau = rng.uniform(-1e-6, 1e-6, (S, B))
    elif kind == "multiperiod":
        tau = rng.uniform(-3e-5, 3e-5, (S, B))
    else:
        tau = np.concatenate([rng.uniform(-1e-6, 1e-6, (S // 2, B)),
                              rng.normal(0.0, 2e-8, (S - S // 2, B))])
    amps = rng.uniform(0.1, 10.0, (S, B)).astype(np.float32)
    th, tl = tf.split_f64(tau)
    return th, tl, amps


# (seed, S, B, C, nu0, dnu, kind) of tests/test_nufft_delay.py's cases
F64_CASES = {
    "matches_direct": (0, 700, 12, 256, 100e6, 97656.25, "uniform"),
    "multiperiod_folding": (4, 200, 3, 64, 150e6, 1e5, "multiperiod"),
    "clustered": (8, 1024, 6, 128, 100e6, 97656.25, "clustered"),
}


@pytest.mark.parametrize("case", sorted(F64_CASES))
@pytest.mark.parametrize("shared", [False, True])
def test_plain_spread_matches_f64_reference(case, shared):
    """delay_spread_plain through nufft_delay_visibilities_jax_sorted
    against the float64 reference on the same joined delays, with
    per-baseline (S, B) and shared (S,) amplitudes."""
    seed, S, B, C, nu0, dnu, kind = F64_CASES[case]
    th, tl, amps = _delays(seed, S, B, kind)
    if shared:
        amps = amps[:, 0]
    V = nd.nufft_delay_visibilities_jax_sorted(_t(th), _t(tl), _t(amps),
                                               nu0, dnu, C)
    ref = nd_j.nufft_delay_visibilities(tf.join_f64(th, tl), amps, nu0,
                                        dnu, C)
    assert V.dtype == torch.complex128 and V.shape == (B, C)
    assert _rel(V.numpy(), ref) < F64_BAR


def _jax_spread(name, th, tl, amps, C, **kw):
    fn = {"sorted": nd_j.nufft_delay_visibilities_jax_sorted,
          "scatter": nd_j.nufft_delay_visibilities_jax,
          "gather": nd_j.nufft_delay_visibilities_jax_gather}[name]
    return np.asarray(fn(jnp.asarray(th), jnp.asarray(tl), jnp.asarray(amps),
                         NU0, DNU, C, **kw))


def _port_spread(name, th, tl, amps, C, **kw):
    fn = {"sorted": nd.nufft_delay_visibilities_jax_sorted,
          "scatter": nd.nufft_delay_visibilities_jax,
          "gather": nd.nufft_delay_visibilities_jax_gather}[name]
    return fn(_t(th), _t(tl), _t(amps), NU0, DNU, C, **kw).numpy()


@pytest.mark.parametrize("name", ["sorted", "scatter", "gather"])
@pytest.mark.parametrize("kind", ["uniform", "clustered"])
def test_spreads_match_jax(name, kind):
    """The three spreads (one kernel in the port) against JAX's on the same
    two-float delays and float32 amplitudes, and against the f64
    reference."""
    th, tl, amps = _delays(3, 400, 8, kind)
    C = 128
    got = _port_spread(name, th, tl, amps, C)
    want = _jax_spread(name, th, tl, amps, C)
    ref = nd_j.nufft_delay_visibilities(tf.join_f64(th, tl), amps, NU0, DNU,
                                        C)
    assert got.shape == want.shape == (8, C)
    assert _rel(got, want) < JAX_BAR
    assert _rel(got, ref) < F64_BAR


def test_gather_window_is_checked_not_needed():
    """The gather spread needs no window: window=None (which JAX sizes
    with size_gather_window, a host copy equal to JAX's) and an undersized
    window, which drops sources in JAX, both drop none here (the kernel
    reads every source of a bin); a window that is not a positive integer
    raises, as it is no window."""
    th, tl, amps = _delays(11, 300, 4, "clustered")
    tau = tf.join_f64(th, tl)
    assert nd.size_gather_window(tau, DNU, 64) == \
        nd_j.size_gather_window(tau, DNU, 64)
    assert nd.size_gather_window(tau, DNU, 64, margin=1.5) == \
        nd_j.size_gather_window(tau, DNU, 64, margin=1.5)
    ref = nd_j.nufft_delay_visibilities(tau, amps, NU0, DNU, 64)
    auto = _port_spread("gather", th, tl, amps, 64)
    small = _port_spread("gather", th, tl, amps, 64, window=4)
    assert _rel(auto, ref) < F64_BAR
    np.testing.assert_array_equal(small, auto)
    assert _rel(_jax_spread("gather", th, tl, amps, 64, window=4), ref) > 1e-3
    for bad in (0, -3, 2.5):
        with pytest.raises(ValueError, match="positive integer"):
            _port_spread("gather", th, tl, amps, 64, window=bad)


def test_fold_and_setup_match_jax():
    """fold_delay_bins (float64 here, two-float in JAX) gives JAX's bins
    wherever the offset is not within 1e-6 of a tie, and offsets within
    1e-6; _sorted_spread_setup on the same bins gives JAX's starts and an
    order that sorts each baseline; a given setup leaves the spread
    unchanged."""
    th, tl, amps = _delays(8, 1024, 6, "clustered")
    m0, z0, n = nd.fold_delay_bins(_t(th), _t(tl), DNU, 128)
    m0j, z0j, nj = nd_j.fold_delay_bins(jnp.asarray(th), jnp.asarray(tl),
                                        DNU, 128)
    assert n == nj == 256 and m0.dtype == torch.int32
    assert z0.dtype == torch.float64 and float(z0.abs().max()) <= 0.5
    tie = np.abs(np.abs(z0.numpy()) - 0.5) < 1e-6
    np.testing.assert_array_equal(m0.numpy()[~tie], np.asarray(m0j)[~tie])
    assert np.abs(z0.numpy() - np.asarray(z0j))[~tie].max() < 1e-6
    order, starts = nd._sorted_spread_setup(m0, n)
    _, starts_j = nd_j._sorted_spread_setup(jnp.asarray(m0.numpy()), n)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(starts_j))
    ms = torch.take_along_dim(m0, order, dim=0)
    assert bool((ms[1:] >= ms[:-1]).all())
    args = (_t(th), _t(tl), _t(amps), NU0, DNU, 128)
    np.testing.assert_array_equal(
        nd.nufft_delay_visibilities_jax_sorted(*args).numpy(),
        nd.nufft_delay_visibilities_jax_sorted(
            *args, setup=(order, starts)).numpy())


def test_chan0_shifts_the_carrier():
    """chan0 makes the spread evaluate the sub-band that starts chan0
    channels up: equal to the full band's columns there (multirank, as the
    mesh's channel shards call it)."""
    th, tl, amps = _delays(5, 300, 5, "uniform")
    P = _t(amps[:, :2].copy())
    Q = np.ones((16, 2))
    full = nd.nufft_delay_multirank_sorted(_t(th), _t(tl), P, np.ones((64, 2)),
                                           NU0, DNU, 64)
    part = nd.nufft_delay_multirank_sorted(_t(th), _t(tl), P, Q, NU0, DNU, 16,
                                           chan0=32)
    want = nd.nufft_delay_multirank_sorted(_t(th), _t(tl), P, Q,
                                           NU0 + 32 * DNU, DNU, 16)
    assert _rel(part.numpy(), want.numpy()) < 1e-6
    assert _rel(part.numpy(), full.numpy()[:, 32:48]) < 1e-6
    pj = nd_j.nufft_delay_multirank_sorted(
        jnp.asarray(th), jnp.asarray(tl), jnp.asarray(amps[:, :2]),
        jnp.asarray(Q, jnp.float32), NU0, DNU, 16, chan0=32.0)
    assert _rel(part.numpy(), np.asarray(pj)) < JAX_BAR


def test_delays_and_basis_match_jax():
    """delays_two_float against JAX's (the same two-float algorithm) and
    chebyshev_basis_jit against the host chebyshev_projection (float32
    rounding) and JAX's traced basis (its float32 ln(nu)); P @ Q.T a
    projection."""
    rng = np.random.RandomState(1)
    s = rng.randn(50, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    seh, sel = tf.split_f64(s - [0.0, 0.0, 1.0])
    blh, bll = tf.split_f64(rng.randn(7, 3) * 100.0)
    got = tf.join_f64(*nd.delays_two_float(_t(seh), _t(sel), _t(blh),
                                           _t(bll)))
    want = tf.join_f64(*nd_j.delays_two_float(*(jnp.asarray(a) for a in
                                                (seh, sel, blh, bll))))
    exact = (s - [0.0, 0.0, 1.0]) @ (blh.astype(np.float64)
                                     + bll).T / 299792458.0
    assert np.abs(got - want).max() < 1e-12 * np.abs(exact).max()
    assert np.abs(got - exact).max() < 1e-12 * np.abs(exact).max()
    freqs = (150e6 + 390625.0 * np.arange(24)).astype(np.float32)
    pinvQ, Q = nd.chebyshev_basis_jit(_t(freqs), 8)
    pj, qj = nd_j.chebyshev_basis_jit(jnp.asarray(freqs), 8)
    pinv_h, Q_h = nd.chebyshev_projection(freqs.astype(np.float64), 8)
    assert pinvQ.dtype == Q.dtype == torch.float32
    np.testing.assert_allclose(Q.numpy(), Q_h, atol=1e-6)
    np.testing.assert_allclose(pinvQ.numpy(), pinv_h, atol=1e-6)
    # JAX builds ln(nu) in float32 (~3e-5 in Q at this band)
    np.testing.assert_allclose(Q.numpy(), np.asarray(qj), atol=1e-4)
    np.testing.assert_allclose(pinvQ.numpy(), np.asarray(pj), atol=1e-4)
    proj = Q.double() @ pinvQ.double().t()
    assert float((proj @ Q.double() - Q.double()).abs().max()) < 1e-5


def _snapshot_problem(pkg, C=64, nsrc=128):
    """tests/test_nufft_delay.py's HERA-7 snapshot problem (Airy beams,
    power-law spectra) built by either package."""
    lay, bls, sm = pkg[:3]
    bset = bls.build_baselines(lay.preset_layout("HERA-7"), redundant=False)
    freqs = 120e6 + 97656.25 * np.arange(C)
    model = sm.random_point_source_model(nsrc, seed=0)
    Mh, Ml = tf.split_f64(enu_rotation_from_eq(30.0, -30.72))
    pch, pcl = tf.split_f64(np.array([0.0, 0.0, 1.0]))
    if pkg[3] is airy_t:
        inst = Instrument.build(bset.vectors, freqs, torch.device("cpu"),
                                latitude=-30.72)
        sky = SkySources.from_skymodel(model, freqs, torch.device("cpu"))
        args = [_t(x) for x in (Mh, Ml, pch, pcl)]
    else:
        inst = Inst_j.build(bset.vectors, freqs, latitude=-30.72)
        sky = Sky_j.from_skymodel(model, freqs)
        args = [jnp.asarray(x) for x in (Mh, Ml, pch, pcl)]
    beam = pkg[3]
    return inst, sky, args, lambda dc, f: beam(dc, f, 14.0), freqs


JAX = (lay_j, bls_j, sm_j, airy_j)
PORT = (lay_t, bls_t, sm_t, airy_t)


@pytest.mark.parametrize("spread", ["sorted", "scatter"])
def test_snapshot_jit_matches_jax_and_direct(spread):
    inst, sky, args, beam, freqs = _snapshot_problem(PORT)
    inst_j, sky_j, args_j, beam_j, _ = _snapshot_problem(JAX)
    pinvQ, Q = nd.chebyshev_projection(freqs, 16)
    got = nd.simulate_snapshot_nufft_jit(inst, sky, *args, beam, pinvQ, Q,
                                         spread=spread).numpy()
    want = np.asarray(nd_j.simulate_snapshot_nufft_jit(
        inst_j, sky_j, *args_j, beam_j, pinvQ, Q, spread=spread))
    direct = simulate_snapshot(inst, sky, *args, beam).numpy()
    assert got.dtype == np.complex64 and got.shape == direct.shape
    assert _rel(got, want) < SNAP_BAR
    assert _rel(got, direct) < SNAP_BAR


def test_snapshot_host_svd_matches_jax_and_direct():
    inst, sky, args, beam, _ = _snapshot_problem(PORT)
    inst_j, sky_j, args_j, beam_j, _ = _snapshot_problem(JAX)
    got = nd.simulate_snapshot_nufft(inst, sky, *args, beam)
    want = nd_j.simulate_snapshot_nufft(inst_j, sky_j, *args_j, beam_j)
    direct = simulate_snapshot(inst, sky, *args, beam).numpy()
    assert _rel(got, want) < SNAP_BAR
    assert _rel(got, direct) < SNAP_BAR


def test_banded_entry_points_match_jax_interpret():
    """nufft_banded_visibilities and simulate_snapshot_nufft_banded (the
    port's prep, plain K2 and post) against JAX's interpret-mode call on
    the same plan; banded_spread_available is False without a card."""
    inst, sky, args, beam, freqs = _snapshot_problem(PORT, C=32, nsrc=64)
    inst_j, sky_j, args_j, beam_j, _ = _snapshot_problem(JAX, C=32, nsrc=64)
    bl = tf.join_f64(inst.bl_hi, inst.bl_lo)
    plan = nb.make_banded_plan(bl, inst.nu0, inst.dnu, 32, rank=16)
    plan_j = nb_j.make_banded_plan(bl, inst.nu0, inst.dnu, 32, rank=16)
    pinvQ, Q = nd.chebyshev_projection(freqs, 16)
    got, ok = nb.simulate_snapshot_nufft_banded(inst, sky, *args, beam, plan,
                                                pinvQ, Q)
    want, ok_j = nb_j.simulate_snapshot_nufft_banded(
        inst_j, sky_j, *args_j, beam_j, plan_j, pinvQ, Q, interpret=True)
    direct = simulate_snapshot(inst, sky, *args, beam).numpy()
    assert bool(ok) and bool(ok_j) and got.dtype == torch.complex64
    assert _rel(got.numpy(), np.asarray(want)) < SNAP_BAR
    assert _rel(got.numpy(), direct) < SNAP_BAR
    rng = np.random.RandomState(3)
    s = rng.randn(40, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    seh, sel = tf.split_f64(s - [0.0, 0.0, 1.0])
    P = rng.uniform(-1, 1, (40, 16)).astype(np.float32)
    v, ok = nb.nufft_banded_visibilities(plan, _t(seh), _t(sel), _t(P), Q)
    vj, okj = nb_j.nufft_banded_visibilities(
        plan_j, jnp.asarray(seh), jnp.asarray(sel), jnp.asarray(P), Q,
        interpret=True)
    assert bool(ok) and bool(okj)
    assert _rel(v.numpy(), np.asarray(vj)) < SNAP_BAR
    if not torch.cuda.is_available():
        assert nb.banded_spread_available() is False


def _run_parms(load, **proc):
    """tests/test_driver.py's engine-nufft run, on one device."""
    return load({
        "bandpass": {"nchan": 32, "freq": 155e6, "freq_resolution": 1e5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 2, "t_acc": 10.0},
        "skyparm": {"model": "random", "nsrc": 64, "seed": 0},
        "pp": {"key": "none"},
        "save_formats": {"fmt": "none", "npz": False},
        "processing": proc})


@pytest.mark.parametrize("spread", ["sorted", "scatter"])
def test_driver_sorted_route_matches_jax(spread, capsys):
    """run_simulation with engine nufft and the sorted (or scatter) spread
    against JAX's CPU run, which takes the same branch, and against the
    port's direct run; the gate passes and prints both normalizations."""
    proc = {"engine": "nufft", "nufft_spread": spread}
    vt, _ = drv_t.run_simulation(_run_parms(load_parms_t, **proc),
                                 verbose=True, save=False, device="cpu")
    out = capsys.readouterr().out
    assert "cross-check ok" in out and "max_c sum_s|A|" in out
    assert "falling back" not in out
    vj, _ = run_j(_run_parms(load_parms_j, **proc), verbose=False,
                  save=False)
    vd, _ = drv_t.run_simulation(_run_parms(load_parms_t, engine="direct"),
                                 verbose=False, save=False, device="cpu")
    assert vt.skyvis.shape == vj.skyvis.shape == (9, 32, 2)
    assert _rel(vt.skyvis, vj.skyvis) < SNAP_BAR
    assert _rel(vt.skyvis, vd.skyvis) < SNAP_BAR


def test_driver_sorted_gate_falls_back(capsys):
    """A failing cross-check (an impossible tolerance) demotes the whole
    run to the direct engine, whose result it returns
    (tests/test_driver.py:367)."""
    vd, _ = drv_t.run_simulation(_run_parms(load_parms_t, engine="direct"),
                                 verbose=False, save=False, device="cpu")
    vg, _ = drv_t.run_simulation(
        _run_parms(load_parms_t, engine="nufft", nufft_spread="sorted",
                   nufft_crosscheck_tol=1e-30),
        verbose=True, save=False, device="cpu")
    out = capsys.readouterr().out
    assert "cross-check FAILED" in out and "falling back" in out
    np.testing.assert_array_equal(vg.skyvis, vd.skyvis)


def test_driver_sorted_gate_dump(tmp_path, monkeypatch):
    """PRISIM_DEBUG_XCHECK_DUMP saves the gate's pair and inputs."""
    dump = str(tmp_path / "gate.npz")
    monkeypatch.setenv("PRISIM_DEBUG_XCHECK_DUMP", dump)
    vt, _ = drv_t.run_simulation(
        _run_parms(load_parms_t, engine="nufft", nufft_spread="sorted"),
        verbose=False, save=False, device="cpu")
    with np.load(dump) as g:
        assert g["fast0"].shape == g["direct0"].shape == (9, 32)
        assert float(g["csA0"]) >= np.abs(g["direct0"]).max()
        assert int(g["rank"]) == 16
        assert _rel(g["fast0"], g["direct0"]) < SNAP_BAR


def test_spread_inputs_are_checked():
    """The spread's wrapper checks shapes, types and devices before any
    work, and on the CPU runs the plain version without a launch."""
    th, tl, amps = _delays(2, 50, 3, "uniform")
    P = amps[:, :2].copy()
    with pytest.raises(TypeError):
        cs.delay_spread_plain(_t(th).double(), _t(tl), _t(P), NU0, DNU, 16)
    with pytest.raises(ValueError):
        cs.delay_spread_plain(_t(th), _t(tl), _t(P[:10]), NU0, DNU, 16)
    with pytest.raises(ValueError):
        cs.delay_spread_cuda(_t(th), _t(tl[:, :2]), _t(P), NU0, DNU, 16)
    n0 = cs.delay_spread_cuda.launches
    g = cs.delay_spread_cuda(_t(th), _t(tl), _t(P), NU0, DNU, 16)
    assert g.shape == (3, 32, 2) and g.dtype == torch.complex128
    assert cs.delay_spread_cuda.launches == n0
