"""The port's drift scan against prisim_tpu.engine.observe.simulate_drift,
both fed the same instrument and sky (through prisim_tpu_torch.convert)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prisim_tpu import healpix as hp
from prisim_tpu.baselines import build_baselines
from prisim_tpu.beams.analytic import airy_beam as airy_jax
from prisim_tpu.engine import observe as obs_jax
from prisim_tpu.layouts import preset_layout
from prisim_tpu.skymodel import healpix_diffuse_model

from prisim_tpu_torch import twofloat as tf
from prisim_tpu_torch.beams.analytic import airy_beam
from prisim_tpu_torch.convert import instrument_from_numpy, sky_from_numpy
from prisim_tpu_torch.engine import observe as obs_t
from prisim_tpu_torch.engine.nudft import nudft_reference_f64

LAT = -30.7224
BAR = 2e-6      # max|dV| / max|V|, the engines' f32 bar


@pytest.fixture(scope="module")
def drift():
    """HERA-7, 32 channels, nside-8 uniform sky, 2 accumulations, Airy."""
    bls = build_baselines(preset_layout("HERA-7"), redundant=False)
    freqs = 150e6 + 97656.25 * (np.arange(32) - 16)
    sky = healpix_diffuse_model(np.ones(hp.nside2npix(8)),
                                freqs_model=np.asarray([150e6]))
    inst_j = obs_jax.Instrument.build(bls.vectors, freqs, latitude=LAT)
    sky_j = obs_jax.SkySources.from_skymodel(sky, freqs)
    lst = np.asarray([30.0, 30.25])
    obs = obs_jax.Observation(
        lst_deg=lst, jd=2457000.0 + lst / 360.0, t_acc=np.full(2, 60.0),
        pointing_altaz=np.tile([[90.0, 270.0]], (2, 1)))
    vis_j = np.asarray(obs_jax.simulate_drift(
        inst_j, sky_j, obs, lambda s, f: airy_jax(s, f, 14.0),
        src_block=128))
    inst_t = instrument_from_numpy(np.asarray(inst_j.bl_hi),
                                   np.asarray(inst_j.bl_lo), freqs,
                                   device="cpu", latitude=LAT)
    sky_t = sky_from_numpy(np.asarray(sky_j.s_eq_hi),
                           np.asarray(sky_j.s_eq_lo), np.asarray(sky_j.flux),
                           device="cpu")
    obs_port = obs_t.Observation(obs.lst_deg, obs.jd, obs.t_acc,
                                 obs.pointing_altaz)
    beam = lambda s, f: airy_beam(s, f, 14.0)        # noqa: E731
    vis_t = obs_t.simulate_drift(inst_t, sky_t, obs_port, beam,
                                 src_block=128)
    return dict(vis_j=vis_j, vis_t=vis_t.numpy(), inst=inst_t, sky=sky_t,
                obs=obs_port, beam=beam, freqs=freqs)


def test_drift_matches_jax(drift):
    vj, vt = drift["vis_j"], drift["vis_t"]
    assert vt.shape == vj.shape == (2, 21, 32)
    assert vt.dtype == np.complex64
    scale = np.abs(vj).max()
    assert np.abs(vt - vj).max() / scale < BAR


def test_drift_matches_f64_golden(drift):
    """Each snapshot against the float64 sum over the same rotated
    directions and amplitudes."""
    inst, sky, obs = drift["inst"], drift["sky"], drift["obs"]
    Mh, Ml, pch, pcl = obs_t.schedule_tensors(obs, inst.latitude, "cpu")
    for t in range(obs.n_acc):
        seh, sel, amps, _ = obs_t.snapshot_nudft_inputs(
            inst, sky, Mh[t], Ml[t], pch[t], pcl[t], drift["beam"])
        gold = nudft_reference_f64(
            tf.join_f64(seh, sel), tf.join_f64(inst.bl_hi, inst.bl_lo),
            amps, drift["freqs"]).numpy()
        scale = np.abs(gold).max()
        assert np.abs(drift["vis_t"][t] - gold).max() / scale < BAR


def test_beam_and_rotation_match_jax(drift):
    """Snapshot inputs: two-float rotation bit-for-bit, Airy beam to f32
    rounding."""
    inst, sky, obs = drift["inst"], drift["sky"], drift["obs"]
    Mh, Ml = obs.rotations(LAT)
    sh_j, sl_j = obs_jax.df_rotate3(jnp.asarray(Mh[0]), jnp.asarray(Ml[0]),
                                    jnp.asarray(sky.s_eq_hi.numpy()),
                                    jnp.asarray(sky.s_eq_lo.numpy()))
    sh_t, sl_t = obs_t.df_rotate3(torch.as_tensor(Mh[0]),
                                  torch.as_tensor(Ml[0]), sky.s_eq_hi,
                                  sky.s_eq_lo)
    np.testing.assert_array_equal(sh_t.numpy(), np.asarray(sh_j))
    np.testing.assert_array_equal(sl_t.numpy(), np.asarray(sl_j))
    f32 = drift["freqs"].astype(np.float32)
    pb_j = np.asarray(airy_jax(sh_j, jnp.asarray(f32), 14.0))
    pb_t = airy_beam(sh_t, torch.as_tensor(f32), 14.0).numpy()
    np.testing.assert_allclose(pb_t, pb_j, rtol=0, atol=2e-6)


def test_shaped_gradient_drift_matches_jax():
    """The drift scan with shapes (every pixel the nside-8 pixel gaussian,
    every fifth one a point source) and with the gradient moments, in both
    packages on the same inputs. The port's sigma equals JAX's, and JAX's
    SkySources carries across with sky_from_numpy."""
    import dataclasses
    bls = build_baselines(preset_layout("HERA-7"), redundant=False)
    freqs = 150e6 + 97656.25 * (np.arange(16) - 8)
    npix = hp.nside2npix(8)
    res = np.degrees(np.sqrt(hp.nside2pixarea(8)))
    shape = np.tile([res, res, 0.0], (npix, 1))
    shape[::5, :2] = 0.0
    sky = dataclasses.replace(healpix_diffuse_model(
        1.0 + 0.1 * np.random.RandomState(3).rand(npix),
        freqs_model=np.asarray([150e6])), src_shape=shape)
    inst_j = obs_jax.Instrument.build(bls.vectors, freqs, latitude=LAT)
    sky_j = obs_jax.SkySources.from_skymodel(sky, freqs)
    obs = obs_jax.Observation(
        lst_deg=np.asarray([30.0]), jd=np.asarray([2457000.1]),
        t_acc=np.asarray([60.0]), pointing_altaz=np.asarray([[90.0, 270.0]]))
    vj, gj = (np.asarray(x) for x in obs_jax.simulate_drift(
        inst_j, sky_j, obs, lambda s, f: airy_jax(s, f, 14.0),
        src_block=128, gradient=True))
    sig_j = np.asarray(sky_j.src_shape_sigma)
    np.testing.assert_array_equal(obs_t.SkySources.from_skymodel(
        sky, freqs, "cpu").src_shape_sigma.numpy(), sig_j)
    assert np.isinf(sig_j[::5]).all() and np.isfinite(sig_j[1::5]).all()
    inst_t = instrument_from_numpy(np.asarray(inst_j.bl_hi),
                                   np.asarray(inst_j.bl_lo), freqs,
                                   device="cpu", latitude=LAT)
    sky_t = sky_from_numpy(np.asarray(sky_j.s_eq_hi),
                           np.asarray(sky_j.s_eq_lo), np.asarray(sky_j.flux),
                           device="cpu", src_shape_sigma=sig_j)
    vt, gt = obs_t.simulate_drift(
        inst_t, sky_t, obs_t.Observation(obs.lst_deg, obs.jd, obs.t_acc,
                                         obs.pointing_altaz),
        lambda s, f: airy_beam(s, f, 14.0), src_block=128, gradient=True)
    assert vt.shape == (1, 21, 16) and gt.shape == (1, 3, 21, 16)
    assert np.abs(vt.numpy() - vj).max() / np.abs(vj).max() < 3e-6
    assert np.abs(gt.numpy() - gj).max() / np.abs(gj).max() < 5e-6


@pytest.mark.parametrize("axis", [None, (0.1, -0.05, 0.99373)])
def test_airy_dish_keeps_the_chain_on_the_cpu(axis):
    """A beam_fn marked as a plain Airy dish (`airy`) weights CPU tensors
    with the torch chain, unchanged: airy_beam x flux zeroed below the
    horizon, bit for bit, and no kernel launch; airy_amps_cuda refuses CPU
    tensors."""
    from prisim_tpu_torch import tracing
    from prisim_tpu_torch.engine.cuda_beam import airy_amps_cuda
    rng = np.random.RandomState(4)
    s = rng.randn(400, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    s[0] = [0.6, 0.8, 0.0]
    s = torch.as_tensor(s, dtype=torch.float32)
    f = torch.linspace(100e6, 200e6, 37)
    flux = torch.as_tensor(rng.uniform(0, 9, (400, 37)), dtype=torch.float32)

    def beam_fn(d, nu):
        return airy_beam(d, nu, 14.0, pointing_dircos=axis)
    beam_fn.airy = (14.0, axis)
    want = torch.where((s[:, 2] > 0.0)[:, None],
                       airy_beam(s, f, 14.0, pointing_dircos=axis) * flux,
                       torch.zeros_like(flux))
    n0 = airy_amps_cuda.launches
    tracing.take()
    with tracing.on():
        with tracing.span("beam_flux"):
            got = obs_t._beam_and_flux(s, flux, f, beam_fn)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        airy_amps_cuda(s, flux, 14.0, f, axis=axis)
    assert airy_amps_cuda.launches == n0
    assert tracing.take()[-1]["launches"] == {}
    assert not got[0].any()
