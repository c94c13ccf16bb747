"""The port's beams (prisim_tpu_torch/beams, engine/power.py) against
prisim_tpu's on the same seeded inputs: every analytic function, every
branch of the dispatcher, the random delay/gain errors, the external
HEALPix beam and antenna_power.

Bar: 1e-5 of the maximum of the compared pattern (float32 maths in both
packages, summed in other orders); the external beam's device evaluation
1e-6 (its values are at most 1), its host methods exactly."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prisim_tpu import healpix as hp_jax
from prisim_tpu.beams import analytic as AJ
from prisim_tpu.beams import dispatch as DJ
from prisim_tpu.beams.external import ExternalBeam as ExtJ
from prisim_tpu.engine.power import antenna_power as power_jax
from prisim_tpu.io import fitsio as fits_jax
from prisim_tpu.skymodel import random_point_source_model as rpsm_jax

from prisim_tpu_torch.beams import analytic as AT
from prisim_tpu_torch.beams import dispatch as DT
from prisim_tpu_torch.beams.external import ExternalBeam as ExtT
from prisim_tpu_torch.engine.power import antenna_power as power_t
from prisim_tpu_torch.io import fitsio as fits_t
from prisim_tpu_torch.skymodel import random_point_source_model as rpsm_t

BAR = 1e-5
FREQS = (140e6 + 1.5e6 * np.arange(12)).astype(np.float32)
FREQS_400 = (380e6 + 3e6 * np.arange(12)).astype(np.float32)


def _dircos(n=300, seed=3, upper=False):
    """Unit vectors from a numpy seed, float32; a few exactly at zenith,
    the horizon and along the x axis (the dipole's null)."""
    rng = np.random.RandomState(seed)
    s = rng.randn(n, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    if upper:
        s[:, 2] = np.abs(s[:, 2])
    s[:3] = [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.6, 0.8]]
    return s.astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, bar=BAR):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    if nan.all():
        return
    scale = np.abs(want[~nan]).max()
    assert np.abs(got[~nan] - want[~nan]).max() <= bar * scale


def _both(name, *args, freqs=FREQS, dircos=None, **kw):
    """The same function of both packages on the same inputs."""
    dc = _dircos() if dircos is None else dircos
    want = getattr(AJ, name)(jnp.asarray(dc), jnp.asarray(freqs), *args, **kw)
    got = getattr(AT, name)(_t(dc), _t(freqs), *args, **kw)
    return got, want


# --------------------------------------------------------------------------
# analytic functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"power": False}, {"short_dipole": True}, {"half_wave": True},
    {"orientation_dircos": (0.3, 0.9, 0.1), "power": False},
    {"orientation_dircos": (0.0, 1.0, 0.0), "half_wave": True,
     "power": False}])
def test_dipole_beam(kw):
    _close(*_both("dipole_beam", 0.74, **kw))


@pytest.mark.parametrize("kw", [
    {}, {"power": True}, {"modifier": {"scale": 0.5}},
    {"modifier": {"scale": 2.0, "max": 1.5}, "power": True}])
def test_ground_plane_pattern(kw):
    _close(*_both("ground_plane_pattern", 0.3, **kw))


@pytest.mark.parametrize("freqs", [FREQS, FREQS_400])
def test_vla_pbcor_beam(freqs):
    for clip in (True, False):
        got = AT.vla_pbcor_beam(_t(_dircos()), _t(freqs), clip_negative=clip)
        want = AJ.vla_pbcor_beam(jnp.asarray(_dircos()), np.asarray(freqs),
                                 clip_negative=clip)
        _close(got, want)
        # the band from a host frequency: no read of the device tensor
        _close(AT.vla_pbcor_beam(_t(_dircos()), _t(freqs), clip_negative=clip,
                                 band_freq=float(freqs[0])), want)


@pytest.mark.parametrize("inst", ["gmrt", "ugmrt"])
@pytest.mark.parametrize("freqs", [FREQS, FREQS_400])
def test_gmrt_beam(inst, freqs):
    """uGMRT has no 235 MHz band: NaN at 150 MHz in both packages."""
    got = AT.gmrt_beam(_t(_dircos()), _t(freqs), instrument=inst)
    want = AJ.gmrt_beam(jnp.asarray(_dircos()), np.asarray(freqs),
                        instrument=inst)
    _close(got, want)
    assert np.isnan(np.asarray(want)).all() == (inst == "ugmrt"
                                               and freqs is FREQS)


@pytest.mark.parametrize("kw", [
    {}, {"power": False}, {"pointing_dircos": (0.1, -0.2, 0.97)}])
def test_uniform_apertures(kw):
    _close(*_both("uniform_rect_aperture_beam", (4.0, 2.5), **kw))
    _close(*_both("uniform_square_aperture_beam", 3.0, **kw))


def test_mwa_tile_positions():
    np.testing.assert_array_equal(AT.mwa_tile_positions(),
                                  AJ.mwa_tile_positions())


_POINT = (0.1, -0.05, float(np.sqrt(1 - 0.1 ** 2 - 0.05 ** 2)))


@pytest.mark.parametrize("kw", [
    {}, {"pointing_dircos": _POINT}, {"nrand": 3},
    {"delays": np.linspace(0, 3e-9, 16), "gains": np.linspace(0.5, 1.5, 16)},
])
def test_array_field_pattern(kw):
    """Zero errors: the beamformer's complex field, (S, C, nrand)."""
    dc = _dircos(upper=True)
    got = AT.array_field_pattern(AT.mwa_tile_positions(), _t(dc), _t(FREQS),
                                 **kw)
    want = AJ.array_field_pattern(AJ.mwa_tile_positions(), jnp.asarray(dc),
                                  jnp.asarray(FREQS), **kw)
    _close(got, want)


_NEL = 12
_RNG = np.random.RandomState(11)
_LOCS = _RNG.uniform(-3, 3, (_NEL, 3)) * [1, 1, 0.1]
_GEN_CASES = {
    "plain": {},
    "locs_2col": {"locs": _LOCS[:, :2]},
    "pointing": {"pointing_dircos": _POINT},
    "delay_scalar": {"delays": 1e-9},
    "delay_per_elem": {"delays": _RNG.uniform(0, 5e-9, _NEL)},
    "delay_per_chan": {"delays": _RNG.uniform(0, 5e-9, len(FREQS))},
    "gain_complex_2d": {"gains": (_RNG.rand(_NEL, len(FREQS))
                                  * np.exp(1j * _RNG.rand(_NEL, len(FREQS))))},
    "gain_3d": {"gains": _RNG.rand(_NEL, len(FREQS), 2)},
    "nrand": {"nrand": 3, "gains": _RNG.rand(_NEL)},
}


@pytest.mark.parametrize("case", sorted(_GEN_CASES))
@pytest.mark.parametrize("power", [False, True])
def test_generic_aperture_field_pattern(case, power):
    kw = dict(_GEN_CASES[case])
    locs = kw.pop("locs", _LOCS)
    dc = _dircos(upper=True)
    got = AT.generic_aperture_field_pattern(locs, _t(dc), _t(FREQS),
                                            power=power, **kw)
    want = AJ.generic_aperture_field_pattern(locs, jnp.asarray(dc),
                                             jnp.asarray(FREQS), power=power,
                                             **kw)
    _close(got, want)


_FEEDS = {
    "delta": {"shape": "delta"},
    "dipole": {"shape": "dipole", "size": 1.2, "position": (0.0, 0.0, 2.0),
               "orientation_dircos": (0.0, 1.0, 0.0)},
    "dipole_gp": {"shape": "dipole", "size": 1.2, "groundplane": 0.3,
                  "ground_modify": {"scale": 0.8}},
    "dish": {"shape": "dish", "size": 2.0, "position": (0.5, 0.0, -1.0)},
    "rect": {"shape": "rect", "size": (1.0, 0.5)},
    "square": {"shape": "square", "size": 0.8},
    "array": {"shape": "dipole", "size": 0.74,
              "element_locs": np.asarray([[0.0, 0.0, 0.0], [1.1, 0.0, 0.0],
                                          [0.0, 1.1, 0.0]])},
}


@pytest.mark.parametrize("feed", sorted(_FEEDS))
def test_feed_functions(feed):
    info = _FEEDS[feed]
    dc = _dircos(upper=True)
    rel_t, ill_t = AT.feed_illumination_of_aperture(_LOCS, info, _t(FREQS))
    rel_j, ill_j = AJ.feed_illumination_of_aperture(_LOCS, info,
                                                    jnp.asarray(FREQS))
    np.testing.assert_array_equal(rel_t, rel_j)
    _close(ill_t, ill_j)
    for power in (True, False):
        _close(AT.feed_aperture_combined_field_pattern(
            _LOCS, info, _t(dc), _t(FREQS), pointing_dircos=_POINT,
            power=power),
            AJ.feed_aperture_combined_field_pattern(
                _LOCS, info, jnp.asarray(dc), jnp.asarray(FREQS),
                pointing_dircos=_POINT, power=power))


def test_feed_shape_invalid_raises():
    with pytest.raises(ValueError, match="invalid feed shape"):
        AT.feed_illumination_of_aperture(_LOCS, {"shape": "horn"},
                                         _t(FREQS))


# --------------------------------------------------------------------------
# the dispatcher
# --------------------------------------------------------------------------

_ORI = (0.2, 0.1, float(np.sqrt(1 - 0.05)))
_TELESCOPES = dict(
    [("id_%s" % tid, {"id": tid}) for tid in
     ("vla", "gmrt", "ugmrt", "hera", "hirax", "mwa", "mwa_dipole", "paper")]
    + [("%s%s" % (shape, "_gp" if gp else ""),
        {"id": "custom", "shape": shape,
         "size": {"rect": (4.0, 2.0)}.get(shape, 2.0 if shape in
                                          ("dish", "gaussian", "square")
                                          else 0.74),
         "groundplane": 0.3 if gp else None})
       for shape in ("delta", "dipole", "dish", "gaussian", "rect",
                     "square") for gp in (False, True)]
    + [("hera_steered", {"id": "hera", "orientation_dircos": _ORI}),
       ("mwa_gp_modified", {"id": "mwa", "groundplane": 0.3,
                            "ground_modify": {"scale": 1.0, "max": 2.0}}),
       ("paper_oriented", {"id": "paper", "orientation_dircos": (0, 1, 0)}),
       ("aperture", {"id": "custom", "aperture_locs": _LOCS}),
       ("aperture_feed", {"id": "custom", "aperture_locs": _LOCS,
                          "feedinfo": _FEEDS["dipole"]}),
       ("phased_dipole", {"id": "custom", "shape": "dipole", "size": 0.74,
                          "element_locs": AJ.mwa_tile_positions()})])

_PINFO = {"phased_dipole": {"pointing_center_dircos": _POINT},
          "mwa_gp_modified": {"pointing_center_dircos": _POINT, "nrand": 2},
          "aperture": {"pointing_center_dircos": _POINT}}


@pytest.mark.parametrize("pol", ["X", "Y"])
@pytest.mark.parametrize("name", sorted(_TELESCOPES))
def test_dispatcher_matches_jax(name, pol):
    tel = _TELESCOPES[name]
    pinfo = _PINFO.get(name)
    freqs = FREQS_400 if tel["id"] in ("vla", "gmrt", "ugmrt") else FREQS
    dc = _dircos()
    want = DJ.primary_beam(jnp.asarray(dc), jnp.asarray(freqs), tel,
                           pointing_info=pinfo, pol=pol)
    got = DT.primary_beam(_t(dc), _t(freqs), tel, pointing_info=pinfo,
                          pol=pol)
    assert got.shape == (dc.shape[0], freqs.size)
    _close(got, want)


def test_dispatcher_steering_tensor():
    """The driver passes the snapshot's pointing as a (3,) tensor; it gives
    what the tuple gives."""
    dc = _t(_dircos(upper=True))
    tel = {"id": "mwa"}
    a = DT.primary_beam(dc, _t(FREQS), tel,
                        pointing_info={"pointing_center_dircos": _POINT})
    b = DT.primary_beam(dc, _t(FREQS), tel, pointing_info={
        "pointing_center_dircos": torch.tensor(_POINT, dtype=torch.float32)})
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [
    {"shape": "horn"}, {"pol": "Z"}])
def test_dispatcher_raises_as_jax(kw):
    kw = dict(kw)
    pol = kw.pop("pol", "X")
    tel = dict({"id": "custom", "size": 1.0}, **kw)
    for pb, mod in ((DT.primary_beam, torch.as_tensor),
                    (DJ.primary_beam, jnp.asarray)):
        with pytest.raises(ValueError):
            pb(mod(_dircos()), mod(FREQS), tel, pol=pol)


# --------------------------------------------------------------------------
# random delay and gain errors
# --------------------------------------------------------------------------

def test_errors_repeat_with_the_same_seed():
    dc, f = _t(_dircos(upper=True)), _t(FREQS)
    pos = AT.mwa_tile_positions()
    kw = dict(delayerr=1e-9, gainerr_db=0.5, nrand=4)
    a = AT.array_field_pattern(pos, dc, f, **kw)
    b = AT.array_field_pattern(pos, dc, f, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = AT.array_field_pattern(pos, dc, f, generator=torch.Generator()
                               .manual_seed(0), **kw)
    torch.testing.assert_close(a, g, rtol=0, atol=0)
    c = AT.array_field_pattern(pos, dc, f, generator=torch.Generator()
                               .manual_seed(1), **kw)
    assert (a - c).abs().max() > 1e-3
    # with no errors the realizations are all the zero-error field
    z = AT.array_field_pattern(pos, dc, f, nrand=2)
    torch.testing.assert_close(z[..., 0], z[..., 1], rtol=0, atol=0)
    ga = AT.generic_aperture_field_pattern(_LOCS, dc, f, power=True, **kw)
    gb = AT.generic_aperture_field_pattern(_LOCS, dc, f, power=True, **kw)
    torch.testing.assert_close(ga, gb, rtol=0, atol=0)
    tel = {"id": "mwa"}
    pinfo = {"delayerr": 1e-9, "gainerr": 0.5, "nrand": 4}
    torch.testing.assert_close(
        DT.primary_beam(dc, f, tel, pointing_info=pinfo),
        DT.primary_beam(dc, f, tel, pointing_info=pinfo), rtol=0, atol=0)


@pytest.mark.parametrize("fn", ["array", "generic"])
def test_errors_decorrelate_the_mean_power(fn):
    """At the pointing (zenith; elements in the ground plane, so every
    geometric phase is zero) AF = (1/N) sum_a g_a exp(2 pi i nu d_a) with
    d_a ~ N(0, s^2) and g_a = 10^((e/10) z_a): E|AF|^2 = (N E[g^2]
    + N (N - 1) E[g]^2 exp(-(2 pi nu s)^2)) / N^2, with E[g] =
    exp(k^2/2), E[g^2] = exp(2 k^2), k = e ln(10)/10. Over 20,000
    realizations the mean power is within 3% of it."""
    s_d, e_db, nrand = 1e-9, 0.5, 20000
    pos = AT.mwa_tile_positions()
    n = pos.shape[0]
    dc = torch.tensor([[0.0, 0.0, 1.0]])
    f = torch.tensor([100e6, 150e6, 200e6])
    kw = dict(pointing_dircos=(0.0, 0.0, 1.0), delayerr=s_d, gainerr_db=e_db,
              nrand=nrand)
    if fn == "array":
        af = AT.array_field_pattern(pos, dc, f, **kw)
        power = (af.abs() ** 2).mean(dim=-1)
    else:
        power = AT.generic_aperture_field_pattern(pos, dc, f, power=True,
                                                  **kw)
    k = e_db * np.log(10.0) / 10.0
    eg, eg2 = np.exp(0.5 * k * k), np.exp(2 * k * k)
    want = (n * eg2 + n * (n - 1) * eg ** 2
            * np.exp(-(2 * np.pi * f.double().numpy() * s_d) ** 2)) / n ** 2
    np.testing.assert_allclose(power[0].double().numpy(), want, rtol=0.03)
    assert power[0, 2] < 0.5 * power[0, 0]   # decorrelation grows with nu


# --------------------------------------------------------------------------
# external HEALPix beams
# --------------------------------------------------------------------------

def _beam_maps(nside=16, bfreqs=(120e6, 150e6, 180e6, 210e6)):
    theta, phi = hp_jax.pix2ang(nside, np.arange(hp_jax.nside2npix(nside)))
    st = np.sin(theta)
    maps = np.stack([np.exp(-((st * np.cos(phi)) ** 2 / 1.1
                              + (st * np.sin(phi)) ** 2 / 0.9)
                            / (0.3 * 150e6 / f) ** 2)
                     for f in bfreqs], axis=1)
    maps[theta > np.pi / 2] *= 1e-3
    return maps, np.asarray(bfreqs)


def _altaz(n=400, seed=5):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-20, 90, n), rng.uniform(0, 360, n)], -1)


CHANS = 150e6 + 195312.5 * np.arange(16)


@pytest.mark.parametrize("kw", [
    {}, {"chromatic": False}, {"chromatic": False, "select_freq": 180e6},
    {"spec_interp": "linear"}, {"nest": True}, {"single": True}])
def test_external_host_methods_exact(kw):
    kw = dict(kw)
    init = {k: kw.pop(k) for k in ("spec_interp", "nest") if k in kw}
    maps, bfreqs = _beam_maps()
    if kw.pop("single", False):
        maps, bfreqs = maps[:, 1:2], bfreqs[1:2]
    et, ej = ExtT(maps, bfreqs, **init), ExtJ(maps, bfreqs, **init)
    assert et.nside == ej.nside == 16
    np.testing.assert_array_equal(et.channel_table(CHANS, **kw),
                                  ej.channel_table(CHANS, **kw))
    for a, b in zip(et.interp_weights(_altaz()), ej.interp_weights(_altaz())):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(et.evaluate(_altaz(), CHANS, **kw),
                                  ej.evaluate(_altaz(), CHANS, **kw))


@pytest.mark.parametrize("chunk", [None, 1, 37, 400])
def test_external_device_evaluate_matches_jax(chunk):
    """The torch evaluation within 1e-6 of JAX's (values <= 1) and the same
    for every chunk of the gather; both near the host evaluate()."""
    maps, bfreqs = _beam_maps()
    et = ExtT(maps, bfreqs)
    table = et.channel_table(CHANS)
    pix, wgt = et.interp_weights(_altaz())
    want = np.asarray(ExtJ.device_evaluate(jnp.asarray(table),
                                           jnp.asarray(pix),
                                           jnp.asarray(wgt)))
    got = ExtT.device_evaluate(_t(table), _t(pix), _t(wgt), chunk).numpy()
    assert got.shape == want.shape == (400, CHANS.size)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6
    whole = ExtT.device_evaluate(_t(table), _t(pix), _t(wgt)).numpy()
    np.testing.assert_array_equal(got, whole)
    host = et.evaluate(_altaz(), CHANS)
    assert np.abs(got - host).max() < 2e-5


def test_fits_beam_written_by_port_reads_in_both(tmp_path):
    """A FITS beam written by the port's write_image (the same bytes as
    JAX's writer) is read by both packages' from_fits."""
    maps, bfreqs = _beam_maps()
    path = tmp_path / "beam.fits"
    with open(path, "wb") as fh:
        fits_t.write_image(fh, maps, primary=True)
        fits_t.write_image(fh, bfreqs, extname="FREQS")
    buf = io.BytesIO()
    fits_jax.write_image(buf, maps, primary=True)
    fits_jax.write_image(buf, bfreqs, extname="FREQS")
    assert path.read_bytes() == buf.getvalue()
    et, ej = ExtT.from_fits(str(path)), ExtJ.from_fits(str(path))
    np.testing.assert_array_equal(et.maps, maps)
    np.testing.assert_array_equal(ej.maps, maps)
    np.testing.assert_array_equal(et.freqs, ej.freqs)
    np.testing.assert_array_equal(et.evaluate(_altaz(), CHANS),
                                  ej.evaluate(_altaz(), CHANS))


@pytest.mark.parametrize("data", [None, np.arange(6, dtype=np.int64)
                                  .reshape(2, 3),
                                  np.ones((3, 4), np.float32)])
def test_write_image_same_bytes_as_jax(data):
    a, b = io.BytesIO(), io.BytesIO()
    for fh, mod in ((a, fits_t), (b, fits_jax)):
        mod.write_image(fh, data, primary=True)
        mod.write_image(fh, data, extname="X",
                        extra_cards=[mod.card("BUNIT", "K")])
    assert a.getvalue() == b.getvalue()


def test_external_from_hdf5(tmp_path):
    import h5py
    maps, bfreqs = _beam_maps()
    path = str(tmp_path / "beam.hdf5")
    with h5py.File(path, "w") as f:
        f["beam"] = maps
        f["freqs"] = bfreqs
    et, ej = ExtT.from_hdf5(path), ExtJ.from_hdf5(path)
    np.testing.assert_array_equal(et.maps, ej.maps)
    np.testing.assert_array_equal(et.freqs, ej.freqs)


# --------------------------------------------------------------------------
# antenna power
# --------------------------------------------------------------------------

@pytest.mark.parametrize("beam", ["airy", "dipole_gp"])
def test_antenna_power_matches_jax(beam):
    freqs = np.linspace(120e6, 180e6, 8)
    smj = rpsm_jax(200, flux_min=1.0, flux_max=50.0, seed=4)
    smt = rpsm_t(200, flux_min=1.0, flux_max=50.0, seed=4)
    tel = ({"id": "hera"} if beam == "airy" else
           {"id": "custom", "shape": "dipole", "size": 1.0,
            "groundplane": 0.4})
    want = power_jax(smj, freqs, [10.0, 200.0], -30.7,
                     lambda s, f: DJ.primary_beam(s, f, tel))
    got = power_t(smt, freqs, [10.0, 200.0], -30.7,
                  lambda s, f: DT.primary_beam(s, f, tel), device="cpu")
    assert got.shape == want.shape == (2, 8)
    assert np.abs(got - want).max() <= BAR * np.abs(want).max()


def test_antenna_power_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    sm = rpsm_t(4, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        power_t(sm, np.asarray([150e6]), [0.0], -30.7,
                lambda s, f: DT.primary_beam(s, f, {"id": "hera"}))
