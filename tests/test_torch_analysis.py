"""The port's analysis stack (prisim_tpu_torch.analysis, vis.delay_transform
with freq_wts, phase_centering with do_delay_transform) on the CPU: the
cases of tests/test_analysis.py run on the port, and each torch function
against its prisim_tpu counterpart on the same seeded numpy inputs.

Tolerances: the torch FFT paths within 1e-6 of max|out| of jnp.fft in
complex64; CLEAN with niter and terminated_by equal per spectrum and cc,
res, inrms and outrms within 1e-5 of max|inp|, on inputs without near-ties
at the argmax (complex gaussian draws)."""

import numpy as np
import pytest

from prisim_tpu import vis as vis_j
from prisim_tpu.analysis import clean as clean_j
from prisim_tpu.analysis import delay as delay_j
from prisim_tpu.analysis import power_spectrum as ps_j
from prisim_tpu_torch import constants as CNST
from prisim_tpu_torch import healpix as hp
from prisim_tpu_torch import vis as vis_t
from prisim_tpu_torch.analysis import cosmology as C
from prisim_tpu_torch.analysis import clean as clean_t
from prisim_tpu_torch.analysis import delay as delay_t
from prisim_tpu_torch.analysis import power_spectrum as ps_t

FFT_TOL = 1e-6
CLEAN_TOL = 1e-5


# -- cosmology ---------------------------------------------------------------

def test_efunc_matter_dominated_limit():
    cos = C.FlatLCDM(H0=100.0, Om0=1.0, Tcmb0=0.0)
    z = np.asarray([0.0, 1.0, 3.0])
    np.testing.assert_allclose(cos.efunc(z), (1 + z) ** 1.5, rtol=1e-12)


def test_comoving_distance_einstein_de_sitter():
    # EdS closed form: D_C = 2 (c/H0) [1 - 1/sqrt(1+z)]
    cos = C.FlatLCDM(H0=100.0, Om0=1.0, Tcmb0=0.0)
    z = 8.0
    expect = 2 * (CNST.c / 1e3 / 100.0) * (1 - 1 / np.sqrt(1 + z))
    np.testing.assert_allclose(cos.comoving_distance(z), expect, rtol=1e-5)


def test_comoving_distance_lcdm_value():
    # Planck15-with-h=1 at z=8.5 (150 MHz band): ~ 6380 Mpc/h
    d = C.cosmo100.comoving_distance(8.5)
    assert 6000 < d < 6700


def test_kparallel_scaling():
    z = 8.0
    lags = np.asarray([0.0, 1e-7, 2e-7])
    k = C.k_parallel(lags, z)
    assert k[0] == 0.0
    np.testing.assert_allclose(k[2], 2 * k[1], rtol=1e-12)
    # known magnitude: dkprll_deta(z=8.5) ~ 5.4e5 (h/Mpc)/s
    assert 3e5 < C.dkprll_deta(8.5) < 8e5


def test_freq_z_roundtrip():
    f = 150e6
    np.testing.assert_allclose(C.z_to_freq(C.freq_to_z(f)), f, rtol=1e-12)


# -- horizon limits ----------------------------------------------------------

def test_horizon_limits_zenith_symmetric():
    bl = np.asarray([[100.0, 0.0, 0.0], [0.0, 50.0, 0.0]])
    zenith = np.asarray([[0.0, 0.0, 1.0]])
    h = delay_t.horizon_delay_limits(bl, zenith)
    assert h.shape == (1, 2, 2)
    np.testing.assert_allclose(h[0, :, 1], [100.0 / CNST.c, 50.0 / CNST.c],
                               rtol=1e-12)
    np.testing.assert_allclose(h[0, :, 0], -h[0, :, 1], rtol=1e-12)


def test_horizon_limits_shifted_phase_center():
    bl = np.asarray([[100.0, 0.0, 0.0]])
    pc = np.asarray([[0.5, 0.0, np.sqrt(1 - 0.25)]])
    h = delay_t.horizon_delay_limits(bl, pc)
    np.testing.assert_allclose(h[0, 0, 1], (100.0 - 50.0) / CNST.c,
                               rtol=1e-12)
    np.testing.assert_allclose(h[0, 0, 0], (-100.0 - 50.0) / CNST.c,
                               rtol=1e-12)


# -- subband transform -------------------------------------------------------

def _vs_flat(nbl=2, nchan=64, nacc=1, cls=vis_t.VisibilitySet):
    rng = np.random.RandomState(0)
    return cls(
        baselines=rng.randn(nbl, 3) * 30,
        labels=np.asarray([[str(i + 1), "0"] for i in range(nbl)]),
        freqs=150e6 + 1e5 * np.arange(nchan),
        lst=np.asarray([10.0] * nacc),
        skyvis=np.ones((nbl, nchan, nacc), dtype=np.complex128),
        latitude=-30.7)


def _vs_random(nbl=3, nchan=32, nacc=2, seed=4, cls=vis_t.VisibilitySet):
    """Seeded random cubes (skyvis, vis, noise), a non-trivial bandpass
    and phase center: the same fields for either package's class."""
    rng = np.random.RandomState(seed)
    shp = (nbl, nchan, nacc)

    def cube():
        return (rng.randn(*shp) + 1j * rng.randn(*shp)).astype(np.complex64)
    return cls(
        baselines=rng.randn(nbl, 3) * 60,
        labels=np.asarray([[str(i + 1), "0"] for i in range(nbl)]),
        freqs=150e6 + 2e5 * np.arange(nchan),
        lst=10.0 + 0.25 * np.arange(nacc),
        skyvis=cube(), vis=cube(), vis_noise=cube(),
        bp=rng.uniform(0.5, 1.0, shp), bp_wts=rng.uniform(0.5, 1.0, shp),
        phase_center=np.tile([[80.0, 30.0]], (nacc, 1)), latitude=-30.7)


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


def test_subband_transform_shapes_and_peak():
    vs = _vs_flat()
    out = delay_t.subband_delay_transform(vs, freq_center=[152e6, 155e6],
                                          bw_eff=2e6, shape="bhw", pad=1.0,
                                          device="cpu")
    assert out["freq_wts"].shape == (2, 64)
    nlag = 128
    assert out["lags"].size == nlag
    assert out["skyvis_lag"].shape == (2, 2, nlag, 1)
    # flat spectrum: delay peak at 0 lag for every window
    pk = np.argmax(np.abs(out["skyvis_lag"][0, :, :, 0]), axis=1)
    assert np.all(out["lags"][pk] == 0.0)


def test_subband_window_normalization():
    # center the subband so the window lies fully inside the band
    vs = _vs_flat()
    out = delay_t.subband_delay_transform(vs, freq_center=[153e6],
                                          bw_eff=2e6, device="cpu")
    w = out["freq_wts"][0]
    from prisim_tpu_torch.windows import window_frac_width
    fw = window_frac_width("bhw")
    n_window = int(np.round(2e6 / 1e5 / fw))
    assert np.sum(w > 0) == n_window
    np.testing.assert_allclose(np.sum(w ** 2), fw * n_window, rtol=1e-6)


@pytest.mark.parametrize("shape,pad,resample", [
    ("bhw", 1.0, False), ("bnw", 0.5, True), ("rect", 1.0, True)])
def test_subband_transform_matches_jax(shape, pad, resample):
    """Every output of subband_delay_transform against JAX's: windows and
    lags equal, the lag cubes and lag kernel within 1e-6 of max|out|, the
    resampled cubes within 1e-6 of the max of the cube they resample (the
    resampling keeps the band's first and last channels, often outside
    every window, where both packages hold rounding noise)."""
    kw = dict(freq_center=[152e6, 154.5e6], bw_eff=[2e6, 1.5e6],
              shape=shape, pad=pad, resample=resample)
    a = delay_j.subband_delay_transform(
        _vs_random(cls=vis_j.VisibilitySet), **kw)
    b = delay_t.subband_delay_transform(_vs_random(), device="cpu", **kw)
    assert sorted(a) == sorted(b)
    for key in a:
        if np.iscomplexobj(a[key]):
            assert np.shape(b[key]) == np.shape(a[key]), key
            scale = np.abs(a[key.replace("_resampled", "")]).max()
            assert np.abs(b[key] - a[key]).max() / scale < FFT_TOL, key
        else:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)


# -- delay transform repairs -------------------------------------------------

@pytest.mark.parametrize("wshape", ["chan", "bl_chan", "full"])
def test_delay_transform_freq_wts_matches_jax(wshape):
    """vis.delay_transform's freq_wts in each of JAX's three shapes: the
    weights replace bp_wts (equal), the lag cubes within 1e-6 of max|out|."""
    rng = np.random.RandomState(7)
    nbl, nchan, nacc = 3, 32, 2
    shp = {"chan": (nchan,), "bl_chan": (nbl, nchan),
           "full": (nbl, nchan, nacc)}[wshape]
    w = rng.uniform(0.2, 1.0, shp)
    a = vis_j.delay_transform(_vs_random(cls=vis_j.VisibilitySet), pad=1.0,
                              freq_wts=w)
    b = vis_t.delay_transform(_vs_random(), pad=1.0, freq_wts=w,
                              device="cpu")
    np.testing.assert_array_equal(b.bp_wts, a.bp_wts)
    np.testing.assert_array_equal(b.lags, a.lags)
    for name in ("skyvis_lag", "vis_lag", "vis_noise_lag", "lag_kernel"):
        assert _rel(getattr(b, name), getattr(a, name)) < FFT_TOL, name
    with pytest.raises(ValueError):
        vis_t.delay_transform(_vs_random(), freq_wts=np.ones(5),
                              device="cpu")


def test_phase_centering_delay_transform_matches_jax():
    """phase_centering(..., do_delay_transform=True): re-phased cubes equal
    JAX's, lag cubes within 1e-6 of max|out|."""
    pc = np.asarray([[75.0, 10.0]])
    a = vis_j.phase_centering(_vs_random(cls=vis_j.VisibilitySet), pc,
                              "altaz", do_delay_transform=True)
    b = vis_t.phase_centering(_vs_random(), pc, "altaz",
                              do_delay_transform=True, device="cpu")
    np.testing.assert_array_equal(b.skyvis, a.skyvis)
    np.testing.assert_array_equal(b.phase_center, a.phase_center)
    for name in ("skyvis_lag", "vis_lag", "vis_noise_lag"):
        assert _rel(getattr(b, name), getattr(a, name)) < FFT_TOL, name
    c = vis_t.phase_centering(_vs_random(), pc, "altaz", device="cpu")
    assert c.skyvis_lag is None


# -- CLEAN -------------------------------------------------------------------

def test_clean_recovers_single_component():
    n = 64
    kernel = np.zeros(n, dtype=complex)
    kernel[0] = 1.0  # delta kernel, peak at index 0
    true = np.zeros(n, dtype=complex)
    true[20] = 3.0 - 1.0j
    out = clean_t.complex_clean_1d(true, kernel, gain=0.2, maxiter=500,
                                   threshold=1e-4, device="cpu")
    cc = np.asarray(out["cc"])
    res = np.asarray(out["res"])
    np.testing.assert_allclose(cc[20], 3.0 - 1.0j, rtol=1e-3)
    assert np.abs(res).max() < 1e-3 * 3.1
    assert int(out["terminated_by"]) == 0


def test_clean_with_broad_kernel():
    n = 128
    x = np.arange(n)
    kern = np.fft.fftshift(np.sinc((x - n // 2) / 4.0)).astype(complex)
    true_cc = np.zeros(n, dtype=complex)
    true_cc[10] = 2.0
    true_cc[40] = -1.0j
    dirty = np.zeros(n, dtype=complex)
    kmax = np.argmax(np.abs(kern))
    for idx in (10, 40):
        dirty += true_cc[idx] * np.roll(kern, idx - kmax)
    out = clean_t.complex_clean_1d(dirty, kern, gain=0.1, maxiter=2000,
                                   threshold=1e-3, device="cpu")
    cc = np.asarray(out["cc"])
    # clean components concentrate at/near the true locations
    assert np.abs(cc[8:13]).sum() > 1.5
    assert np.abs(cc[38:43]).sum() > 0.7
    assert np.abs(np.asarray(out["res"])).max() < 0.05


def test_batch_clean_shapes():
    n = 32
    rng = np.random.RandomState(1)
    specs = rng.randn(3, 2, n) + 1j * rng.randn(3, 2, n)
    kern = np.zeros(n, dtype=complex)
    kern[0] = 1.0
    out = clean_t.batch_clean(specs, kern, maxiter=50, device="cpu")
    assert out["cc"].shape == (3, 2, n)
    assert out["niter"].shape == (3, 2)


def _clean_batch(seed=3, n=64):
    """(4, 6, n) spectra: sparse components on a weak noise floor, so rows
    stop by threshold, by maxiter and by the box rule at different
    iterations; a per-row sinc kernel with a phase slope; and clean boxes
    whose out-of-box count is 0, 1, 2 or many."""
    rng = np.random.RandomState(seed)
    B = (4, 6)
    x = np.arange(n)
    specs = 0.02 * (rng.randn(*B, n) + 1j * rng.randn(*B, n))
    width = rng.uniform(1.5, 4.0, B)
    # real at its peak, as a lag kernel is, with a phase slope across it
    slope = rng.uniform(-0.3, 0.3, B)[..., None]
    kern = (np.sinc((x[None, None, :] - n // 2) / width[..., None])
            * np.exp(1j * slope * (x[None, None, :] - n // 2)))
    kern = np.roll(kern, -n // 2 + 3, axis=-1)
    for _ in range(3):
        pos = rng.randint(8, n - 8, B)
        amp = rng.uniform(0.5, 3.0, B) * np.exp(1j * rng.uniform(
            0, 2 * np.pi, B))
        # the kernel (peak at index 3) shifted to pos, row by row
        idx = (x[None, None, :] - (pos[..., None] - 3)) % n
        specs += amp[..., None] * np.take_along_axis(kern, idx, axis=-1)
    half = np.asarray([64, 63, 62, 40, 30, 20])[None, :, None]
    box = np.abs(x[None, None, :] - n // 2) <= half // 2
    box = np.broadcast_to(box, specs.shape).copy()
    box[:, 0] = True                        # n_out = 0
    box[:, 1, :1] = False                   # n_out = 1
    box[:, 2, :2] = False                   # n_out = 2
    return specs.astype(np.complex64), kern.astype(np.complex64), box


@pytest.mark.parametrize("boxed,threshold_abs,threshold,maxiter", [
    (False, False, 0.05, 60), (False, True, 0.3, 60),
    (True, False, 0.05, 80), (True, True, 0.3, 80)])
def test_batch_clean_matches_jax(boxed, threshold_abs, threshold, maxiter):
    """Every spectrum of the batch against JAX's vmapped while_loop: niter
    and terminated_by equal, cc / res / inrms / outrms within 1e-5 of
    max|inp|; the batch holds rows that stop at different iterations and
    (boxed) by all three rules, with n_out 0, 1, 2 and > 2."""
    specs, kern, box = _clean_batch()
    kw = dict(gain=0.1, maxiter=maxiter, threshold=threshold,
              threshold_abs=threshold_abs)
    cb = box if boxed else None
    a = clean_j.batch_clean(specs, kern, cb, **kw)
    b = clean_t.batch_clean(specs, kern, cb, device="cpu", **kw)
    np.testing.assert_array_equal(b["niter"], a["niter"])
    np.testing.assert_array_equal(b["terminated_by"], a["terminated_by"])
    scale = np.abs(specs).max()
    for key in ("cc", "res", "inrms", "outrms"):
        want = np.asarray(a[key])
        # an empty out-of-box region reads an infinite MAD in both
        np.testing.assert_array_equal(np.isinf(b[key]), np.isinf(want))
        fin = np.isfinite(want)
        assert np.abs(b[key][fin] - want[fin]).max() / scale \
            < CLEAN_TOL, key
    codes = set(np.unique(a["terminated_by"]).tolist())
    assert len(np.unique(a["niter"])) > 1
    assert 0 in codes and len(codes) > 1 and (2 in codes) == boxed, codes


def test_clean_finished_rows_match_single_runs():
    """A row of the batch ends exactly as the same spectrum CLEANed alone
    (the active mask; extra masked iterations change nothing)."""
    specs, kern, box = _clean_batch(seed=5)
    s, k, b = specs[1], kern[1], box[1]
    full = clean_t.batch_clean(s, k, b, maxiter=80, threshold=0.05,
                               device="cpu")
    for i in range(s.shape[0]):
        one = clean_t.complex_clean_1d(s[i], k[i], b[i], maxiter=80,
                                       threshold=0.05, device="cpu")
        for key, val in one.items():
            np.testing.assert_array_equal(full[key][i], val, err_msg=key)


def test_delay_clean_vs_runs():
    vs = _vs_flat(nbl=2, nchan=32, nacc=2)
    # baselines long enough that the horizon clean box spans several lag
    # bins (a 1-pixel box makes the in/out-rms stop degenerate, matching
    # the reference's behavior)
    vs.baselines = vs.baselines * 50.0
    out = clean_t.delay_clean_vs(vs, pad=0.0, maxiter=200, threshold=1e-3,
                                 device="cpu")
    assert out["cc_skyvis_lag"].shape == (2, 32, 2)
    # flat band: residuals should be small after cleaning the zero-lag peak
    assert (np.abs(out["res_skyvis_lag"]).max()
            < 0.1 * np.abs(out["cc_skyvis_lag"]).max())


def test_delay_clean_vs_matches_jax():
    """delay_clean_vs cleans every cube present, as JAX's does: the same
    keys, niter equal, cc and res within 1e-5 of max|inp|."""
    mk = dict(nbl=4, nchan=32, nacc=3)
    vj = _vs_random(cls=vis_j.VisibilitySet, **mk)
    vt = _vs_random(**mk)
    vj.baselines = vt.baselines = vt.baselines * 20.0
    a = clean_j.delay_clean_vs(vj, pad=1.0, maxiter=60, threshold=1e-2)
    b = clean_t.delay_clean_vs(vt, pad=1.0, maxiter=60, threshold=1e-2,
                               device="cpu")
    assert sorted(a) == sorted(b)
    assert {"cc_vis_noise_lag", "cc_vis_lag", "cc_skyvis_lag"} <= set(b)
    for name in ("skyvis_lag", "vis_lag", "vis_noise_lag"):
        np.testing.assert_array_equal(b["niter_" + name],
                                      a["niter_" + name])
        scale = np.abs(getattr(vis_t.delay_transform(vt, device="cpu"),
                               name)).max()
        for key in ("cc_", "res_"):
            assert np.abs(b[key + name] - a[key + name]).max() / scale \
                < CLEAN_TOL, key + name


# -- power spectrum ----------------------------------------------------------

def test_beam3Dvol_uniform_beam():
    nside = 8
    npix = hp.nside2npix(nside)
    nchan = 4
    freqs = 150e6 + 1e5 * np.arange(nchan)
    vol = ps_t.beam3Dvol(np.ones(npix), freqs, hemisphere=True)
    # hemisphere solid angle 2 pi, x bandwidth
    np.testing.assert_allclose(vol, 2 * np.pi * nchan * 1e5, rtol=1e-6)


def test_delay_power_spectrum_units_and_shapes():
    vs = _vs_flat(nbl=3, nchan=32, nacc=2)
    vst = vis_t.delay_transform(vs, pad=0.0, device="cpu")
    dps = ps_t.delay_power_spectrum(vst, omega_bw=2 * np.pi * 32 * 1e5)
    assert dps["skyvis"].shape == (3, 32, 2)
    assert dps["kprll"].size == 32
    assert dps["kperp"].size == 3
    assert dps["z"] == pytest.approx(
        CNST.rest_freq_HI / vs.freqs[16] - 1, rel=1e-12)
    assert np.all(dps["skyvis"] >= 0)
    # flat 1 Jy spectrum over B: peak dps ~ factor * B^2
    B = 32 * 1e5
    np.testing.assert_allclose(dps["skyvis"].max(),
                               dps["factor"] * B ** 2, rtol=1e-5)


def test_delay_power_spectrum_matches_jax():
    """The copied power_spectrum module on each package's delay transform:
    scalars and axes equal, P(k) cubes within 1e-6 of their max (the
    transforms' complex64 rounding, squared)."""
    a = ps_j.delay_power_spectrum(vis_j.delay_transform(
        _vs_random(cls=vis_j.VisibilitySet)), omega_bw=3.7e5)
    b = ps_t.delay_power_spectrum(vis_t.delay_transform(
        _vs_random(), device="cpu"), omega_bw=3.7e5)
    assert sorted(a) == sorted(b)
    for key in a:
        if key in ("skyvis", "vis", "noise"):
            assert _rel(b[key], a[key]) < 2 * FFT_TOL, key
        else:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def test_subband_power_spectra_shapes():
    vs = _vs_flat(nbl=2, nchan=64, nacc=1)
    sb = delay_t.subband_delay_transform(vs, freq_center=[152e6, 155e6],
                                         bw_eff=2e6, device="cpu")
    nside = 8
    beam = np.ones(hp.nside2npix(nside))
    ps = ps_t.subband_power_spectra(vs, sb, beam)
    assert ps["skyvis"].shape == (2, 2, 128, 1)
    assert ps["kprll"].shape == (2, 128)
    assert ps["kperp"].shape == (2, 2)
    assert np.all(np.isfinite(ps["skyvis"]))


def test_subband_resampled_products():
    vs = _vs_flat(nbl=2, nchan=64, nacc=1)
    out = delay_t.subband_delay_transform(vs, freq_center=[153e6, 155e6],
                                          bw_eff=2e6, pad=1.0, resample=True,
                                          device="cpu")
    assert "lags_resampled" in out
    n_over = out["lags"].size
    n_res = out["lags_resampled"].size
    assert n_res < n_over
    assert out["skyvis_lag_resampled"].shape[2] == n_res
    # oversampling factor consistent: total band / effective bandwidth
    assert out["lag_corr_length"][0] == pytest.approx(
        (64 + 64) * 1e5 / 2e6)


def test_analysis_entry_points_default_to_cuda(monkeypatch):
    """Without a card the device-taking entry points raise instead of
    running on the CPU (the card's absence is forced, so the case runs
    anywhere)."""
    import torch
    from prisim_tpu_torch import tools
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vs = _vs_flat(nbl=2, nchan=16, nacc=1)
    calls = (lambda: clean_t.batch_clean(np.ones((2, 8)), np.ones(8)),
             lambda: clean_t.delay_clean_vs(vs),
             lambda: delay_t.subband_delay_transform(vs, [150.5e6], 5e5),
             lambda: vis_t.delay_transform(vs),
             lambda: vis_t.phase_centering(vs, [[80.0, 0.0]], "altaz",
                                           do_delay_transform=True),
             lambda: tools.delay_ps("no_such_sim.fits", None))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
