"""The port's analysis tools (prisim_tpu_torch.tools: delay_ps, closure_npz,
xcpdps) on the CPU: the cases of tests/test_tools.py that cover them, run
on the port, with each written HDF5 product read back and compared key for
key with what prisim_tpu.tools writes from the same input file.

Tolerances: the closure-phase products are numpy in both packages and
equal; delay_ps's power spectra within 1e-6 of their max (the complex64
transforms, squared; the float32 beam volume), its CLEAN products within
2e-5 of their max (CLEAN's 1e-5 of max|inp|, squared)."""

import os

import numpy as np
import pytest

from prisim_tpu import tools as tools_j
from prisim_tpu.io import save_hdf5 as save_hdf5_j
from prisim_tpu.io.dicth5 import load_dict_hdf5
from prisim_tpu.vis import VisibilitySet as VisibilitySet_j
from prisim_tpu_torch import tools

PS_TOL = 1e-6
CLEAN_PS_TOL = 2e-5


def _vs(tmp_path, redundant=True):
    """Small 4-antenna linear-array sim (redundant baselines), written
    with prisim_tpu's HDF5 writer."""
    from prisim_tpu.layouts import ArrayLayout
    from prisim_tpu.baselines import build_baselines
    pos = np.zeros((4, 3))
    pos[:, 0] = 14.6 * np.arange(4)
    layout = ArrayLayout(pos, np.asarray([str(i) for i in range(4)]))
    bls = build_baselines(layout, redundant=redundant)
    nchan, nacc = 8, 2
    rng = np.random.RandomState(0)
    sv = rng.randn(bls.nbl, nchan, nacc) \
        + 1j * rng.randn(bls.nbl, nchan, nacc)
    vs = VisibilitySet_j(
        baselines=bls.vectors, labels=bls.labels,
        freqs=150e6 + 1e5 * np.arange(nchan),
        lst=np.asarray([10.0, 10.5]), skyvis=sv,
        timestamps=2458000.0 + np.arange(nacc) * 1e-3,
        t_acc=np.full(nacc, 10.0), Tsys=np.full((bls.nbl, nchan, nacc),
                                                180.0),
        latitude=-30.7,
        layout=dict(positions=pos, labels=layout.labels,
                    ids=np.arange(4), coords="ENU"))
    path = str(tmp_path / "sim.hdf5")
    save_hdf5_j(vs, path)
    return vs, path


def _same_products(got, want, tol=None, where="product"):
    """Two product dicts read back from HDF5 hold the same keys; arrays
    are equal, or (for keys in `tol`) within tol[key] of their max."""
    assert sorted(got) == sorted(want), where
    for key in want:
        a, b = got[key], want[key]
        w = "%s[%r]" % (where, key)
        if isinstance(b, dict):
            _same_products(a, b, tol, w)
        elif tol and key in tol:
            b = np.asarray(b)
            assert np.shape(a) == b.shape, w
            assert np.abs(np.asarray(a) - b).max() / np.abs(b).max() \
                < tol[key], w
        else:
            np.testing.assert_array_equal(a, b, err_msg=w)


def test_delay_ps(tmp_path):
    vs, path = _vs(tmp_path)
    out = str(tmp_path / "dps.hdf5")
    dps = tools.delay_ps(path, out, nside_beam=8, clean=True,
                         maxiter=20, device="cpu")
    assert os.path.exists(out)
    # physical sanity: z from mid-band, P(k) cube shapes, finite values
    f0 = vs.freqs[vs.nchan // 2]
    assert abs(dps["z"] - (1420405751.77 / f0 - 1)) < 1e-3
    assert dps["skyvis"].shape == (vs.nbl, vs.nchan, 2)
    assert dps["kprll"].shape == (vs.nchan,)
    assert np.isfinite(dps["skyvis"]).all() and (dps["skyvis"] >= 0).all()
    assert dps["cc_skyvis_ps"].shape == dps["skyvis"].shape
    back = load_dict_hdf5(out)
    np.testing.assert_allclose(back["skyvis"], dps["skyvis"], rtol=1e-6)
    # subband mode
    f = vs.freqs
    dps2 = tools.delay_ps(path, str(tmp_path / "dps2.hdf5"),
                          nside_beam=8,
                          subband_centers=[f[2], f[5]],
                          subband_bw=[3 * vs.freq_resolution],
                          device="cpu")
    sb = dps2["subband"]
    assert sb["skyvis"].shape[:2] == (vs.nbl, 2)
    assert np.isfinite(sb["skyvis"]).all()
    assert sb["z"][0] > sb["z"][1]  # lower freq -> higher z


@pytest.mark.parametrize("mode", ["clean", "subband"])
def test_delay_ps_matches_jax(tmp_path, mode):
    """The port's delay_ps product against JAX's on the same sim file, key
    for key: the power spectra and the quantities of the beam volume
    within 1e-6 of their max, the CLEAN products within 2e-5, everything
    else equal."""
    vs, path = _vs(tmp_path)
    kw = (dict(clean=True, maxiter=20) if mode == "clean" else
          dict(subband_centers=[vs.freqs[2], vs.freqs[5]],
               subband_bw=[3 * vs.freq_resolution]))
    tools_j.delay_ps(path, str(tmp_path / "j.hdf5"), nside_beam=8, **kw)
    timings = {}
    dps = tools.delay_ps(path, str(tmp_path / "t.hdf5"), nside_beam=8,
                         device="cpu", timings=timings, **kw)
    want = load_dict_hdf5(str(tmp_path / "j.hdf5"))
    tol = {k: PS_TOL for k in ("skyvis", "factor", "jacobian1", "omega_bw")}
    tol.update(cc_skyvis_ps=CLEAN_PS_TOL, res_skyvis_ps=CLEAN_PS_TOL)
    _same_products(load_dict_hdf5(str(tmp_path / "t.hdf5")), want, tol)
    assert set(timings) >= {"load", "delay transform", "beam volume",
                            "power spectrum", "save"}
    # outfile=None: the same product, nothing written
    again = tools.delay_ps(path, None, nside_beam=8, device="cpu", **kw)
    assert sorted(again) == sorted(dps)
    np.testing.assert_array_equal(again["skyvis"], dps["skyvis"])


def test_delay_ps_path_without_h5py_raises_before_compute(tmp_path,
                                                          monkeypatch):
    """A product path where h5py is missing raises ImportError before the
    sim is even read."""
    from prisim_tpu_torch.io import hdf5
    monkeypatch.setattr(hdf5, "h5py", None)
    missing = str(tmp_path / "no_such_sim.fits")
    with pytest.raises(ImportError, match="h5py"):
        tools.delay_ps(missing, str(tmp_path / "dps.hdf5"), device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        tools.xcpdps(missing, str(tmp_path / "xc.hdf5"))


def test_closure_npz_matches_jax(tmp_path):
    """closure_npz on the same sim writes the same HERA NPZ as JAX's."""
    _, path = _vs(tmp_path, redundant=False)
    a = tools_j.closure_npz(path, str(tmp_path / "j.npz"))
    b = tools.closure_npz(path, str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(b.cp, a.cp)
    with np.load(str(tmp_path / "j.npz")) as dj, \
            np.load(str(tmp_path / "t.npz")) as dt:
        assert sorted(dj.files) == sorted(dt.files)
        for key in dj.files:
            np.testing.assert_array_equal(dt[key], dj[key], err_msg=key)


def _cpd_npz(tmp_path, seed, nlst, ndays, ntri, nchan):
    from prisim_tpu_torch.analysis.bispectrum import ClosurePhaseData
    rng = np.random.RandomState(seed)
    cpd = ClosurePhaseData(
        cp=rng.uniform(-0.4, 0.4, (nlst, ndays, ntri, nchan)),
        wts=np.ones((nlst, ndays, ntri, nchan)),
        freqs=150e6 + 1e5 * np.arange(nchan),
        lst=np.linspace(1.0, 2.0, nlst),
        days=2458000.0 + np.arange(ndays),
        triads=np.array([["%d" % i, "%d" % (i + 1), "%d" % (i + 2)]
                         for i in range(ntri)]))
    npz = str(tmp_path / ("cp%d.npz" % seed))
    cpd.save_npz(npz)
    return cpd, npz


def test_xcpdps(tmp_path):
    from prisim_tpu_torch.analysis.bispectrum import (ClosurePhaseData,
                                                      read_xcpdps)
    nlst, ndays, ntri, nchan = 6, 4, 5, 32
    cpd, npz = _cpd_npz(tmp_path, 1, nlst, ndays, ntri, nchan)
    out = str(tmp_path / "xc.hdf5")
    ps = tools.xcpdps(npz, out, ndaybins=2, num_kbins=5)
    assert ps["mode"] == "cross"
    assert ps["P"].shape == (1, nlst, ntri, 2 * nchan)
    assert np.isfinite(ps["P"]).all()
    assert ps["P_kbin"].shape == (1, nlst, ntri, 5)
    back = read_xcpdps(out)
    np.testing.assert_allclose(np.asarray(back["P"]), ps["P"], rtol=1e-6)
    # single day -> auto spectrum fallback
    cpd1 = ClosurePhaseData(cp=cpd.cp[:, :1], wts=cpd.wts[:, :1],
                            freqs=cpd.freqs, lst=cpd.lst,
                            days=cpd.days[:1], triads=cpd.triads)
    npz1 = str(tmp_path / "cp1.npz")
    cpd1.save_npz(npz1)
    ps1 = tools.xcpdps(npz1, str(tmp_path / "xc1.hdf5"))
    assert ps1["mode"] == "auto"
    # auto spectrum of e^{i cp} is real and positive at lag 0 dominance
    assert np.isfinite(ps1["P"]).all()


def test_xcpdps_errinfo_and_rescale(tmp_path):
    from prisim_tpu_torch.analysis.bispectrum import (
        ClosurePhaseData, power_spectrum_uncertainty,
        rescale_power_spectrum, average_rescaled_power_spectrum)
    rng = np.random.RandomState(2)
    nlst, ndays, ntri, nchan = 3, 4, 2, 16
    base = rng.uniform(-0.3, 0.3, (nlst, 1, ntri, nchan))
    # identical days -> subsample differences vanish -> P_err == 0
    cpd = ClosurePhaseData(
        cp=np.broadcast_to(base, (nlst, ndays, ntri, nchan)).copy(),
        wts=np.ones((nlst, ndays, ntri, nchan)),
        freqs=150e6 + 1e5 * np.arange(nchan),
        lst=np.linspace(1.0, 2.0, nlst),
        days=2458000.0 + np.arange(ndays),
        triads=np.array([["0", "1", "2"], ["1", "2", "3"]]))
    err = power_spectrum_uncertainty(
        cpd, [cpd.freqs[nchan // 2]], [4e5], ndaybins=2)
    np.testing.assert_allclose(err["P_err"], 0.0, atol=1e-20)
    # noisy days -> nonzero uncertainty
    cpd2 = cpd
    cpd2.cp = cpd.cp + rng.normal(0, 0.1, cpd.cp.shape)
    err2 = power_spectrum_uncertainty(
        cpd2, [cpd.freqs[nchan // 2]], [4e5], ndaybins=2)
    assert np.abs(err2["P_err"]).max() > 0
    # rescaling: constant |V|=2 on all 3 baselines -> mult = 4/3
    ps = dict(P=np.ones((1, nlst, ntri, 8)), lst=cpd.lst,
              kprll=np.linspace(-1, 1, 8)[None])
    fw = np.ones((1, nchan))
    vt = np.full((nlst, 3, nchan), 2.0 + 0.0j)
    out = rescale_power_spectrum(ps, fw, vt, cpd.lst)
    np.testing.assert_allclose(out["absscale_mult"], 4.0 / 3.0)
    np.testing.assert_allclose(out["P_absscale"], 4.0 / 3.0)
    # averaging with inverse-variance weights preserves a constant
    avg = average_rescaled_power_spectrum(out["P_absscale"], ps["kprll"],
                                          avgax=(1, 2), kprll_llim=0.2)
    assert avg.shape == (1, 1, 1, 8)
    np.testing.assert_allclose(avg, 4.0 / 3.0)


def test_xcpdps_full_cli(tmp_path):
    """cohax/incohax/collapse_axes route through xcpdps_full and the
    result round-trips through the HDF5 writer."""
    from prisim_tpu_torch.analysis.bispectrum import read_xcpdps
    nlst, ndays, ntri, nchan = 5, 4, 4, 32
    _, npz = _cpd_npz(tmp_path, 2, nlst, ndays, ntri, nchan)
    out = str(tmp_path / "xcf.hdf5")
    ps = tools.xcpdps(npz, out, ndaybins=2, cohax=[2], incohax=[1, 3],
                      collapse_axes=[3], lst_shifts=[0, 1])
    assert ps["mode"] == "xcpdps_full"
    # (nwin, nshift, nlst, ndaybins->1, 2*ntri-1, nlag)
    assert ps["P"].shape == (1, 2, nlst, 1, 2 * ntri - 1, 2 * nchan)
    back = read_xcpdps(out)
    np.testing.assert_allclose(np.asarray(back["P"]), ps["P"],
                               rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(back["diagoffsets"]["3"]),
        np.arange(-(ntri - 1), ntri))


@pytest.mark.parametrize("case", ["cross_kbins", "auto", "errinfo_rescale",
                                  "full"])
def test_xcpdps_matches_jax(tmp_path, case):
    """The port's xcpdps product against JAX's on the same closure NPZ,
    key for key and equal (numpy in both packages); with outfile=None the
    same dict is returned and nothing is written."""
    if case == "auto":
        _, npz = _cpd_npz(tmp_path, 3, 4, 1, 3, 16)
        kw = {}
    elif case == "full":
        _, npz = _cpd_npz(tmp_path, 4, 5, 4, 4, 32)
        kw = dict(ndaybins=2, cohax=[2], incohax=[1, 3], collapse_axes=[3],
                  lst_shifts=[0, 1])
    else:
        _, npz = _cpd_npz(tmp_path, 5, 6, 4, 5, 32)
        kw = dict(ndaybins=2, num_kbins=5)
        if case == "errinfo_rescale":
            # the sim's 8 channels and antennas 0-3 for the triads
            _, npz = _cpd_npz(tmp_path, 6, 3, 4, 2, 8)
            _, sim = _vs(tmp_path, redundant=False)
            kw = dict(ndaybins=2, errinfo=True, rescale_vis=sim)
    tools_j.xcpdps(npz, str(tmp_path / "j.hdf5"), **kw)
    got = tools.xcpdps(npz, str(tmp_path / "t.hdf5"), **kw)
    _same_products(load_dict_hdf5(str(tmp_path / "t.hdf5")),
                   load_dict_hdf5(str(tmp_path / "j.hdf5")))
    again = tools.xcpdps(npz, None, **kw)
    assert sorted(again) == sorted(got)
    np.testing.assert_array_equal(again["P"], got["P"])
