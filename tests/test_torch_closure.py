"""Closure phase + bispectrum phase pipeline tests, the cases of
tests/test_closure.py run on the port's copies (prisim_tpu_torch.analysis
closure and bispectrum, vis.conjugate); their outputs against the JAX
package's are in tests/test_torch_hostcopies.py.

Physics anchors: (1) the closure phase of a single point source is
identically zero on every triad (phase closes); (2) antenna-based gains
cancel in the closure phase."""

import numpy as np
import pytest

from prisim_tpu_torch.vis import VisibilitySet
from prisim_tpu_torch.analysis.closure import (all_triads, unique_triads,
                                         triad_baseline_indices,
                                         closure_phases_vs, delay_filter)
from prisim_tpu_torch.analysis.bispectrum import (ClosurePhaseData,
                                            closure_npz_from_vs,
                                            load_closure_npz, cpds_ft,
                                            cross_power_spectrum,
                                            kbin_average)
from prisim_tpu_torch import constants as CNST


def _point_source_vs(nant=5, nchan=16, nacc=2, seed=0):
    """Analytic single-point-source visibilities on an all-pairs array."""
    rng = np.random.RandomState(seed)
    pos = rng.randn(nant, 3) * 40.0
    pos[:, 2] = 0.0
    labels = np.asarray([str(i) for i in range(nant)])
    from prisim_tpu_torch.baselines import baseline_generator
    vecs, pairs = baseline_generator(pos, labels=labels)
    freqs = 150e6 + 1e5 * np.arange(nchan)
    s = np.asarray([0.3, 0.2, np.sqrt(1 - 0.09 - 0.04)])
    tau = vecs @ s / CNST.c                       # (nbl,)
    vis = 7.5 * np.exp(-2j * np.pi * freqs[None, :, None]
                       * tau[:, None, None])
    vis = np.broadcast_to(vis, (vecs.shape[0], nchan, nacc)).copy()
    return VisibilitySet(
        baselines=vecs, labels=pairs, freqs=freqs,
        lst=10.0 + 0.25 * np.arange(nacc),
        skyvis=vis, timestamps=2458000.0 + np.arange(nacc) / 86400.0,
        t_acc=np.full(nacc, 10.0), latitude=-30.7,
        layout=dict(positions=pos, labels=labels, ids=np.arange(nant),
                    coords="ENU"))


def test_triad_counts():
    labels = [str(i) for i in range(6)]
    tri = all_triads(labels)
    assert len(tri) == 20  # C(6,3)


def test_unique_triads_redundant_array():
    # 1-D regular array: many triads share baseline-vector sets
    pos = np.zeros((5, 3))
    pos[:, 0] = 14.6 * np.arange(5)
    labels = np.asarray([str(i) for i in range(5)])
    uniq = unique_triads(labels, pos)
    alln = all_triads(labels)
    assert len(uniq) < len(alln)
    # triads (0,1,2) and (1,2,3) are redundant -> only one kept
    sets = [tuple(t) for t in uniq]
    assert (("0", "1", "2") in sets) and (("1", "2", "3") not in sets)


def test_point_source_closure_phase_is_zero():
    vs = _point_source_vs()
    out = closure_phases_vs(vs, unique=False)
    cp = out["closure_phase_skyvis"]
    assert cp.shape[0] == 10  # C(5,3)
    np.testing.assert_allclose(cp, 0.0, atol=1e-8)


def test_gains_cancel_in_closure_phase():
    vs = _point_source_vs()
    # corrupt with per-antenna complex gains g_a2 conj(g_a1)
    rng = np.random.RandomState(3)
    nant = 5
    g = np.exp(1j * rng.uniform(-np.pi, np.pi, nant))
    labels = np.asarray(vs.labels, dtype=str)
    ga2 = g[labels[:, 0].astype(int)]
    ga1 = g[labels[:, 1].astype(int)]
    vs.skyvis = vs.skyvis * (ga2 * np.conj(ga1))[:, None, None]
    out = closure_phases_vs(vs, unique=False)
    np.testing.assert_allclose(out["closure_phase_skyvis"], 0.0,
                               atol=1e-7)


def test_conjugation_handling():
    vs = _point_source_vs()
    # flip half of the baselines: closure phases must still close
    from prisim_tpu_torch.vis import conjugate
    vs2 = conjugate(vs, list(range(0, vs.nbl, 2)))
    out = closure_phases_vs(vs2, unique=False)
    np.testing.assert_allclose(out["closure_phase_skyvis"], 0.0,
                               atol=1e-7)


def test_delay_filter_discard_removes_low_delays():
    nchan = 64
    df = 1e5
    cube = np.ones((1, nchan, 1), dtype=complex)   # zero-delay signal
    out = delay_filter(cube, df, delay_max=2.0 / (nchan * df),
                       mode="discard")
    assert np.abs(out).max() < 1e-10
    out2 = delay_filter(cube, df, delay_max=2.0 / (nchan * df),
                        mode="retain")
    np.testing.assert_allclose(out2, cube, atol=1e-10)


def test_closure_npz_roundtrip(tmp_path):
    vs = _point_source_vs()
    path = str(tmp_path / "cp.npz")
    cpd = closure_npz_from_vs(vs, path=path, datatype="skyvis")
    back = load_closure_npz(path)
    # random positions -> no redundancy -> all C(5,3)=10 triads unique
    assert back.cp.shape == cpd.cp.shape == (2, 1, 10, 16)
    np.testing.assert_allclose(back.cp, cpd.cp)
    np.testing.assert_allclose(back.freqs, vs.freqs)


def test_closure_hdf5_roundtrip(tmp_path):
    vs = _point_source_vs()
    cpd = closure_npz_from_vs(vs, datatype="skyvis")
    path = str(tmp_path / "cp.hdf5")
    cpd.save_hdf5(path)
    back = ClosurePhaseData.load_hdf5(path)
    np.testing.assert_allclose(back.cp, cpd.cp)
    assert back.triads.shape == cpd.triads.shape


def _random_cpd(nlst=6, ndays=4, ntri=3, nchan=32, seed=0):
    rng = np.random.RandomState(seed)
    cp = rng.uniform(-np.pi, np.pi, (nlst, ndays, ntri, nchan))
    return ClosurePhaseData(
        cp=cp, wts=np.ones_like(cp),
        freqs=150e6 + 1e5 * np.arange(nchan),
        lst=np.linspace(2.0, 2.5, nlst),
        days=2458000.0 + np.arange(ndays),
        triads=np.asarray([["0", "1", "2"]] * ntri))


def test_lst_binning_reduces_axis():
    cpd = _random_cpd()
    out = cpd.smooth_in_tbins(lstbinsize=0.25)
    assert out.cp.shape[0] < cpd.cp.shape[0]
    assert out.cp.shape[1:] == cpd.cp.shape[1:]
    # binned weights conserve total weight
    np.testing.assert_allclose(out.wts.sum(), cpd.wts.sum())


def test_subtract_zeroes_self():
    cpd = _random_cpd()
    out = cpd.subtract(cpd.cp)
    np.testing.assert_allclose(out.cp, 0.0)


def test_subsample_differencing_shapes():
    cpd = _random_cpd(ndays=4)
    out = cpd.subsample_differencing(ndaybins=4)
    assert out["eicp_mean"].shape == (4, 6, 3, 32)
    assert out["eicp_diff"].shape == (6, 6, 3, 32)  # C(4,2) pairs
    # identical data in all days -> diffs are zero
    cpd2 = _random_cpd()
    cpd2.cp[:] = cpd2.cp[:, :1]
    out2 = cpd2.subsample_differencing(ndaybins=2)
    np.testing.assert_allclose(np.abs(out2["eicp_diff"]), 0.0, atol=1e-12)


def test_cpds_ft_and_cross_ps():
    cpd = _random_cpd()
    ft = cpds_ft(cpd.eicp, cpd.wts, cpd.freqs, freq_center=[152e6],
                 bw_eff=2e6, pad=1.0)
    assert ft["dspec"].shape == (1, 6, 4, 3, 64)
    ps = cross_power_spectrum(ft, ft)
    assert ps["P"].shape == ft["dspec"].shape
    # self-cross PS is real non-negative
    assert np.all(ps["P"].real >= -1e-12)
    np.testing.assert_allclose(ps["P"].imag, 0.0, atol=1e-10)
    kb = kbin_average(ps["kprll"], ps["P"], num_kbins=8)
    assert kb["P_kbin"].shape == (1, 6, 4, 3, 8)
    assert np.isfinite(kb["kbin_centers"]).all()


def test_cross_power_diagonal_noise_suppression():
    # pure-noise closure phases: offset-0 diagonal carries the noise
    # power, offset-1 cross-products average toward zero
    cpd = _random_cpd(nlst=24, ndays=1, ntri=2, nchan=32, seed=5)
    from prisim_tpu_torch.analysis.bispectrum import (cpds_ft,
                                                cross_power_diagonal)
    ft = cpds_ft(cpd.eicp, cpd.wts, cpd.freqs, freq_center=[152e6],
                 bw_eff=2e6)
    res = cross_power_diagonal(ft, cpd.lst, axis=1, offsets=(0, 1, 2))
    assert res["P"].shape[0] == 3
    p0 = np.abs(res["P"][0].real).mean()
    p1 = np.abs(res["P"][1].real).mean()
    assert p1 < 0.6 * p0
    assert res["nsamples"].tolist() == [24, 23, 22]
    assert res["axis_offsets"][1] == pytest.approx(
        cpd.lst[1] - cpd.lst[0])


def test_incoherent_average_and_xcpdps_io(tmp_path):
    from prisim_tpu_torch.analysis.bispectrum import (incoherent_average,
                                                save_xcpdps, read_xcpdps)
    rng = np.random.RandomState(0)
    ps_list = [rng.randn(4, 8) for _ in range(5)]
    ps_list[0][0, 0] = np.nan
    avg = incoherent_average(ps_list, weights=[1, 2, 3, 4, 5])
    manual = np.nansum([w * p for w, p in zip([1, 2, 3, 4, 5], ps_list)],
                       axis=0)
    wsum = np.sum([[w] for w in [1, 2, 3, 4, 5]])
    assert np.isfinite(avg).all()
    np.testing.assert_allclose(avg[1, 1], manual[1, 1] / 15.0)
    # xcpdps round trip
    ps = {"triads": np.asarray([["0", "1", "2"]]),
          "lst": np.arange(3.0), "meta": {"z": 8.5, "note": "x"},
          "P": avg}
    path = str(tmp_path / "xcpdps.hdf5")
    save_xcpdps(ps, path)
    back = read_xcpdps(path)
    np.testing.assert_allclose(back["P"], avg)
    assert back["meta"]["z"] == 8.5
    assert back["meta"]["note"] == "x"
    assert list(back["triads"][0]) == ["0", "1", "2"]


def test_closure_from_redundant_sim():
    """Closure phases from a unique-baseline (redundant) sim via the
    vector-matching fallback must close for a point source."""
    from prisim_tpu_torch.layouts import ArrayLayout
    from prisim_tpu_torch.baselines import build_baselines
    pos = np.zeros((4, 3))
    pos[:, 0] = 14.6 * np.arange(4)
    labels = np.asarray(["0", "1", "2", "3"])
    bset = build_baselines(ArrayLayout(pos, labels), redundant=True)
    freqs = 150e6 + 1e5 * np.arange(8)
    s = np.asarray([0.2, 0.1, np.sqrt(1 - 0.05)])
    tau = bset.vectors @ s / CNST.c
    vis = 3.0 * np.exp(-2j * np.pi * freqs[None, :, None]
                       * tau[:, None, None]) * np.ones((1, 1, 1))
    vs = VisibilitySet(
        baselines=bset.vectors, labels=bset.labels, freqs=freqs,
        lst=np.asarray([10.0]), skyvis=vis, latitude=-30.7,
        layout=dict(positions=pos, labels=labels, ids=np.arange(4),
                    coords="ENU"))
    out = closure_phases_vs(vs, unique=False)
    np.testing.assert_allclose(out["closure_phase_skyvis"], 0.0,
                               atol=1e-8)


def test_lst_binning_median_stat():
    """median statistic: robust to a single outlier sample in a bin."""
    cpd = _random_cpd()
    # poison one LST sample with a huge phase; median binning of e^{icp}
    # across the bin should stay bounded while the mean shifts
    cpd_bad = cpd
    cpd_bad.cp = cpd.cp.copy()
    cpd_bad.cp[0] += np.pi * 0.9
    med = cpd_bad.smooth_in_tbins(lstbinsize=10.0, stat="median")
    mean = cpd_bad.smooth_in_tbins(lstbinsize=10.0, stat="mean")
    assert med.cp.shape[0] == 1 and mean.cp.shape[0] == 1
    ref = cpd.smooth_in_tbins(lstbinsize=10.0, stat="median")
    # median closer to the uncorrupted estimate than the mean
    dmed = np.abs(np.angle(np.exp(1j * (med.cp - ref.cp)))).mean()
    dmean = np.abs(np.angle(np.exp(1j * (mean.cp - ref.cp)))).mean()
    assert dmed <= dmean


def test_xcpdps_full_shapes_and_consistency():
    """Full cohax/incohax machinery (xcpdps_full): shape contracts of
    the reference's compute_power_spectrum docstring examples
    (bispectrum_phase.py:3192-3249), and the no-cross case reduces to
    |dspec|^2 * factor (cross_power_spectrum of ft with itself)."""
    from prisim_tpu_torch.analysis.bispectrum import (cpds_ft, xcpdps_full,
                                                cross_power_spectrum)
    cpd = _random_cpd(nlst=6, ndays=4, ntri=3, nchan=32)
    ft = cpds_ft(cpd.eicp, cpd.wts, cpd.freqs, freq_center=[152e6],
                 bw_eff=2e6, pad=1.0)
    nlag = ft["dspec"].shape[-1]

    # example (1): coherent over days only
    r = xcpdps_full(ft, cohax=(2,))
    assert r["P"].shape == (1, 6, 1, 3, nlag)
    ps = cross_power_spectrum(ft, ft)
    r0 = xcpdps_full(ft)
    np.testing.assert_allclose(r0["P"], ps["P"].real, rtol=1e-10)

    # example (2): incoherent cross over lst+triads, full covariance
    r2 = xcpdps_full(ft, cohax=(2,), incohax=(1, 3))
    assert r2["P"].shape == (1, 2, 6, 1, 3, 3, nlag)
    assert r2["axesmap"][1] == [1, 2]
    assert r2["axesmap"][3] == [4, 5]
    assert r2["nsamples_incoh"] == 18 * 17

    # example (3): collapse the triad covariance onto diagonals
    r3 = xcpdps_full(ft, cohax=(2,), incohax=(1, 3), collapse_axes=(3,),
                     lst_shifts=np.arange(3))
    assert r3["P"].shape == (1, 3, 6, 1, 2 * 3 - 1, nlag)
    np.testing.assert_array_equal(r3["diagoffsets"][3],
                                  np.arange(-2, 3))

    # example (4): collapse both lst and triads
    r4 = xcpdps_full(ft, incohax=(1, 3), collapse_axes=(1, 3),
                     lst_shifts=np.arange(4))
    assert r4["P"].shape == (1, 4, 4, 2 * 3 - 1, nlag)

    # avgcov collapses the diagonal axes to singletons
    r5 = xcpdps_full(ft, incohax=(1, 3), collapse_axes=(3,),
                     avgcov=True)
    assert r5["P"].shape == (1, 2, 6, 4, 1, nlag)
    assert 3 not in r5["diagoffsets"]


def test_xcpdps_full_diagonal_matches_cross_power_diagonal():
    """The triad-axis offset-0 diagonal of the full covariance collapse
    equals the direct per-offset cross products."""
    from prisim_tpu_torch.analysis.bispectrum import (cpds_ft, xcpdps_full,
                                                cross_power_diagonal)
    cpd = _random_cpd(nlst=3, ndays=1, ntri=4, nchan=32, seed=3)
    ft = cpds_ft(cpd.eicp, cpd.wts, cpd.freqs, freq_center=[152e6],
                 bw_eff=2e6)
    r = xcpdps_full(ft, incohax=(3,), collapse_axes=(3,))
    ref = cross_power_diagonal(ft, np.arange(4), axis=3, offsets=(0, 1))
    ntri = 4
    off0 = np.where(r["diagoffsets"][3] == 0)[0][0]
    np.testing.assert_allclose(
        np.take(r["P"], off0, axis=r["axesmap"][3][0]),
        ref["P"][0], rtol=1e-8)
    # convention: the trace's offset o holds mean_i d[i+o] conj(d[i]),
    # so cross_power_diagonal's offset +1 (d[i] conj(d[i+1])) is the
    # trace's offset -1 diagonal
    offm1 = np.where(r["diagoffsets"][3] == -1)[0][0]
    np.testing.assert_allclose(
        np.take(r["P"], offm1, axis=r["axesmap"][3][0]),
        ref["P"][1], rtol=1e-8)


def test_day_binning():
    """smooth_in_tbins(daybinsize=...) bins contiguous JD ranges along
    the day axis (bispectrum_phase.py:1751-1855): identical data in all
    days binned down to one bin reproduces the per-day closure phases,
    and weights are conserved."""
    cpd = _random_cpd(ndays=4)
    out = cpd.smooth_in_tbins(daybinsize=10.0)     # one bin spans all
    assert out.cp.shape[1] == 1
    np.testing.assert_allclose(out.wts.sum(), cpd.wts.sum())
    cpd2 = _random_cpd()
    cpd2.cp[:] = cpd2.cp[:, :1]
    out2 = cpd2.smooth_in_tbins(daybinsize=10.0)
    np.testing.assert_allclose(
        np.angle(np.exp(1j * (out2.cp - cpd2.cp[:, :1]))), 0.0,
        atol=1e-10)
    # two bins of two days each
    out3 = cpd.smooth_in_tbins(daybinsize=2.0)
    assert out3.cp.shape[1] == 2
    # median stat runs and keeps shapes
    out4 = cpd.smooth_in_tbins(daybinsize=2.0, stat="median")
    assert out4.cp.shape == out3.cp.shape
    # combined lst + day binning
    out5 = cpd.smooth_in_tbins(lstbinsize=0.25, daybinsize=2.0)
    assert out5.cp.shape[0] < cpd.cp.shape[0] and out5.cp.shape[1] == 2


def test_xcpdps_full_lazy_collapse_matches_standard(monkeypatch):
    """The lazy (factor-side) covariance collapse used at 512-antenna
    scale produces the same P / diagoffsets / diagweights / axesmap as
    the materialized (N, N) block + _array_trace path, across axis
    combinations, weights, and avgcov."""
    from prisim_tpu_torch.analysis import bispectrum as bsp
    cpd = _random_cpd(nlst=5, ndays=3, ntri=7, nchan=32, seed=7)
    ft = bsp.cpds_ft(cpd.eicp, cpd.wts, cpd.freqs, freq_center=[152e6],
                     bw_eff=2e6)
    ntri = 7
    cases = [
        dict(incohax=(3,), collapse_axes=(3,)),
        dict(incohax=(1, 3), collapse_axes=(3,),
             lst_shifts=np.arange(3)),
        dict(incohax=(1, 3), collapse_axes=(1, 3)),
        dict(cohax=(2,), incohax=(1, 3), collapse_axes=(3, 1)),
        dict(incohax=(2, 3), collapse_axes=(2, 3)),
        dict(incohax=(3,), collapse_axes=(3,), avgcov=True),
        dict(incohax=(3,), collapse_axes=(3,),
             preX={3: np.linspace(0.5, 1.5, ntri)},
             postX={3: np.linspace(1.0, 2.0, 2 * ntri - 1)},
             preXnorm=True, postXnorm=True),
    ]
    for kw in cases:
        monkeypatch.setattr(bsp, "_LAZY_COLLAPSE_BYTES", 1e30)
        ref = bsp.xcpdps_full(ft, **kw)
        monkeypatch.setattr(bsp, "_LAZY_COLLAPSE_BYTES", 0.0)
        out = bsp.xcpdps_full(ft, **kw)
        assert out["P"].shape == ref["P"].shape, kw
        np.testing.assert_allclose(out["P"], ref["P"], rtol=1e-10,
                                   atol=1e-12, err_msg=str(kw))
        for ax in ref["diagoffsets"]:
            np.testing.assert_array_equal(out["diagoffsets"][ax],
                                          ref["diagoffsets"][ax])
            np.testing.assert_array_equal(out["diagweights"][ax],
                                          ref["diagweights"][ax])
        assert out["axesmap"] == ref["axesmap"], kw
    # median stat must never take the lazy path (means don't commute)
    monkeypatch.setattr(bsp, "_LAZY_COLLAPSE_BYTES", 0.0)
    med = bsp.xcpdps_full(ft, incohax=(3,), collapse_axes=(3,),
                          stat="median")
    monkeypatch.setattr(bsp, "_LAZY_COLLAPSE_BYTES", 1e30)
    med_ref = bsp.xcpdps_full(ft, incohax=(3,), collapse_axes=(3,),
                              stat="median")
    np.testing.assert_allclose(med["P"], med_ref["P"], rtol=1e-10)
