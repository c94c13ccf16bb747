"""The port's copies of the JAX package's numpy host modules (healpix,
layouts, baselines, ephemeris, skymodel, gains, the catalog helpers and
readers, geometry.spherematch_host, the window helpers,
vis.conjugate/concatenate, aperture_synthesis, the numpy pieces of
engine/nufft_delay and the analysis modules cosmology, closure,
power_spectrum and bispectrum) give the reference's results: each case
runs one function of both packages on the same seeded numpy inputs and
expects equal outputs, field for field (the classes differ, the contents
may not). engine/noise.tsys_model, torch in the port, is held to float64
rounding."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from prisim_tpu import aperture_synthesis as ap_j
from prisim_tpu import baselines as bl_j
from prisim_tpu import catalogs as cat_j
from prisim_tpu import ephemeris as eph_j
from prisim_tpu import gains as gn_j
from prisim_tpu import geometry as geom_j
from prisim_tpu import healpix as hp_j
from prisim_tpu import layouts as lay_j
from prisim_tpu import skymodel as sm_j
from prisim_tpu import vis as vis_j
from prisim_tpu import windows as win_j
from prisim_tpu.analysis import bispectrum as bsp_j
from prisim_tpu.analysis import closure as cl_j
from prisim_tpu.analysis import cosmology as cos_j
from prisim_tpu.analysis import power_spectrum as ps_j
from prisim_tpu.engine import noise as noise_j
from prisim_tpu.engine import nufft_delay as nd_j
from prisim_tpu_torch import aperture_synthesis as ap_t
from prisim_tpu_torch import baselines as bl_t
from prisim_tpu_torch import catalogs as cat_t
from prisim_tpu_torch import ephemeris as eph_t
from prisim_tpu_torch import gains as gn_t
from prisim_tpu_torch import geometry as geom_t
from prisim_tpu_torch import healpix as hp_t
from prisim_tpu_torch import layouts as lay_t
from prisim_tpu_torch import skymodel as sm_t
from prisim_tpu_torch import vis as vis_t
from prisim_tpu_torch import windows as win_t
from prisim_tpu_torch.analysis import bispectrum as bsp_t
from prisim_tpu_torch.analysis import closure as cl_t
from prisim_tpu_torch.analysis import cosmology as cos_t
from prisim_tpu_torch.analysis import power_spectrum as ps_t
from prisim_tpu_torch.engine import noise as noise_t
from prisim_tpu_torch.engine import nufft_delay as nd_t


def assert_same(a, b, where="result"):
    """Equal values, recursing through dataclasses, dicts and sequences;
    a dataclass of either package matches its counterpart by name."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        "%s.%s" % (where, f.name))
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], "%s[%r]" % (where, k))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, "%s[%d]" % (where, i))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _angles(rng, n=500):
    return (np.arccos(rng.uniform(-1, 1, n)), rng.uniform(0, 2 * np.pi, n))


def _healpix(hp, rng):
    theta, phi = _angles(rng)
    pix = rng.integers(0, hp.nside2npix(16), 300)
    m = rng.standard_normal(hp.nside2npix(8))
    return (hp.ang2pix(16, theta, phi), hp.ang2pix(16, theta, phi, nest=True),
            hp.pix2ang(16, pix), hp.pix2ang(16, pix, nest=True),
            hp.pix2vec(16, pix), hp.ring2nest(16, pix),
            hp.get_interp_weights(8, theta, phi), hp.interp_map(m, theta, phi),
            hp.ud_grade(m, 4), hp.nside2pixarea(32))


def _layouts(lay, rng):
    return (lay.preset_layout("HERA-37"),
            lay.hexagon_generator(14.6, n_side=4),
            lay.rectangle_generator(10.0, 3),
            lay.circular_antenna_array(14.0, 30.0, 60.0, seed=3),
            lay.preset_layout("HERA-19").perturbed(0.02, 0.01, seed=5))


def _baselines(lay_bl, rng):
    lay, bl = lay_bl
    layout = lay.preset_layout("HERA-19").perturbed(1e-3, 0.0, seed=int(
        rng.integers(1 << 30)))
    red = bl.build_baselines(lay.preset_layout("HERA-19"), redundant=True)
    return (bl.build_baselines(layout, redundant=False),
            bl.build_baselines(lay.preset_layout("HERA-37"), min_length=20.0,
                               max_length=60.0, direction_deg=[0.0, 60.0]),
            red, bl.baselines_in_group(red, 3))


def _ephemeris(eph, rng):
    jd = 2458000.5 + rng.uniform(0, 400, 50)
    ra, dec = rng.uniform(0, 360, 50), rng.uniform(-80, 80, 50)
    return (eph.lst_deg(jd, 21.4283), eph.gmst_deg(jd),
            eph.julian_date(2019, 3, 14, 6, 30, 12.5),
            eph.precession_matrix(2451545.0, jd[0]),
            eph.precess_radec(ra, dec, 2451545.0, jd[0]))


def _skymodel(sm, rng):
    freqs = 150e6 + 1e6 * np.arange(8)
    temp = 100.0 + rng.uniform(0, 10, 12 * 8 * 8)
    usm = sm.healpix_diffuse_model(temp, 150e6)
    rnd = sm.random_point_source_model(200, flux_min=0.5, flux_max=20.0,
                                       spindex_rms=0.1, seed=11)
    return (usm, rnd, usm.generate_spectrum(freqs),
            rnd.generate_spectrum(freqs),
            sm.healpix_diffuse_model(np.stack([temp, 0.9 * temp], -1),
                                     [140e6, 160e6]).generate_spectrum(freqs),
            sm.tanh_eor_spectrum(freqs, 1.0, 152e6, 4e6, 0.1))


def _gains(gn, rng):
    nant, nf, nt = 7, 6, 4
    g = (rng.standard_normal((nant, nf, nt))
         + 1j * rng.standard_normal((nant, nf, nt)))
    tab = gn.GainTable(g, label=np.asarray([str(i) for i in range(nant)]),
                       frequency=150e6 + 1e6 * np.arange(nf),
                       time=np.arange(nt) * 60.0)
    info = gn.GainInfo(antenna_based=tab)
    labels = np.asarray([("3", "0"), ("5", "2"), ("6", "1")])
    freqs = 150.5e6 + 1e6 * np.arange(4)
    times = np.asarray([30.0, 90.0])
    return tuple(info.eval_gains(labels, freqs=freqs, times=times, kind=k)
                 for k in ("linear", "cubic", "nearest", "spline"))


def _catalogs(cat_sm, rng):
    cat, sm = cat_sm
    model = cat._powerlaw_model(rng.uniform(0, 360, 40),
                                rng.uniform(-80, 20, 40),
                                rng.uniform(0.1, 10, 40), 150e6,
                                cat._draw_spindex(40, -0.8, 0.1, seed=2))
    return (model, cat.flux_cut(model, flux_min=1.0, flux_max=8.0,
                                cut_freq=120e6),
            cat.flux_cut(sm.random_point_source_model(100, seed=4),
                         flux_min=5.0))


def _custom_ascii(cat, rng, tmpdir):
    """read_custom_ascii on 3-, 4- and 7-column catalogs (RA DEC FLUX
    [SPINDEX] [MAJ MIN PA]), one of a single row."""
    out = []
    for ncol, nrow in ((3, 12), (4, 9), (7, 6), (7, 1)):
        data = np.column_stack([rng.uniform(0, 360, nrow),
                                rng.uniform(-80, 20, nrow),
                                rng.uniform(0.1, 10, nrow),
                                rng.uniform(-1.2, -0.4, nrow),
                                rng.uniform(0.01, 0.1, (nrow, 2)),
                                rng.uniform(0, 180, nrow)])[:, :ncol]
        path = os.path.join(tmpdir, "custom_%d_%d.txt" % (ncol, nrow))
        np.savetxt(path, data, header="RA DEC FLUX")
        out.append(cat.read_custom_ascii(path))
        out.append(cat.read_custom_ascii(path, freq_ref=120e6,
                                         spindex_default=-0.7))
    return out


def _spherematch(geom, rng):
    lon1, lat1 = rng.uniform(0, 360, 20), rng.uniform(-90, 90, 20)
    lon2, lat2 = rng.uniform(0, 360, 300), rng.uniform(-90, 90, 300)
    return (geom.spherematch_host(lon1, lat1, lon2, lat2, 10.0),
            geom.spherematch_host(lon1[0], lat1[0], lon2, lat2, 25.0),
            geom.spherematch_host(lon1, lat1, lon1, lat1, 0.0))


def _nufft_delay(nd, rng):
    """The numpy pieces of engine/nufft_delay: the float64 reference, the
    spectral reference in both bases, the gather window's sizing and the
    two-float split."""
    S, B, C = 120, 4, 64
    nu0, dnu = 100e6, 781250.0
    freqs = nu0 + dnu * np.arange(C)
    tau = rng.uniform(-6e-7, 6e-7, (S, B))
    A = rng.uniform(0.1, 10.0, S)[:, None] \
        * (freqs[None, :] / 150e6) ** rng.uniform(-2.5, 0.0, S)[:, None]
    clustered = np.concatenate([tau[:S // 2], rng.uniform(0, 2e-9,
                                                          (S // 2, B))])
    return (nd.nufft_delay_visibilities(tau, A[:, 0], nu0, dnu, C),
            nd.nufft_delay_visibilities(tau, A[:, :B], nu0, dnu, C, K=9),
            nd.nufft_delay_visibilities_spectral(tau, A, nu0, dnu, C, rank=8),
            nd.nufft_delay_visibilities_spectral(tau, A, nu0, dnu, C, rank=8,
                                                 basis="chebyshev"),
            nd.size_gather_window(clustered, dnu, C),
            nd.size_gather_window(clustered, dnu, C, K=9, margin=1.5),
            nd._split_host(nu0 + 0.1))


def _windows(win, rng):
    chans = 150e6 + 1e5 * np.arange(64)
    return [(win.window_frac_width(shape, fftpow),
             win.window_n2width(shape, fftpow),
             win.subband_window(chans, fc, bw, shape=shape, fftpow=fftpow))
            for shape in ("bhw", "bnw", "rect") for fftpow in (1.0, 2.0)
            for fc, bw in ((151e6, 2e6), (153.3e6, 1.2e6), (149e6, 8e6))]


def _vis_set(vis, rng, nbl=5, nchan=6, nacc=3, lst0=10.0, f0=150e6):
    shp = (nbl, nchan, nacc)
    return vis.VisibilitySet(
        baselines=rng.normal(0, 40, (nbl, 3)),
        labels=np.asarray([[str(i + 1), str(i)] for i in range(nbl)]),
        freqs=f0 + 1e5 * np.arange(nchan),
        lst=lst0 + 0.25 * np.arange(nacc),
        skyvis=rng.normal(size=shp) + 1j * rng.normal(size=shp),
        vis=rng.normal(size=shp) + 1j * rng.normal(size=shp),
        vis_rms=rng.uniform(1, 2, shp), bp=rng.uniform(0.5, 1, shp),
        timestamps=2458000.0 + np.arange(nacc) / 1440.0,
        t_acc=np.full(nacc, 60.0),
        projected_baselines=rng.normal(0, 40, (nbl, 3, nacc)),
        pointing_center=np.tile([[90.0, 0.0]], (nacc, 1)),
        phase_center=np.tile([[85.0, 10.0]], (nacc, 1)), latitude=-30.7,
        lags=np.arange(nchan, dtype=float),
        skyvis_lag=np.ones(shp, complex))


def _vis_merge(vis, rng):
    vs = _vis_set(vis, rng)
    parts = (vs, _vis_set(vis, rng, lst0=11.0, f0=151e6))
    return ([vis.conjugate(vs), vis.conjugate(vs, [0, 3])]
            + [vis.concatenate(parts, axis) for axis in (0, 1, 2)])


def _cosmology(cos, rng):
    z = rng.uniform(6, 12, 5)
    lcdm = cos.FlatLCDM(H0=70.0, Om0=0.3)
    return (cos.cosmo100.efunc(z), cos.cosmo100.comoving_distance(z),
            lcdm.comoving_distance(z[0]), lcdm.Ogamma0, lcdm.Ode0,
            cos.dkprll_deta(z), cos.k_parallel(rng.normal(0, 1e-6, 9), 8.5),
            cos.k_perp(rng.uniform(10, 900, 4), 8.5, 2.0),
            cos.comoving_depth(8e6, z), cos.jy2k(rng.uniform(1, 3, 3)),
            cos.freq_to_z(150e6), cos.z_to_freq(z))


def _closure(mods, rng):
    cl, vis, lay, bl = mods
    pos = np.zeros((9, 3))
    pos[:, 0] = 14.6 * (np.arange(9) % 3)
    pos[:, 1] = 12.6 * (np.arange(9) // 3)
    labels = np.asarray([str(i) for i in range(9)])
    bset = bl.build_baselines(lay.ArrayLayout(pos, labels), redundant=True)
    cube = (rng.normal(size=(bset.nbl, 8, 2))
            + 1j * rng.normal(size=(bset.nbl, 8, 2)))
    vs = vis.VisibilitySet(
        baselines=bset.vectors, labels=bset.labels,
        freqs=150e6 + 1e5 * np.arange(8), lst=np.asarray([10.0, 10.5]),
        skyvis=cube, vis=cube * 1.1, latitude=-30.7,
        layout=dict(positions=pos, labels=labels, ids=np.arange(9),
                    coords="ENU"))
    fast = cl.unique_triads_fast(labels, pos, max_classes=12)
    out = cl.closure_phases_vs(vs)
    out.pop("triads")
    return (cl.all_triads(labels[:5]), cl.unique_triads(labels, pos), fast,
            cl.triad_baseline_indices(bset.labels, fast,
                                      baselines=bset.vectors,
                                      ant_positions=pos, ant_labels=labels),
            out, cl.delay_filter(cube, 1e5, 2e-6),
            cl.delay_filter(cube, 1e5, rng.uniform(0, 5e-6, bset.nbl),
                            mode="retain", freq_wts=np.hanning(8)),
            cl.spectral_smooth(cube, window_size=3),
            cl.spectral_smooth(cube, mode="interp", flag_chans=[2, 5]))


def _power_spectrum(mods, rng):
    ps, vis = mods
    beam = rng.uniform(0, 1, (768, 8))
    freqs = 150e6 + 1e5 * np.arange(8)
    sbds = dict(freq_center=np.asarray([150.3e6, 150.5e6]),
                bw_eff=np.asarray([3e5, 4e5]),
                lags=np.fft.fftshift(np.fft.fftfreq(16, 1e5)),
                freq_wts=rng.uniform(0, 1, (2, 8)),
                skyvis_lag=rng.normal(size=(3, 2, 16, 2)) + 0j)
    vs = vis.VisibilitySet(baselines=rng.normal(0, 30, (3, 3)),
                           labels=np.asarray([["1", "0"]] * 3), freqs=freqs,
                           lst=np.asarray([1.0, 2.0]))
    return (ps.beam3Dvol(beam, freqs),
            ps.beam3Dvol(beam[:, 0], freqs, freq_wts=sbds["freq_wts"],
                         hemisphere=False),
            ps.subband_power_spectra(vs, sbds, beam),
            ps.baseline_orientation_bins(rng.normal(0, 30, (20, 3)), 6))


def _bispectrum(bsp, rng):
    nlst, ndays, ntri, nchan = 4, 4, 5, 32
    cpd = bsp.ClosurePhaseData(
        cp=rng.uniform(-0.5, 0.5, (nlst, ndays, ntri, nchan)),
        wts=(rng.uniform(size=(nlst, ndays, ntri, nchan)) > 0.1) * 1.0,
        freqs=150e6 + 1e5 * np.arange(nchan),
        lst=np.linspace(1.0, 1.6, nlst), days=2458000.0 + np.arange(ndays),
        triads=np.asarray([[str(i), str(i + 1), str(i + 2)]
                           for i in range(ntri)]))
    ft = bsp.cpds_ft(cpd.eicp, cpd.wts, cpd.freqs, [151e6, 152e6], 1e6)
    ps = bsp.cross_power_spectrum(ft, ft)
    full = [bsp.xcpdps_full(ft, **kw) for kw in (
        dict(cohax=(2,), incohax=(1, 3), collapse_axes=(3,),
             lst_shifts=np.arange(2)),
        dict(incohax=(1, 3), collapse_axes=(1, 3), avgcov=True),
        dict(incohax=(3,), collapse_axes=(3,), stat="median"))]
    ps["lst"] = cpd.lst
    vis_triad = rng.normal(size=(3, 3, nchan)) + 1j
    return (cpd.smooth_in_tbins(lstbinsize=0.3),
            cpd.smooth_in_tbins(lstbinsize=0.3, daybinsize=2.0,
                                stat="median"),
            cpd.tbin_stats(daybinsize=2.0), cpd.tbin_stats(lstbinsize=0.3),
            cpd.subtract(cpd.cp[:, :1]), cpd.subsample_differencing(2, 3),
            ft, ps, bsp.kbin_average(ps["kprll"], np.abs(ps["P"]),
                                     num_kbins=6),
            bsp.cross_power_diagonal(ft, cpd.lst, axis=1), full,
            bsp.incoherent_average([np.abs(ps["P"])] * 2, [1.0, 3.0]),
            bsp.power_spectrum_uncertainty(cpd, [151e6], [1e6], ndaybins=2),
            bsp.rescale_power_spectrum(ps, ft["freq_wts"], vis_triad,
                                       np.asarray([1.0, 1.3, 1.6])),
            bsp.average_rescaled_power_spectrum(np.abs(ps["P"]),
                                                ps["kprll"], (1, 2), 0.1))


def _aperture(ap, rng):
    """tests/test_aux.py's uvw cases, and random baselines, LSTs and phase
    centers in every coordinate system."""
    bl = rng.normal(0, 60, (7, 3))
    lst = rng.uniform(0, 360, 4)
    freqs = np.asarray([150e6, 300e6])
    out = [ap.gen_uvw(np.asarray([[100.0, 0.0, 0.0], [0.0, 50.0, 0.0]]),
                      -30.7, [10.0], np.asarray([[0.0, -30.7]]), "hadec"),
           ap.gen_uvw(np.asarray([[100.0, 0.0, 0.0]]), -30.7, [0.0],
                      np.asarray([[0.0, -30.7]]), "hadec", freqs=freqs)]
    for coords, pc in (("hadec", rng.uniform(-40, 40, (4, 2))),
                       ("radec", rng.uniform(0, 60, (1, 2))),
                       ("altaz", np.stack([rng.uniform(40, 90, 4),
                                           rng.uniform(0, 360, 4)], -1))):
        out.append(ap.gen_uvw(bl, -26.7, lst, pc, coords,
                              freqs=150e6 + 1e6 * np.arange(3)))
    uvw_l = out[-1][1]
    return (out, ap.reorder_uvw(uvw_l), ap.uvw_grid(uvw_l),
            ap.uvw_grid(uvw_l, spacing=2.0, pad=[1.0, 2.0], pow2=False),
            ap.uvw_grid(ap.reorder_uvw(uvw_l), pad=3.0))


CASES = {
    "aperture_synthesis": (_aperture, ap_j, ap_t),
    "windows": (_windows, win_j, win_t),
    "vis_conjugate_concatenate": (_vis_merge, vis_j, vis_t),
    "cosmology": (_cosmology, cos_j, cos_t),
    "closure": (_closure, (cl_j, vis_j, lay_j, bl_j),
                (cl_t, vis_t, lay_t, bl_t)),
    "power_spectrum": (_power_spectrum, (ps_j, vis_j), (ps_t, vis_t)),
    "bispectrum": (_bispectrum, bsp_j, bsp_t),
    "healpix": (_healpix, hp_j, hp_t),
    "layouts": (_layouts, lay_j, lay_t),
    "baselines": (_baselines, (lay_j, bl_j), (lay_t, bl_t)),
    "ephemeris": (_ephemeris, eph_j, eph_t),
    "skymodel": (_skymodel, sm_j, sm_t),
    "gains": (_gains, gn_j, gn_t),
    "catalogs": (_catalogs, (cat_j, sm_j), (cat_t, sm_t)),
    "nufft_delay": (_nufft_delay, nd_j, nd_t),
}


def test_custom_ascii_catalog_matches_prisim_tpu(tmp_path):
    """catalogs.read_custom_ascii (in both packages' __all__) gives the
    reference's SkyModel on the same files."""
    assert "read_custom_ascii" in cat_t.__all__
    want = _custom_ascii(cat_j, np.random.default_rng(7), str(tmp_path))
    got = _custom_ascii(cat_t, np.random.default_rng(7), str(tmp_path))
    assert_same(got, want, "read_custom_ascii")


def test_spherematch_host_matches_prisim_tpu():
    want = _spherematch(geom_j, np.random.default_rng(8))
    got = _spherematch(geom_t, np.random.default_rng(8))
    assert_same(got, want, "spherematch_host")


def test_tsys_model_matches_prisim_tpu():
    """engine/noise.tsys_model (torch in the port, numpy in the reference
    with xp=np): the power law to float64 rounding, the Tnet override
    exactly."""
    freqs = 100e6 + 1e6 * np.arange(64)
    got = noise_t.tsys_model(100.0, 350.0, 150e6, -2.55, freqs)
    want = noise_j.tsys_model(100.0, 350.0, 150e6, -2.55, freqs, xp=np)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)
    got = noise_t.tsys_model(100.0, 350.0, 150e6, -2.55,
                             torch.as_tensor(freqs), Tnet=220.0)
    assert got.shape == (64,)
    np.testing.assert_array_equal(
        got.numpy(), noise_j.tsys_model(100.0, 350.0, 150e6, -2.55, freqs,
                                        Tnet=220.0, xp=np))


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_copy_matches_prisim_tpu(name):
    fn, ref, port = CASES[name]
    want = fn(ref, np.random.default_rng(2024))
    got = fn(port, np.random.default_rng(2024))
    assert_same(got, want, name)
