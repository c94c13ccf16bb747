"""The port's copies of the JAX package's numpy host modules (healpix,
layouts, baselines, ephemeris, skymodel, gains and the catalog helpers)
give the reference's results: each case runs one function of both
packages on the same seeded numpy inputs and expects equal outputs, field
for field (the classes differ, the contents may not)."""

import dataclasses

import numpy as np
import pytest

from prisim_tpu import baselines as bl_j
from prisim_tpu import catalogs as cat_j
from prisim_tpu import ephemeris as eph_j
from prisim_tpu import gains as gn_j
from prisim_tpu import healpix as hp_j
from prisim_tpu import layouts as lay_j
from prisim_tpu import skymodel as sm_j
from prisim_tpu_torch import baselines as bl_t
from prisim_tpu_torch import catalogs as cat_t
from prisim_tpu_torch import ephemeris as eph_t
from prisim_tpu_torch import gains as gn_t
from prisim_tpu_torch import healpix as hp_t
from prisim_tpu_torch import layouts as lay_t
from prisim_tpu_torch import skymodel as sm_t


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


CASES = {
    "healpix": (_healpix, hp_j, hp_t),
    "layouts": (_layouts, lay_j, lay_t),
    "baselines": (_baselines, (lay_j, bl_j), (lay_t, bl_t)),
    "ephemeris": (_ephemeris, eph_j, eph_t),
    "skymodel": (_skymodel, sm_j, sm_t),
    "gains": (_gains, gn_j, gn_t),
    "catalogs": (_catalogs, (cat_j, sm_j), (cat_t, sm_t)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_copy_matches_prisim_tpu(name):
    fn, ref, port = CASES[name]
    want = fn(ref, np.random.default_rng(2024))
    got = fn(port, np.random.default_rng(2024))
    assert_same(got, want, name)
