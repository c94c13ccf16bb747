"""The port's product IO against prisim_tpu's: random-groups FITS, UVFITS
(1, 2 and 4 polarizations, the cross-pols flagged zeros or simulated),
UVH5, the native FITS product and the nested-dict HDF5 files, each
written by both packages from a VisibilitySet built from the same numpy
arrays. The FITS files are byte-identical apart from the card that names
the package (UVFITS HISTORY), the UVH5 files hold the same datasets apart
from `history`, and each package reads the other's files. The
conformance checks of tests/test_uvfits_spec.py run on both writers."""

import dataclasses

import h5py
import numpy as np
import pytest

import prisim_tpu.io.uvfits as uvfits_jax
import prisim_tpu.io.uvh5 as uvh5_jax
from prisim_tpu import catalogs as cat_jax
from prisim_tpu import geometry as geom_jax
from prisim_tpu import vis as vis_jax
from prisim_tpu import windows as win_jax
from prisim_tpu.io import dicth5 as dicth5_jax
from prisim_tpu.io import fitsio as fits_jax
from prisim_tpu.io import fitsnative as native_jax

from prisim_tpu_torch import catalogs as cat_t
from prisim_tpu_torch import geometry as geom_t
from prisim_tpu_torch import vis as vis_t
from prisim_tpu_torch import windows as win_t
from prisim_tpu_torch.io import dicth5 as dicth5_t
from prisim_tpu_torch.io import fitsio as fits_t
from prisim_tpu_torch.io import fitsnative as native_t
from prisim_tpu_torch.io import uvfits as uvfits_t
from prisim_tpu_torch.io import uvh5 as uvh5_t

import test_uvfits_spec as spec
from test_catalog_fits import _write_hi_cube

BLOCK = 2880
small_vs = spec.small_vs      # the fixture of the conformance checks


def _vs_arrays(seed=7, nant=5, nchan=8, nacc=3, flagged=True):
    """The fields of a small VisibilitySet as numpy arrays: all pairs of a
    random 5-antenna layout with non-integer labels, complex64 sky, noise
    and observed cubes, Tsys/rms, a bandpass with a flagged channel and
    a tapered weight, pointing and phase centres."""
    rng = np.random.RandomState(seed)
    pos = np.c_[rng.uniform(-40, 40, (nant, 2)), rng.uniform(-1, 1, nant)]
    names = np.asarray(["A%d" % (10 + 3 * i) for i in range(nant)])
    ii, jj = np.triu_indices(nant, 1)
    bl = pos[jj] - pos[ii]
    labels = np.stack([names[jj], names[ii]], axis=-1)
    nbl = bl.shape[0]

    def cube():
        return (rng.randn(nbl, nchan, nacc)
                + 1j * rng.randn(nbl, nchan, nacc)).astype(np.complex64)
    sky, noise = cube(), cube()
    bp = np.ones((nbl, nchan, nacc))
    if flagged:
        bp[:, 2, :] = 0.0
    wts = np.broadcast_to(np.hanning(nchan + 2)[1:-1][None, :, None],
                          (nbl, nchan, nacc)).copy()
    lst = 30.0 + 0.25 * np.arange(nacc)
    return dict(
        baselines=bl, labels=labels, freqs=150e6 + 97656.25 * np.arange(nchan),
        lst=lst, skyvis=sky, vis=sky + noise, vis_noise=noise,
        vis_rms=np.abs(rng.randn(nbl, nchan, nacc)), Tsys=np.full(
            (nbl, nchan, nacc), 120.0),
        timestamps=2458100.25 + np.arange(nacc) * 60.0 / 86400.0,
        t_acc=np.full(nacc, 60.0), bp=bp, bp_wts=wts, A_eff=154.0,
        eff_Q=0.96, latitude=-30.7224, longitude=21.4278, altitude=1051.7,
        pointing_center=np.tile([[90.0, 270.0]], (nacc, 1)),
        phase_center=np.tile([[80.0, 200.0]], (nacc, 1)),
        telescope={"id": "hera", "shape": "dish", "size": 14.0},
        layout=dict(positions=pos, labels=names, ids=np.arange(nant),
                    coords="ENU"))


def _pair(**kw):
    """(JAX VisibilitySet, port VisibilitySet) of the same arrays."""
    a = _vs_arrays(**kw)
    return vis_jax.VisibilitySet(**a), vis_t.VisibilitySet(**a)


def _components(n):
    """n (JAX, port) pairs with the same layout and other cubes (the
    polarization components of one run)."""
    return [_pair(seed=7 + k) for k in range(n)]


def _without_history(path, package):
    """The bytes of the file at `path` with its one HISTORY card, which
    names `package`, blanked."""
    buf = open(path, "rb").read()
    assert len(buf) % BLOCK == 0
    card = ("%-80s" % ("HISTORY " + package)).encode("ascii")
    assert buf.count(card) == 1 and buf.index(card) % 80 == 0
    return buf.replace(card, b" " * 80)


UV_CASES = {
    "1pol": (1, {}),
    "1pol_yy": (1, {"pols": (-6,)}),
    "2pol": (2, {}),
    "4pol_flagged": (2, {"four_pol": True}),
    "4pol_cross": (3, {"four_pol": True, "cross": True}),
    "4pol_cross_pair": (4, {"four_pol": True, "cross": True}),
}


def _uv_kwargs(case, side):
    """(first VisibilitySet, save kwargs) of a UV_CASES entry for `side`
    (0: JAX, 1: the port)."""
    n, opts = UV_CASES[case]
    comps = [c[side] for c in _components(n)]
    kw = {k: v for k, v in opts.items() if k != "cross"}
    if n > 1:
        kw["vs_second"] = comps[1]
    if opts.get("cross"):
        kw["vs_cross"] = comps[2] if n == 3 else (comps[2], comps[3])
    return comps[0], kw


@pytest.mark.parametrize("datatype", ["noiseless", "noisy"])
@pytest.mark.parametrize("case", sorted(UV_CASES))
def test_uvfits_bytes_match_jax(tmp_path, case, datatype):
    paths = {}
    for side, mod in enumerate((uvfits_jax, uvfits_t)):
        vs, kw = _uv_kwargs(case, side)
        paths[side] = str(tmp_path / ("%d.uvfits" % side))
        mod.save_uvfits(vs, paths[side], datatype=datatype, **kw)
    assert (_without_history(paths[1], "prisim_tpu_torch")
            == _without_history(paths[0], "prisim_tpu"))


@pytest.mark.parametrize("case", sorted(UV_CASES))
def test_uvfits_each_package_reads_the_other(tmp_path, case):
    """load_uvfits of either package on either package's file gives the
    same VisibilitySet (the first polarization), and the full STOKES axis
    reads the same through both read_fits."""
    paths = {}
    for side, mod in enumerate((uvfits_jax, uvfits_t)):
        vs, kw = _uv_kwargs(case, side)
        paths[side] = str(tmp_path / ("%d.uvfits" % side))
        mod.save_uvfits(vs, paths[side], **kw)
    loads = {(side, pkg): mod.load_uvfits(paths[side])
             for side in (0, 1) for pkg, mod in enumerate((uvfits_jax,
                                                           uvfits_t))}
    want = loads[0, 0]
    first = _uv_kwargs(case, 1)[0]
    for key, got in loads.items():
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, dict) and f.name == "layout":
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, (key, f.name)
    np.testing.assert_array_equal(want.skyvis, first.skyvis)
    for side in (0, 1):
        (g,) = [h for h in fits_t.read_fits(paths[side]) if "pars" in h]
        (w,) = [h for h in fits_jax.read_fits(paths[side]) if "pars" in h]
        np.testing.assert_array_equal(g["data"], w["data"])
        np.testing.assert_array_equal(g["pars"], w["pars"])


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, node: out.__setitem__(
            name, node[()] if isinstance(node, h5py.Dataset) else None))
    return out


@pytest.mark.parametrize("case", sorted(UV_CASES))
def test_uvh5_matches_jax_and_reads_across(tmp_path, case):
    paths = {}
    for side, mod in enumerate((uvh5_jax, uvh5_t)):
        vs, kw = _uv_kwargs(case, side)
        paths[side] = str(tmp_path / ("%d.uvh5" % side))
        mod.save_uvh5(vs, paths[side], **kw)
    want, got = _h5_items(paths[0]), _h5_items(paths[1])
    assert sorted(got) == sorted(want)
    assert want.pop("Header/history") == b"prisim_tpu"
    assert got.pop("Header/history") == b"prisim_tpu_torch"
    for name, w in want.items():
        g = got[name]
        if w is None:
            assert g is None, name
            continue
        assert np.asarray(g).dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for side in (0, 1):
        a = uvh5_t.read_uvh5_arrays(paths[side])
        b = uvh5_jax.read_uvh5_arrays(paths[1 - side])
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        vt, vj = uvh5_t.load_uvh5(paths[side]), uvh5_jax.load_uvh5(
            paths[1 - side])
        for f in ("skyvis", "baselines", "labels", "freqs", "lst",
                  "timestamps", "t_acc", "bp_wts"):
            np.testing.assert_array_equal(getattr(vt, f), getattr(vj, f),
                                          err_msg=f)


def test_uv_writers_reject_bad_pol_arguments(tmp_path):
    vs = _pair()[1]
    for save in (uvfits_t.save_uvfits, uvh5_t.save_uvh5):
        with pytest.raises(ValueError, match="four_pol requires"):
            save(vs, str(tmp_path / "x"), four_pol=True)
        with pytest.raises(ValueError, match="pols must match"):
            save(vs, str(tmp_path / "x"), pols=(-5, -6))
        with pytest.raises(ValueError, match="not present"):
            save(dataclasses.replace(vs, vis=None), str(tmp_path / "x"),
                 datatype="noisy")


def test_uvh5_without_h5py_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(uvh5_t, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        uvh5_t.save_uvh5(_pair()[1], str(tmp_path / "x.uvh5"))


@pytest.mark.parametrize("kind", ["full", "no_lags_no_layout"])
def test_native_fits_bytes_match_jax_and_read_across(tmp_path, kind):
    a = _vs_arrays()
    if kind == "full":
        vt = vis_t.delay_transform(vis_t.project_baselines(
            vis_t.VisibilitySet(**a)), pad=1.0, device="cpu")
        a = {f.name: getattr(vt, f.name) for f in dataclasses.fields(vt)}
    else:
        a.update(layout=None, Tsys=None, vis_rms=None, timestamps=None)
    vj, vt = vis_jax.VisibilitySet(**a), vis_t.VisibilitySet(**a)
    pj, pt = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
    native_jax.save_fits(vj, pj)
    native_t.save_fits(vt, pt)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for back in (native_t.load_fits(pj), native_jax.load_fits(pt),
                 native_t.load_fits(pt)):
        for f in dataclasses.fields(vt):
            want, got = getattr(vt, f.name), getattr(back, f.name)
            if f.name in ("gradients", "blgroups", "lag_kernel"):
                continue
            if f.name == "layout" and want is not None:
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
            elif isinstance(want, np.ndarray):
                assert np.asarray(got).dtype.kind == want.dtype.kind, f.name
                np.testing.assert_array_equal(
                    got, np.asarray(want).astype(np.asarray(got).dtype),
                    err_msg=f.name)
            else:
                assert got == want, f.name


def test_random_groups_bytes_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    pars = rng.randn(6, 3)
    data = rng.randn(6, 1, 1, 4, 2, 3).astype(np.float32)
    cards = [fits_t.card(k, v) for k, v in (
        ("SIMPLE", True), ("BITPIX", -32), ("NAXIS", 6), ("NAXIS1", 0),
        ("NAXIS2", 3), ("NAXIS3", 2), ("NAXIS4", 4), ("NAXIS5", 1),
        ("NAXIS6", 1), ("GROUPS", True), ("PCOUNT", 3), ("GCOUNT", 6))]
    cards.append(fits_t.card("HISTORY", "x"))
    out = {}
    for name, mod in (("j", fits_jax), ("t", fits_t)):
        out[name] = str(tmp_path / (name + ".fits"))
        with open(out[name], "wb") as fh:
            mod.write_random_groups(fh, pars, data, cards)
    assert open(out["t"], "rb").read() == open(out["j"], "rb").read()
    (got,) = fits_t.read_fits(out["j"])
    np.testing.assert_array_equal(got["pars"], pars.astype(np.float32))
    np.testing.assert_array_equal(got["data"], data.reshape(6, 1, 1, 4, 2, 3))


@pytest.mark.parametrize("key,value,comment", [
    ("HISTORY", "prisim_tpu_torch", None), ("COMMENT", "a note", None),
    ("COMMENT", None, "x"), ("END", None, None), ("OBSRA", 12.5, "deg"),
    ("EXTEND", True, None), ("OBJECT", "it's", None)])
def test_card_matches_jax(key, value, comment):
    assert fits_t.card(key, value, comment) == fits_jax.card(key, value,
                                                             comment)


@pytest.mark.parametrize("pkg", ["prisim_tpu", "prisim_tpu_torch"])
def test_uvfits_spec_conformance(small_vs, tmp_path, monkeypatch, pkg):
    """tests/test_uvfits_spec.py's UVFITS checks (FITS 4.0 blocking, cards,
    random groups, AIPS Memo 117 parameters and axes, the AN table) on
    each package's writer."""
    if pkg == "prisim_tpu_torch":
        monkeypatch.setattr(uvfits_jax, "save_uvfits",
                            lambda vs, path: uvfits_t.save_uvfits(
                                _to_port(vs), path))
    spec.test_uvfits_bytes_conform_to_standard(small_vs, tmp_path)


@pytest.mark.parametrize("pkg", ["prisim_tpu", "prisim_tpu_torch"])
def test_uvh5_spec_conformance(small_vs, tmp_path, monkeypatch, pkg):
    """tests/test_uvfits_spec.py's UVH5 memo checks on each package's
    writer."""
    if pkg == "prisim_tpu_torch":
        monkeypatch.setattr(uvh5_jax, "save_uvh5",
                            lambda vs, path: uvh5_t.save_uvh5(
                                _to_port(vs), path))
    spec.test_uvh5_layout_conforms_to_memo(small_vs, tmp_path)


def _to_port(vs):
    return vis_t.VisibilitySet(**{f.name: getattr(vs, f.name)
                                  for f in dataclasses.fields(vs)})


def test_blnum_conversions_match_jax():
    i = np.asarray([0, 5, 100, 2000])
    j = np.asarray([1, 7, 300, 2040])
    for attempt256 in (False, True):
        b = uvfits_t.antnums_to_blnum(i, j, attempt256=attempt256)
        np.testing.assert_array_equal(b, uvfits_jax.antnums_to_blnum(
            i, j, attempt256=attempt256))
        for x, y in zip(uvfits_t.blnum_to_antnums(b),
                        uvfits_jax.blnum_to_antnums(b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    b = uvfits_t.antnums_to_blnum(3, 4, attempt256=True)
    assert b == 256 * 5 + 4
    np.testing.assert_array_equal(uvfits_t.blnum_to_antnums([b]), [[3], [4]])


def test_uvdata_arrays_match_jax():
    vj, vt = _pair()
    a, b = uvfits_t.uvdata_arrays(vt), uvfits_jax.uvdata_arrays(vj)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_wgs84_conversions_match_jax():
    rng = np.random.RandomState(4)
    enu = rng.randn(6, 3) * 100
    for lat, lon, alt in ((-30.7224, 21.4278, 1051.7), (52.9, 6.87, 16.0)):
        np.testing.assert_array_equal(geom_t.lla2ecef(lat, lon, alt),
                                      geom_jax.lla2ecef(lat, lon, alt))
        np.testing.assert_array_equal(geom_t.enu2ecef(enu, lat, lon, alt),
                                      geom_jax.enu2ecef(enu, lat, lon, alt))


def test_dicth5_round_trip_across_packages(tmp_path):
    d = {"freqs": np.linspace(1e8, 2e8, 5), "name": "delay spectrum",
         "n": 3, "none": None, "labels": np.asarray(["a", "bb"]),
         "sub": {"cube": np.arange(12.0).reshape(3, 4) + 1j,
                 "deep": {"flag": True, "x": 2.5}}}
    pj, pt = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    dicth5_jax.save_dict_hdf5(d, pj)
    dicth5_t.save_dict_hdf5(d, pt)
    assert _h5_items(pt).keys() == _h5_items(pj).keys()
    for back in (dicth5_t.load_dict_hdf5(pj), dicth5_jax.load_dict_hdf5(pt),
                 dicth5_t.load_dict_hdf5(pt)):
        assert back["name"] == "delay spectrum" and back["n"] == 3
        assert back["none"] is None
        np.testing.assert_array_equal(back["freqs"], d["freqs"])
        np.testing.assert_array_equal(back["labels"], d["labels"])
        np.testing.assert_array_equal(back["sub"]["cube"], d["sub"]["cube"])
        assert back["sub"]["deep"]["x"] == 2.5
        assert bool(back["sub"]["deep"]["flag"])


@pytest.mark.parametrize("fitstype", ["IMAGE", "TABLE"])
@pytest.mark.parametrize("fluctuations", [False, True])
def test_read_hi_cube_fits_matches_jax(tmp_path, fitstype, fluctuations):
    path = str(tmp_path / "hi.fits")
    _write_hi_cube(path, fitstype)
    got = cat_t.read_hi_cube_fits(path, 150e6, fluctuations=fluctuations)
    want = cat_jax.read_hi_cube_fits(path, 150e6, fluctuations=fluctuations)
    assert got.name == want.name and got.spec_kind == "spectrum"
    for f in ("location", "spectrum", "freqs_model"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def write_pfb_table(path, freqs, ccw=8, transpose=False):
    """tests/test_aux.py's measured PFB table: one filter column, scalloped
    in dB with minima at the coarse-channel edges, over 140-160 MHz."""
    fmhz = np.linspace(140.0, 160.0, 400)
    df = freqs[1] - freqs[0]
    fine = (fmhz - freqs[0] / 1e6) / (df / 1e6)
    resp = np.stack([-6.0 * (1 - np.cos(2 * np.pi * fine / ccw)) / 2,
                     -7.0 * (1 - np.cos(2 * np.pi * (fine + 1) / ccw)) / 2],
                    axis=1)
    with open(path, "wb") as fh:
        fits_jax.write_image(fh, resp.T if transpose else resp, primary=True)
        fits_jax.write_image(fh, fmhz, extname="FREQS")
    return path


@pytest.mark.parametrize("transpose", [False, True])
def test_pfb_theoretical_shape_matches_jax(tmp_path, transpose):
    freqs = 150e6 + 100e3 * (np.arange(32) - 16)
    path = write_pfb_table(str(tmp_path / "pfb.fits"), freqs,
                           transpose=transpose)
    got = win_t.pfb_theoretical_shape(path, freqs)
    np.testing.assert_array_equal(got, win_jax.pfb_theoretical_shape(path,
                                                                     freqs))
    assert got.shape == (32,) and got.max() == 1.0 and got.min() < 0.5
    with pytest.raises(ValueError, match="cover"):
        win_t.pfb_theoretical_shape(path, freqs * 3)


def test_load_fits_strips_label_padding(tmp_path):
    """Labels of different lengths: the writer pads each to the column
    width with blanks (both packages write the same bytes); the port's
    load_fits gives the labels back as written, prisim_tpu's keeps the
    padding (a settled deviation)."""
    a = _vs_arrays()
    names = np.asarray(["1", "22", "333", "4", "55"])
    ii, jj = np.triu_indices(5, 1)
    a["labels"] = np.stack([names[jj], names[ii]], axis=-1)
    a["layout"] = dict(a["layout"], labels=names)
    path = str(tmp_path / "t.fits")
    native_t.save_fits(vis_t.VisibilitySet(**a), path)
    got = native_t.load_fits(path)
    np.testing.assert_array_equal(got.labels, a["labels"])
    np.testing.assert_array_equal(got.layout["labels"], names)
    padded = native_jax.load_fits(path)
    assert padded.labels[0, 0] == "22 " and padded.layout["labels"][0] == "1  "
    np.testing.assert_array_equal(np.char.rstrip(padded.labels), got.labels)
