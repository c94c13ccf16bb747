"""The port's catalog readers and FITS IO against prisim_tpu's: synthetic
catalogs written with prisim_tpu.io.fitsio (as tests/test_catalogs.py
writes them) read into the same SkyModels field for field, the port's
write_bintable writes the reference writer's bytes, and build_sky gives
the same sky for every catalog model in both packages."""

import dataclasses
import io

import numpy as np
import pytest

from prisim_tpu import catalogs as cat_jax
from prisim_tpu import config as cfg_jax
from prisim_tpu import driver as drv_jax
from prisim_tpu import healpix as hp
from prisim_tpu.io import fitsio as fits_jax

from prisim_tpu_torch import catalogs as cat_t
from prisim_tpu_torch import driver as drv_t
from prisim_tpu_torch.io import fitsio as fits_t


def _primary(fh, *extra):
    fh.write(fits_jax.format_header(
        [fits_jax.card("SIMPLE", True), fits_jax.card("BITPIX", 8),
         fits_jax.card("NAXIS", 0), fits_jax.card("EXTEND", True)]
        + list(extra)))


def write_nvss(path, n=7):
    rng = np.random.RandomState(0)
    with open(path, "wb") as fh:
        _primary(fh)
        fits_jax.write_bintable(fh, "NVSS", [
            ("RA(2000)", "1D", rng.uniform(0, 360, n)),
            ("DEC(2000)", "1D", np.linspace(-60, 40, n)),
            ("PEAK INT", "1D", np.linspace(1.0, 5.0, n)),
            ("MAJOR AX", "1D", rng.uniform(0.005, 0.02, n)),
            ("MINOR AX", "1D", rng.uniform(0.002, 0.005, n))])


def write_gleam(path, n=5, pa=True):
    cols = [("RAJ2000", "1D", np.linspace(0, 300, n)),
            ("DEJ2000", "1D", np.full(n, -27.0)),
            ("int_flux_151", "1D", np.linspace(2, 8, n)),
            ("int_flux_174", "1D", np.linspace(1.8, 7.5, n)),
            ("alpha", "1D", np.r_[np.full(n - 1, -0.75), np.nan]),
            ("a_wide", "1E", np.full(n, 60.0)),
            ("b_wide", "1E", np.full(n, 50.0))]
    if pa:
        cols.append(("pa_wide", "1E", np.linspace(0, 90, n)))
    with open(path, "wb") as fh:
        _primary(fh)
        fits_jax.write_bintable(fh, "GLEAM", cols)


def write_dsm(path, nside=4, map_mhz=150.0, pixarea=True):
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    rng = np.random.RandomState(7)
    with open(path, "wb") as fh:
        _primary(fh, *([fits_jax.card("PIXAREA", hp.nside2pixarea(nside))]
                       if pixarea else []))
        fits_jax.write_bintable(fh, "DSM", [
            ("RA", "1D", np.degrees(phi)), ("DEC", "1D", 90 - np.degrees(theta)),
            ("T_%.0f" % map_mhz, "1D", 100.0 + 10.0 * rng.rand(npix)),
            ("spindex", "1D", -2.55 + 0.05 * rng.randn(npix))])


def write_sumss(path, n=5):
    rows = ["%d 30 0.0 -35 %d 0.0 0 0 0 0 %g 0 45.0 40.0 10.0 %g %g"
            % (i + 1, i, 100.0 * (i + 1), 30.0 * (i == n - 1),
               30.0 * (i == n - 1)) for i in range(n)]
    with open(path, "w") as f:
        f.write("\n".join(rows))


def write_mwacs(path):
    with open(path, "w") as f:
        f.write("ra,dec,flux,alpha\n10.0,-26.0,5.5,-0.7\n20.0,-28.0,2.5,\n")


def assert_same_skymodel(a, b):
    """Every SkyModel field equal, the spectral parameters key for key."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "spec_parms":
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


READERS = {
    # name: (writer, filename, kwargs of both readers)
    "nvss": (write_nvss, "nvss.fits", {}),
    "nvss_no_sumss_sky": (write_nvss, "nvss.fits",
                          dict(exclude_sumss_sky=True, spindex_rms=0.1,
                               spindex_seed=3)),
    "gleam": (write_gleam, "gleam.fits", dict(select_freq=170e6)),
    "gleam_no_pa": (lambda p: write_gleam(p, pa=False), "gleam.fits", {}),
    "dsm": (write_dsm, "dsm.fits", {}),
    "dsm_no_pixarea": (lambda p: write_dsm(p, pixarea=False), "dsm.fits",
                       dict(map_freq=150e6)),
    "dsm_prefix": (write_dsm, "dsm_150.0_MHz_nside_4.fits", dict(nside=4)),
    "sumss": (write_sumss, "sumss.txt", dict(spindex_rms=0.2,
                                             spindex_seed=1)),
    "mwacs": (write_mwacs, "mwacs.csv", dict(spindex_mean=-0.9)),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_matches_jax(tmp_path, name):
    writer, fname, kw = READERS[name]
    path = str(tmp_path / fname)
    writer(path)
    reader = name.split("_")[0]
    reader = "dsm_fits" if reader == "dsm" else reader
    if name == "dsm_prefix":
        path = str(tmp_path / "dsm")
    got = getattr(cat_t, "read_" + reader)(path, **kw)
    want = getattr(cat_jax, "read_" + reader)(path, **kw)
    assert got.nsrc > 0
    assert_same_skymodel(got, want)
    if reader in ("nvss", "gleam", "dsm_fits"):
        assert got.src_shape.shape == (got.nsrc, 3)


@pytest.mark.parametrize("map_freq", [150e6, 180e6])
def test_write_dsm_fits_reads_as_the_reference_file(tmp_path, map_freq):
    """The port's DSM writer against a table written with prisim_tpu's
    write_bintable (write_dsm's): both readers give the same SkyModel."""
    ref = str(tmp_path / "ref.fits")
    write_dsm(ref, map_mhz=map_freq / 1e6)
    cols = fits_jax.read_fits(ref)[1]["columns"]
    path = str(tmp_path / "port.fits")
    cat_t.write_dsm_fits(path, cols["T_%.0f" % (map_freq / 1e6)],
                         cols["spindex"], map_freq=map_freq)
    want = cat_jax.read_dsm_fits(ref, map_freq=map_freq)
    for read in (cat_t.read_dsm_fits, cat_jax.read_dsm_fits):
        assert_same_skymodel(read(path, map_freq=map_freq), want)


def test_flux_cut_is_the_reference_one():
    """The port's copy of flux_cut keeps the reference's sources: the same
    power-law models, the same cut, the same SkyModel fields."""
    args = ([0, 10, 20], [-30, -30, -30], [1.0, 5.0, 20.0], 150e6,
            [-0.8] * 3)
    got = cat_t.flux_cut(cat_t._powerlaw_model(*args), flux_min=2.0,
                         cut_freq=100e6)
    want = cat_jax.flux_cut(cat_jax._powerlaw_model(*args), flux_min=2.0,
                            cut_freq=100e6)
    assert got.nsrc == 2
    assert_same_skymodel(got, want)


TABLE = [("NAME", "8A", np.asarray(["a", "bb", "a long name"])),
         ("N", "1J", np.arange(5)), ("I2", "1I", -np.arange(5)),
         ("K", "1K", 2 ** 40 + np.arange(5)),
         ("E", "1E", np.linspace(0, 1, 5)), ("D", "1D", np.pi * np.arange(5)),
         ("V3", "3D", np.arange(15.0).reshape(5, 3)),
         ("V2", "2E", np.arange(5.0))]         # one value per row, resized


def _table(n=5):
    cols = []
    for name, tform, arr in TABLE:
        if name == "NAME":
            arr = np.resize(arr, n)
        cols.append((name, tform, arr))
    return cols


def test_write_bintable_bytes_match_jax():
    """Byte for byte, except the resized column V2: there the reference
    writer's np.resize drops the big-endian byte order (a quirk of
    prisim_tpu.io.fitsio, ROADMAP queue 3), which the port does not
    copy."""
    a, b = io.BytesIO(), io.BytesIO()
    extra = [fits_jax.card("PIXAREA", 1.5e-4)]
    fits_jax.write_bintable(a, "T", _table()[:-1], extra_cards=extra)
    fits_t.write_bintable(b, "T", _table()[:-1], extra_cards=extra)
    assert a.getvalue() == b.getvalue()
    assert len(b.getvalue()) % fits_t.BLOCK == 0


def test_write_bintable_reads_back_in_both(tmp_path):
    path = str(tmp_path / "t.fits")
    with open(path, "wb") as fh:
        fh.write(fits_t.format_header([
            fits_t.card("SIMPLE", True), fits_t.card("BITPIX", 8),
            fits_t.card("NAXIS", 0), fits_t.card("PIXAREA", 2.5e-3)]))
        fits_t.write_bintable(fh, "ONE", _table())
        fits_t.write_bintable(fh, "TWO", [("X", "1D", np.arange(3.0))])
    for read in (fits_t.read_fits, fits_jax.read_fits):
        hdus = read(path)
        assert len(hdus) == 3
        assert hdus[0]["header"]["PIXAREA"] == 2.5e-3
        cols = hdus[1]["columns"]
        assert hdus[1]["header"]["EXTNAME"] == "ONE"
        np.testing.assert_array_equal(cols["NAME"], np.asarray(
            [b"a       ", b"bb      ", b"a long n", b"a       ",
             b"bb      "]))
        for name, _, arr in _table()[1:-1]:
            np.testing.assert_array_equal(cols[name], arr, err_msg=name)
        np.testing.assert_array_equal(cols["V2"][:, 0], np.arange(5.0))
        np.testing.assert_array_equal(hdus[2]["columns"]["X"], np.arange(3.0))


def test_read_fits_image_and_groups(tmp_path):
    """An image HDU and a random-groups (UVFITS) HDU read as the reference
    reads them."""
    path = str(tmp_path / "img.fits")
    img = np.arange(12.0).reshape(3, 4)
    with open(path, "wb") as fh:
        fits_jax.write_image(fh, img, primary=True)
        fits_jax.write_image(fh, img.astype(np.float32), extname="F32")
        fits_jax.write_bintable(fh, "AFTER", [("X", "1D", np.ones(2))])
    got, want = fits_t.read_fits(path), fits_jax.read_fits(path)
    assert len(got) == len(want) == 3
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g["data"], w["data"])
    np.testing.assert_array_equal(got[2]["columns"]["X"], np.ones(2))
    path = str(tmp_path / "groups.fits")
    cards = [fits_jax.card(k, v) for k, v in (
        ("SIMPLE", True), ("BITPIX", -32), ("NAXIS", 2), ("NAXIS1", 0),
        ("NAXIS2", 3), ("GROUPS", True), ("PCOUNT", 2), ("GCOUNT", 4))]
    pars = np.arange(8.0).reshape(4, 2)
    with open(path, "wb") as fh:
        fits_jax.write_random_groups(fh, pars, -np.arange(12.0).reshape(4, 3),
                                     cards)
    (got,), (want,) = fits_t.read_fits(path), fits_jax.read_fits(path)
    assert got["header"] == want["header"]
    for key in ("pars", "data"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["pars"], pars)


def _sky_parms(model, tmp_path, **cat):
    return cfg_jax.load_parms({
        "bandpass": {"nchan": 8, "freq": 150e6, "freq_resolution": 1e6},
        "skyparm": {"model": model, "nside": 4, "flux_min": None,
                    "spindex_rms": 0.1, "spindex_seed": 2},
        "catalog": cat})


@pytest.mark.parametrize("model", ["nvss", "gleam", "sumss", "mwacs", "csm",
                                   "asm", "dsm", "dsm_prefix", "hpx_fits",
                                   "nvss_cut", "csm_cut", "asm_cut"])
def test_build_sky_matches_jax(tmp_path, model):
    files = {}
    for name, (writer, fname, _) in READERS.items():
        if name in ("nvss", "gleam", "dsm", "sumss", "mwacs"):
            files[name] = str(tmp_path / fname)
            writer(files[name])
    write_dsm(str(tmp_path / "dsm_150.0_MHz_nside_4.fits"))
    base = model.split("_")[0]
    cat = {"csm": dict(SUMSS_file=files["sumss"], NVSS_file=files["nvss"]),
           "asm": dict(SUMSS_file=files["sumss"], NVSS_file=files["nvss"],
                       DSM_file_prefix=files["dsm"])}.get(base, {})
    if base in ("nvss", "gleam", "sumss", "mwacs"):
        cat = {base.upper() + "_file": files[base]}
    elif model == "dsm":
        cat = {"DSM_file_prefix": files["dsm"]}
    elif model == "dsm_prefix":
        cat = {"DSM_file_prefix": str(tmp_path / "dsm")}
    elif model == "hpx_fits":
        base, cat = "hpx", {"spectrum_file": files["dsm"]}
    parms = _sky_parms(base, tmp_path, **cat)
    if model.endswith("_cut"):
        parms["skyparm"].update(flux_min=2.0, flux_max=4.0,
                                fluxcut_reffreq=1e9)
    freqs = drv_jax.build_frequencies(parms)
    got = drv_t.build_sky(parms, freqs)
    want = drv_jax.build_sky(parms, freqs)
    assert got.nsrc > 0
    assert_same_skymodel(got, want)


def test_csm_needs_a_catalog(tmp_path):
    with pytest.raises(ValueError, match="SUMSS_file"):
        drv_t.build_sky(_sky_parms("csm", tmp_path), np.asarray([150e6]))
