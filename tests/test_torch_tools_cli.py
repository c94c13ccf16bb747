"""The rest of the port's tools (prisim_tpu_torch.tools: convert,
update_noise, replicate, expand_redundant_file, list_sims, grep_sims,
read_feko/feko_to_healpix, gsm_to_npz, plot_sim, mesh_check, mesh_bench and
the CLI), altsim and the example's parameters, each against prisim_tpu's
on the same input files.

What is held, and how closely:
- products written from the same sim: UVFITS byte for byte apart from the
  HISTORY card that names the package (as tests/test_torch_io.py holds
  them), NPZ and HDF5 arrays equal;
- FEKO maps: within 1e-12 of their peak (the same numpy and scipy code),
  in the HDF5, FITS and NPZ outputs;
- ls/grep: equal, on YAML metadata and on the JSON that the port writes
  without pyyaml;
- noise (ROADMAP R4: torch.Generator draws cannot repeat JAX's threefry
  bits): the rms equal to JAX's, the draws' rms within 5% of it, and a
  same-seed repeat bit for bit;
- the CLI: each subcommand's parsed namespace equal to JAX's, apart from
  --device."""

import argparse
import copy
import dataclasses
import json
import os

import h5py
import numpy as np
import pytest
import yaml

from prisim_tpu import altsim as altsim_j
from prisim_tpu import config as cfg_j
from prisim_tpu import tools as tools_j
from prisim_tpu.io import load_hdf5 as load_hdf5_j
from prisim_tpu.io import save_hdf5 as save_hdf5_j
from prisim_tpu.vis import VisibilitySet as VisibilitySet_j

from prisim_tpu_torch import altsim as altsim_t
from prisim_tpu_torch import config as cfg_t
from prisim_tpu_torch import tools
from prisim_tpu_torch.beams import ExternalBeam
from prisim_tpu_torch.examples import full_pipeline
from prisim_tpu_torch.io import load_fits, load_npz
from prisim_tpu_torch.io.uvfits import load_uvfits

FEKO_BAR = 1e-12
NOISE_RMS_BAR = 0.05
EXAMPLE_YAML = os.path.join(os.path.dirname(__file__), "..", "prisim_tpu",
                            "examples", "simparms", "hera19_random.yaml")


def _vs(tmp_path, nchan=8, nacc=2, name="sim.hdf5"):
    """tests/test_tools.py's 4-antenna linear-array sim (redundant
    baselines), written with prisim_tpu's HDF5 writer."""
    from prisim_tpu.baselines import build_baselines
    from prisim_tpu.layouts import ArrayLayout
    pos = np.zeros((4, 3))
    pos[:, 0] = 14.6 * np.arange(4)
    layout = ArrayLayout(pos, np.asarray([str(i) for i in range(4)]))
    bls = build_baselines(layout, redundant=True)
    rng = np.random.RandomState(0)
    sv = rng.randn(bls.nbl, nchan, nacc) + 1j * rng.randn(bls.nbl, nchan,
                                                          nacc)
    vs = VisibilitySet_j(
        baselines=bls.vectors, labels=bls.labels,
        freqs=150e6 + 1e5 * np.arange(nchan),
        lst=10.0 + 0.5 * np.arange(nacc), skyvis=sv,
        timestamps=2458000.0 + np.arange(nacc) * 1e-3,
        t_acc=np.full(nacc, 10.0),
        Tsys=np.full((bls.nbl, nchan, nacc), 180.0), latitude=-30.7,
        layout=dict(positions=pos, labels=layout.labels, ids=np.arange(4),
                    coords="ENU"))
    path = str(tmp_path / name)
    save_hdf5_j(vs, path)
    return vs, path


def _without_history(path, package):
    """The bytes of a FITS file with its one HISTORY card, which names
    `package`, blanked."""
    buf = open(path, "rb").read()
    card = ("%-80s" % ("HISTORY " + package)).encode("ascii")
    assert buf.count(card) == 1 and buf.index(card) % 80 == 0
    return buf.replace(card, b" " * 80)


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _same_hdf5(a, b):
    """Two HDF5 files hold the same datasets and attribute names, equal
    but for the version string that names the package."""
    with h5py.File(a, "r") as x, h5py.File(b, "r") as y:
        names = []
        x.visit(names.append)
        other = []
        y.visit(other.append)
        assert sorted(names) == sorted(other)
        for n in names:
            if isinstance(x[n], h5py.Dataset) and n != "header/PRISim#":
                np.testing.assert_array_equal(x[n][()], y[n][()], err_msg=n)
            assert sorted(x[n].attrs) == sorted(y[n].attrs), n


def test_convert_matches_jax(tmp_path):
    vs, path = _vs(tmp_path)
    fmts = ["hdf5", "npz", "uvfits", "uvh5"]
    out_t = tools.convert(path, str(tmp_path / "t"), formats=fmts)
    out_j = tools_j.convert(path, str(tmp_path / "j"), formats=fmts)
    assert [os.path.basename(p)[1:] for p in out_t] == \
        [os.path.basename(p)[1:] for p in out_j]
    _same_hdf5(out_t[0], out_j[0])
    _same_npz(out_t[1], out_j[1])
    assert _without_history(out_t[2], "prisim_tpu_torch") == \
        _without_history(out_j[2], "prisim_tpu")
    for name in ("skyvis", "baselines", "freqs"):
        np.testing.assert_array_equal(getattr(load_hdf5_j(out_t[0]), name),
                                      getattr(vs, name))
    np.testing.assert_array_equal(load_uvfits(out_t[2]).skyvis,
                                  load_uvfits(out_j[2]).skyvis)
    with pytest.raises(ValueError, match="unknown format"):
        tools.convert(path, str(tmp_path / "x"), formats=["csv"])


def test_convert_rephased_matches_jax(tmp_path):
    """convert with a new phase center: the re-phased NPZ within 1e-6 of
    max|V| of JAX's (its phasing runs in float32 where the port's is
    float64)."""
    _, path = _vs(tmp_path)
    kw = dict(formats=["npz"], phase_center=[[80.0, 200.0]])
    a = tools.convert(path, str(tmp_path / "t"), **kw)[0]
    b = tools_j.convert(path, str(tmp_path / "j"), **kw)[0]
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            if np.iscomplexobj(y[k]):
                assert np.abs(x[k] - y[k]).max() <= 1e-6 * np.abs(y[k]).max()


def test_writers_without_h5py_raise_before_compute(tmp_path, monkeypatch):
    """With h5py missing, every path that needs it raises ImportError before
    the input is read; .fits and .npz outputs do not need it."""
    import prisim_tpu_torch.io.hdf5 as hdf5_t
    _, path = _vs(tmp_path)
    monkeypatch.setattr(hdf5_t, "h5py", None)

    def no_read(p):
        raise AssertionError("input read")
    monkeypatch.setattr(tools, "_load_any", no_read)
    calls = [
        lambda: tools.convert(path, str(tmp_path / "c"), ["npz", "hdf5"]),
        lambda: tools.convert(path, str(tmp_path / "c"), ["uvh5"]),
        lambda: tools.update_noise(path, device="cpu"),
        lambda: tools.update_noise(path, str(tmp_path / "n.h5"),
                                   device="cpu"),
        lambda: tools.expand_redundant_file(path, str(tmp_path / "e.hdf5")),
        lambda: tools.feko_to_healpix(path, str(tmp_path / "b.hdf5")),
    ]
    for call in calls:
        with pytest.raises(ImportError, match="h5py"):
            call()
    with pytest.raises(AssertionError, match="input read"):
        tools.expand_redundant_file(path, str(tmp_path / "e.fits"))


@pytest.mark.parametrize("suffix", [".fits", ".npz", ".hdf5"])
def test_update_noise(tmp_path, suffix):
    """update_noise against JAX's: the same rms (Tsys 400 K) and
    skyvis; vis = skyvis + noise; the draws' rms within 5% of it; a
    same-seed repeat bit for bit, another seed differs; Tsys 200 K halves
    the rms; the output read back by its suffix."""
    vs, path = _vs(tmp_path, nchan=256, nacc=4)
    out = str(tmp_path / ("noisy" + suffix))
    got = tools.update_noise(path, out, Tsys=400.0, seed=3, device="cpu")
    ref = tools_j.update_noise(path, str(tmp_path / "j.hdf5"), Tsys=400.0,
                               seed=3)
    np.testing.assert_allclose(got.vis_rms, ref.vis_rms, rtol=1e-15)
    np.testing.assert_array_equal(got.skyvis, ref.skyvis)
    np.testing.assert_allclose(got.vis - got.vis_noise, vs.skyvis, rtol=1e-6)
    rms = np.sqrt(np.mean(np.abs(got.vis_noise) ** 2))
    assert abs(rms / np.asarray(ref.vis_rms).mean() - 1) < NOISE_RMS_BAR
    again = tools.update_noise(path, str(tmp_path / ("b" + suffix)),
                               Tsys=400.0, seed=3, device="cpu")
    np.testing.assert_array_equal(again.vis_noise, got.vis_noise)
    other = tools.update_noise(path, str(tmp_path / ("c" + suffix)),
                               Tsys=400.0, seed=4, device="cpu")
    assert not np.array_equal(other.vis_noise, got.vis_noise)
    half = tools.update_noise(path, str(tmp_path / ("d" + suffix)),
                              Tsys=200.0, seed=3, device="cpu")
    np.testing.assert_allclose(got.vis_rms / half.vis_rms, 2.0, rtol=1e-12)
    back = tools._load_any(out)
    np.testing.assert_array_equal(back.vis_noise, got.vis_noise)
    # the native FITS product holds the float64 sky cube as float32
    np.testing.assert_allclose(back.skyvis, got.skyvis,
                               rtol=1e-6 if suffix == ".fits" else 0)


def test_update_noise_in_place(tmp_path):
    """Without an outfile the input is rewritten, as JAX's does."""
    _, path = _vs(tmp_path)
    got = tools.update_noise(path, Tsys=300.0, seed=1, device="cpu")
    np.testing.assert_array_equal(load_hdf5_j(path).vis, got.vis)


def test_replicate_npz_matches_jax_keys(tmp_path):
    vs, path = _vs(tmp_path, nchan=128, nacc=4)
    got = tools.replicate(path, str(tmp_path / "t"), n_realize=3, seed=100,
                          fmt="npz", device="cpu")
    want = tools_j.replicate(path, str(tmp_path / "j"), n_realize=3,
                             seed=100, fmt="npz")
    with np.load(got[0]) as t, np.load(want[0]) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in ("skyvis", "freqs", "lst", "bl"):
            np.testing.assert_array_equal(t[k], j[k])
        assert t["vis"].shape == j["vis"].shape == (3,) + vs.skyvis.shape
        np.testing.assert_allclose(t["vis"] - t["noise"],
                                   np.broadcast_to(vs.skyvis,
                                                   t["vis"].shape), rtol=1e-6)
        assert not np.array_equal(t["noise"][0], t["noise"][1])
        rms = np.sqrt(np.mean(np.abs(t["noise"]) ** 2))
        want_rms = np.sqrt(np.mean(np.abs(j["noise"]) ** 2))
        assert abs(rms / want_rms - 1) < NOISE_RMS_BAR
        noise = t["noise"]
    again = tools.replicate(path, str(tmp_path / "t2"), n_realize=3,
                            seed=100, device="cpu")
    with np.load(again[0]) as t2:
        np.testing.assert_array_equal(t2["noise"], noise)
    # realization i is seeded from (seed, i): the first two of four are the
    # two of a 2-realization run
    two = tools.replicate(path, str(tmp_path / "t3"), n_realize=2, seed=100,
                          device="cpu")
    with np.load(two[0]) as t3:
        np.testing.assert_array_equal(t3["noise"], noise[:2])
    with pytest.raises(ValueError, match="fmt"):
        tools.replicate(path, str(tmp_path / "x"), fmt="csv", device="cpu")


def test_replicate_uvfits(tmp_path):
    _, path = _vs(tmp_path)
    got = tools.replicate(path, str(tmp_path / "r"), n_realize=2,
                          fmt="uvfits", device="cpu")
    want = tools_j.replicate(path, str(tmp_path / "q"), n_realize=2,
                             fmt="uvfits")
    assert [os.path.basename(p)[1:] for p in got] == \
        [os.path.basename(p)[1:] for p in want]
    with np.load(tools.replicate(path, str(tmp_path / "n"), n_realize=2,
                                 device="cpu")[0]) as d:
        for i, p in enumerate(got):
            back = load_uvfits(p)
            assert back.skyvis.shape == d["vis"][i].shape
            np.testing.assert_allclose(back.skyvis, d["vis"][i], rtol=0,
                                       atol=1e-5 * np.abs(d["vis"]).max())


@pytest.mark.parametrize("suffix", [".hdf5", ".fits", ".npz"])
def test_expand_redundant_matches_jax(tmp_path, suffix):
    vs, path = _vs(tmp_path)
    out = str(tmp_path / ("full" + suffix))
    got = tools.expand_redundant_file(path, out)
    want = tools_j.expand_redundant_file(path, str(tmp_path / "j.hdf5"))
    assert got.nbl == want.nbl == 6
    for name in ("baselines", "skyvis", "Tsys", "bp", "bp_wts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(np.asarray(got.labels, str),
                                  np.asarray(want.labels, str))
    back = tools._load_any(out)
    # the native FITS product holds float32 cubes; the NPZ export holds the
    # cubes (and reference-schema keys) but not the label pairs
    np.testing.assert_allclose(back.skyvis, got.skyvis, rtol=1e-6 if
                               suffix == ".fits" else 0)
    if suffix != ".npz":
        np.testing.assert_array_equal(np.asarray(back.labels, str),
                                      np.asarray(got.labels, str))


def test_expand_redundant_reads_fits(tmp_path):
    """A native FITS product in: the port reads any product (JAX reads
    HDF5 only) and expands it as JAX expands the same sim's HDF5."""
    from prisim_tpu_torch.io import save_fits
    vs, path = _vs(tmp_path)
    fits = str(tmp_path / "sim.fits")
    save_fits(tools._load_any(path), fits)
    got = tools.expand_redundant_file(fits, str(tmp_path / "f.npz"))
    want = tools_j.expand_redundant_file(path, str(tmp_path / "j.hdf5"))
    # the FITS product's float32 cubes
    np.testing.assert_allclose(got.skyvis, np.asarray(want.skyvis),
                               rtol=1e-6)


def _project(root, kind):
    """Two sims' metainfo, written as YAML or as the JSON of the port's
    driver without pyyaml."""
    for name, layout in [("sim1", "HERA-19"), ("sim2", "HERA-37")]:
        d = root / name / "metainfo"
        d.mkdir(parents=True)
        meta = {"array": {"layout": layout, "minR": None},
                "bandpass": {"nchan": 64, "freq": 150e6}}
        with open(d / ("simparms." + kind), "w") as f:
            (yaml.safe_dump if kind == "yaml" else json.dump)(meta, f)
    (root / "not_a_sim").mkdir()
    return str(root)


def test_ls_and_grep_match_jax(tmp_path):
    ydir = _project(tmp_path / "yaml_proj", "yaml")
    jdir = _project(tmp_path / "json_proj", "json")
    want = tools_j.list_sims(ydir)
    assert want["sims"] == ["sim1", "sim2"] and "array.layout" in \
        want["diffs"]
    assert tools.list_sims(ydir) == want == tools.list_sims(jdir)
    assert tools.list_sims(jdir, diff=False) == tools_j.list_sims(
        ydir, diff=False)
    for kv in ({"array.layout": "HERA-37"}, {"bandpass.nchan": "64"},
               {"bandpass.nchan": 64}, {"array.minR": None}):
        assert tools.grep_sims(jdir, **kv) == tools.grep_sims(ydir, **kv) \
            == tools_j.grep_sims(ydir, **kv)


def test_ls_needs_yaml_only_for_yaml(tmp_path, monkeypatch):
    import sys
    ydir = _project(tmp_path / "yaml_proj", "yaml")
    jdir = _project(tmp_path / "json_proj", "json")
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert tools.list_sims(jdir)["sims"] == ["sim1", "sim2"]
    with pytest.raises(ImportError, match="pyyaml"):
        tools.list_sims(ydir)


def _write_feko_file(path, freqs_mhz, ntheta=19, nphi=13, sigma=25.0):
    """tests/test_round3_fixes.py's synthetic FEKO far-field export."""
    th = np.linspace(0.0, 90.0, ntheta)
    ph = np.linspace(0.0, 360.0, nphi)
    with open(path, "w") as f:
        for fm in freqs_mhz:
            f.write(f"#Frequency: {fm * 1e6:.1f}\n")
            f.write(f'"" Theta Samples: {ntheta}\n')
            f.write(f'"" Phi Samples: {nphi}\n')
            sig = sigma * 150.0 / fm
            for p in ph:
                for t in th:
                    g_db = -10.0 * (t / sig) ** 2
                    f.write(f"{t:.4f} {p:.4f} 0.0 0.0 {g_db:.6f}\n")


def _generic_table(path):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        f.write("# theta phi Re(Etheta) Im(Etheta) Re(Ephi) Im(Ephi)\n")
        for _ in range(2000):
            th, phi = rng.uniform(0, np.pi / 2), rng.uniform(0, 2 * np.pi)
            e = np.exp(-(np.degrees(th) / 25.0) ** 2 / 2)
            f.write(f"{np.degrees(th):.4f} {np.degrees(phi):.4f} "
                    f"{e:.6f} 0.0 0.0 0.0\n")


FEKO_CASES = {
    "spline": ("feko", dict(interp="spline")),
    "healpix": ("feko", dict(interp="healpix")),
    "nearest": ("feko", dict(interp="nearest")),
    "generic": ("generic", {}),
    "spline_pol2": ("feko", dict(interp="spline", pol2=True)),
}


@pytest.mark.parametrize("case", sorted(FEKO_CASES))
def test_feko_to_healpix_matches_jax(tmp_path, case):
    kind, kw = FEKO_CASES[case]
    infile = str(tmp_path / "beam.ffe")
    if kind == "feko":
        _write_feko_file(infile, [140.0, 150.0, 160.0])
    else:
        _generic_table(infile)
    if kw.pop("pol2", False):
        _write_feko_file(str(tmp_path / "p2.ffe"), [140.0, 150.0, 160.0],
                         sigma=20.0)
        kw["extra_pol_files"] = (str(tmp_path / "p2.ffe"),)
    want = tools_j.feko_to_healpix(infile, str(tmp_path / "j.hdf5"),
                                   nside=16, **kw)
    peak = np.abs(want).max()
    for suffix in (".hdf5", ".fits", ".npz"):
        out = str(tmp_path / ("t" + suffix))
        got = tools.feko_to_healpix(infile, out, nside=16, **kw)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= FEKO_BAR * peak
        if suffix == ".hdf5":
            _same_hdf5(out, str(tmp_path / "j.hdf5"))
        elif suffix == ".fits":
            eb = ExternalBeam.from_fits(out)
            with h5py.File(str(tmp_path / "j.hdf5"), "r") as f:
                np.testing.assert_array_equal(eb.freqs, f["freqs"][()])
            assert eb.maps.shape == want.shape
            assert np.abs(eb.maps - want).max() <= FEKO_BAR * peak
        else:
            with np.load(out) as d, h5py.File(str(tmp_path / "j.hdf5"),
                                              "r") as f:
                np.testing.assert_array_equal(d["beam"], f["beam"][()])
                np.testing.assert_array_equal(d["freqs"], f["freqs"][()])
                for k in kw.get("extra_pol_files", ()):
                    np.testing.assert_array_equal(d["pols/P2"],
                                                  f["pols/P2"][()])


def test_feko_fits_beam_reads_as_jax_hdf5_beam(tmp_path):
    """The port's FITS beam and JAX's HDF5 beam of one FEKO file evaluate
    alike through the port's ExternalBeam (FITS) and JAX's (HDF5), within
    1e-12 of the peak: the maps, not only their file, are the same."""
    from prisim_tpu.beams.external import ExternalBeam as ExternalBeam_j
    infile = str(tmp_path / "beam.ffe")
    _write_feko_file(infile, [140.0, 150.0, 160.0])
    tools.feko_to_healpix(infile, str(tmp_path / "t.fits"), nside=16)
    tools_j.feko_to_healpix(infile, str(tmp_path / "j.hdf5"), nside=16)
    rng = np.random.default_rng(3)
    altaz = np.stack([rng.uniform(5, 90, 64), rng.uniform(0, 360, 64)], -1)
    chans = np.asarray([142e6, 155e6])
    a = ExternalBeam.from_fits(str(tmp_path / "t.fits")).evaluate(altaz,
                                                                   chans)
    b = ExternalBeam_j.from_hdf5(str(tmp_path / "j.hdf5")).evaluate(altaz,
                                                                    chans)
    assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-12


def test_read_feko_matches_jax(tmp_path):
    infile = str(tmp_path / "beam.ffe")
    _write_feko_file(infile, [145.0, 155.0], ntheta=10, nphi=7)
    for a, b in zip(tools.read_feko(infile), tools_j.read_feko(infile)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no FEKO"):
        tools.read_feko(EXAMPLE_YAML)


def test_gsm_raises_without_pygsm():
    for mod in ("pygdsm", "pygsm"):
        try:
            __import__(mod)
            pytest.skip("%s installed; the gate is not exercised" % mod)
        except ImportError:
            pass
    with pytest.raises(RuntimeError, match="pygsm"):
        tools.gsm_to_npz("unused.npz", nside=8, freqs=[150e6])
    np.testing.assert_array_equal(tools._EQ2GAL, tools_j._EQ2GAL)


def test_plot_sim(tmp_path):
    """plot_sim on a native FITS product writes the driver's figures."""
    pytest.importorskip("matplotlib")
    from prisim_tpu_torch.io import save_fits
    _, path = _vs(tmp_path)
    fits = str(tmp_path / "sim.fits")
    save_fits(tools._load_any(path), fits)
    figdir = tools.plot_sim(fits, str(tmp_path / "plots"))
    assert sorted(os.listdir(figdir)) == ["amp_vs_baseline.png",
                                          "vis_waterfall.png"]


def test_mesh_check_and_bench_on_cpu(capsys):
    assert tools.mesh_check(4, device="cpu")
    assert "mesh of 4 x cpu devices (1 distinct): psum OK" in \
        capsys.readouterr().out
    rows = tools.mesh_bench(n_devices=2, per_bl=4, nchan=8, nside=4,
                            repeats=1, platform="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert r["nbl"] == 4 * r["devices"] and r["platform"] == "cpu"
        assert r["gmacs_per_device"] >= 0 and r["distinct_devices"] == 1
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    with pytest.raises(SystemExit) as e:
        tools.main(["mesh-check", "-n", "4", "--platform", "cpu"])
    assert e.value.code == 0


class _Parsed(Exception):
    pass


def _namespace(main, argv, monkeypatch):
    """The namespace `main` parses from argv (caught at parse_args)."""
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(orig(self, args, namespace))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as e:
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", orig)
    return vars(e.value.args[0])


ARGVS = [
    ["convert", "in.hdf5", "out"],
    ["convert", "in.hdf5", "out", "--formats", "npz", "uvfits",
     "--datatype", "noisy"],
    ["update-noise", "in.hdf5"],
    ["update-noise", "in.hdf5", "-o", "o.hdf5", "--tsys", "300",
     "--a-eff", "100", "--seed", "5"],
    ["replicate", "in.hdf5", "pre", "-n", "3", "--seed", "7", "--fmt",
     "uvfits"],
    ["redundant", "in.hdf5", "out.hdf5"],
    ["ls", "proj"],
    ["grep", "proj", "array.layout=HERA-19", "bandpass.nchan=64"],
    ["delay-ps", "in.hdf5", "dps.hdf5"],
    ["delay-ps", "in.hdf5", "dps.hdf5", "--pad", "2", "--nside-beam", "8",
     "--clean", "--subband-centers", "150e6", "152e6", "--subband-bw",
     "1e6"],
    ["closure-npz", "in.hdf5", "cp.npz", "--datatype", "skyvis"],
    ["xcpdps", "cp.npz", "ps.hdf5"],
    ["xcpdps", "cp.npz", "ps.hdf5", "--freq-center", "150e6",
     "--bw-eff", "1e6", "--pad", "2", "--lstbin", "0.2", "--ndaybins", "3",
     "--num-kbins", "4", "--errinfo", "--rescale-vis", "sim.hdf5",
     "--rescale-triad", "0", "1", "2", "--cohax", "2", "--incohax", "1",
     "3", "--collapse-axes", "3", "--avgcov", "--lst-shifts", "0", "1"],
    ["plot", "in.hdf5", "figs"],
    ["mesh-check"],
    ["mesh-check", "-n", "4", "--bench", "--per-bl", "8", "--nchan", "16",
     "--nside", "4", "--pallas", "--platform", "cpu"],
    ["feko2hpx", "b.ffe", "b.hdf5"],
    ["feko2hpx", "b.ffe", "b.hdf5", "--nside", "32", "--gain-db-col", "4",
     "--interp", "healpix", "--pol2", "p2.ffe"],
    ["gsm", "--freqs", "150e6,160e6", "-o", "g.npz"],
    ["gsm", "--nside", "32", "--freqs", "150e6", "--model", "gsm2016", "-o",
     "g.npz"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "-".join(a[:1] + [
    str(len(a))]))
def test_cli_namespace_matches_jax(argv, monkeypatch):
    got = _namespace(tools.main, argv, monkeypatch)
    want = _namespace(tools_j.main, argv, monkeypatch)
    device = got.pop("device", None)
    assert got == want
    computes = argv[0] in ("update-noise", "replicate", "delay-ps",
                           "mesh-check")
    assert device == ("cuda" if computes else None)
    if computes:
        assert _namespace(tools.main, argv + ["--device", "cpu"],
                          monkeypatch)["device"] == "cpu"


def test_cli_runs_on_cpu(tmp_path, capsys):
    """A few subcommands end to end through main with --device cpu."""
    _, path = _vs(tmp_path)
    tools.main(["update-noise", path, "-o", str(tmp_path / "n.fits"),
                "--tsys", "250", "--device", "cpu"])
    tools.main(["replicate", str(tmp_path / "n.fits"), str(tmp_path / "r"),
                "-n", "2", "--device", "cpu"])
    tools.main(["redundant", str(tmp_path / "n.fits"),
                str(tmp_path / "full.npz")])
    tools.main(["convert", str(tmp_path / "full.npz"), str(tmp_path / "c"),
                "--formats", "uvfits"])
    out = capsys.readouterr().out
    assert "noise updated" in out and "expanded to 6 baselines" in out
    assert os.path.exists(str(tmp_path / "r.npz"))
    assert load_uvfits(str(tmp_path / "c.uvfits")).nbl == 6


def test_altsim_round_trip_matches_jax(tmp_path):
    """parms_to_pyuvsim writes the same three files as JAX's, and
    pyuvsim_to_parms reads them back to the same parameters."""
    src = {"telescope": {"id": "hera", "latitude": -30.72,
                         "longitude": 21.43, "altitude": 1050.0},
           "array": {"layout": "HERA-7"},
           "bandpass": {"nchan": 16, "freq": 155e6,
                        "freq_resolution": 97656.25},
           "obsparm": {"n_acc": 3, "t_acc": 11.0}}
    obs_t = altsim_t.parms_to_pyuvsim(cfg_t.load_parms(copy.deepcopy(src)),
                                      str(tmp_path / "t"))
    obs_j = altsim_j.parms_to_pyuvsim(cfg_j.load_parms(copy.deepcopy(src)),
                                      str(tmp_path / "j"))
    for name in ("obsparam.yaml", "telescope_config.yaml", "layout.csv"):
        assert open(os.path.join(os.path.dirname(obs_t), name)).read() == \
            open(os.path.join(os.path.dirname(obs_j), name)).read(), name
    back_t = altsim_t.pyuvsim_to_parms(obs_t)
    back_j = altsim_j.pyuvsim_to_parms(obs_j)
    back_t["array"].pop("file")
    back_j["array"].pop("file")
    assert back_t == back_j
    assert back_t["bandpass"]["nchan"] == 16


def test_altsim_without_yaml_raises_before_work(tmp_path, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        altsim_t.parms_to_pyuvsim(cfg_t.load_parms({}), str(tmp_path / "x"))
    assert not os.path.exists(str(tmp_path / "x"))
    with pytest.raises(ImportError):
        altsim_t.pyuvsim_to_parms(str(tmp_path / "obsparam.yaml"))


def test_example_parms_match_jax_yaml():
    """The example's PARMS, through the port's load_parms, equal
    hera19_random.yaml through the reference's."""
    got = cfg_t.load_parms(copy.deepcopy(full_pipeline.PARMS))
    want = cfg_j.load_parms(os.path.abspath(EXAMPLE_YAML))
    assert got == want


def test_products_of_a_port_run_through_the_tools(tmp_path):
    """A HERA-7 run of the port saved as native FITS, then convert,
    update_noise, expand_redundant_file and list_sims on its products, as
    the card phase runs them: the FITS read back equals the run, the
    expansion covers all 21 pairs, and ls lists the run."""
    from prisim_tpu_torch.driver import run_simulation
    p = cfg_t.load_parms({
        "dirstruct": {"rootdir": str(tmp_path), "project": "proj",
                      "simid": "a"},
        "telescope": {"id": "hera", "Trx": 100.0},
        "array": {"layout": "HERA-7", "redundant": True},
        "bandpass": {"nchan": 16, "freq_resolution": 390625.0},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "usm", "nside": 4},
        "save_formats": {"fmt": "fits", "npz": False}})
    vs, out = run_simulation(p, verbose=False, device="cpu")
    fits = os.path.join(out, "simdata", "simvis.fits")
    conv = tools.convert(fits, str(tmp_path / "c"), ["npz", "uvfits"])
    np.testing.assert_array_equal(load_npz(conv[0]).skyvis, vs.skyvis)
    assert load_uvfits(conv[1]).skyvis.shape == vs.skyvis.shape
    full = tools.expand_redundant_file(fits, str(tmp_path / "full.fits"))
    assert full.nbl == 21
    assert load_fits(str(tmp_path / "full.fits")).nbl == 21
    noisy = tools.update_noise(fits, str(tmp_path / "n.fits"), seed=2,
                               device="cpu")
    np.testing.assert_array_equal(noisy.skyvis, vs.skyvis)
    assert tools.list_sims(str(tmp_path / "proj"))["sims"] == ["a"]
    assert tools.grep_sims(str(tmp_path / "proj"),
                           **{"array.layout": "HERA-7"}) == ["a"]
    assert dataclasses.is_dataclass(noisy)
