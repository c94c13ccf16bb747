"""Chunked execution with checkpoint/resume in the port
(driver.run_simulation_chunked: NPZ part files + vis.concatenate), its
repairs (the full-band bandpass of a frequency chunk, per-chunk noise
seeds) and the diagnosis section, on the CPU: the cases of
tests/test_chunked.py run on the port, and the port's chunked runs against
prisim_tpu's on HERA-7 x 16 channels.

Tolerances: skyvis within 2e-6 of max|V| of the single-shot run and of
JAX's chunked run (the f32 engines' bar); the bandpass equal; the noise,
which cannot match JAX's threefry draw value for value (ROADMAP R4), by
its rms against the radiometer rms and by same-seed repeats."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from prisim_tpu import driver as drv_j
from prisim_tpu.config import load_parms as load_parms_j
from prisim_tpu_torch import driver as drv_t
from prisim_tpu_torch.config import load_parms
from prisim_tpu_torch.driver import run_simulation, run_simulation_chunked

BAR = 2e-6


def _parms(tmp_path, n_chunks, key="freq", cleanup=0, loader=load_parms):
    return loader({
        "dirstruct": {"rootdir": str(tmp_path), "project": "p",
                      "simid": "chunked"},
        "bandpass": {"nchan": 16, "freq": 155e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 4, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 24, "seed": 6},
        "pp": {"key": key, "n_chunks": n_chunks},
        "processing": {"cleanup": cleanup},
        "save_formats": {"npz": False},
    })


def _chunked(parms, **kw):
    return run_simulation_chunked(parms, device="cpu", **kw)


@pytest.mark.parametrize("key,axis", [("freq", 1), ("bl", 2)])
def test_chunked_matches_single_shot(tmp_path, key, axis):
    vs, outdir = _chunked(_parms(tmp_path, 2, key=key), verbose=False)
    single, _ = run_simulation(_parms(tmp_path / "s", 1), verbose=False,
                               save=False, device="cpu")
    assert vs.skyvis.shape == single.skyvis.shape
    scale = np.abs(single.skyvis).max()
    assert np.abs(vs.skyvis - single.skyvis).max() / scale < BAR
    for name in ("freqs", "lst", "timestamps", "baselines", "bp", "bp_wts",
                 "vis_rms"):
        np.testing.assert_array_equal(getattr(vs, name),
                                      getattr(single, name), err_msg=name)
    # part files kept with cleanup=0
    assert os.path.exists(os.path.join(outdir, "simdata", "_part_0.npz"))


@pytest.mark.parametrize("key", ["freq", "time"])
def test_chunked_matches_jax_chunked(tmp_path, key):
    """The port's chunked run against prisim_tpu's on the same parameters:
    skyvis within 2e-6 of max|V|, bandpass and axes equal, the saved
    products written under the same names."""
    vs_j, dir_j = drv_j.run_simulation_chunked(
        _parms(tmp_path / "j", 2, key=key, loader=load_parms_j),
        verbose=False)
    vs_t, dir_t = _chunked(_parms(tmp_path / "t", 2, key=key),
                           verbose=False)
    scale = np.abs(np.asarray(vs_j.skyvis)).max()
    assert np.abs(vs_t.skyvis - np.asarray(vs_j.skyvis)).max() / scale \
        < BAR
    for name in ("freqs", "lst", "bp", "bp_wts"):
        np.testing.assert_array_equal(getattr(vs_t, name),
                                      np.asarray(getattr(vs_j, name)),
                                      err_msg=name)
    assert sorted(os.listdir(os.path.join(dir_t, "simdata"))) == sorted(
        f.replace(".hdf5", ".npz") if f.startswith("_part") else f
        for f in os.listdir(os.path.join(dir_j, "simdata")))


def test_resume_skips_existing_parts(tmp_path, capsys):
    parms = _parms(tmp_path, 2)
    vs1, outdir = _chunked(parms, verbose=False)
    # corrupt nothing; re-run -> both parts skipped, same result
    vs2, _ = _chunked(parms, outdir=outdir, verbose=True)
    out = capsys.readouterr().out
    assert out.count("resume: part") == 2
    np.testing.assert_allclose(vs2.skyvis, vs1.skyvis)


def test_resume_reruns_only_missing_part(tmp_path, capsys):
    """A run cut after part 0: part 0 is read back untouched (its mtime
    stays), part 1 is simulated again with its own noise seed, and the
    merged product equals the first run's, noise included."""
    parms = _parms(tmp_path, 2)
    vs1, outdir = _chunked(parms, verbose=False)
    p0 = os.path.join(outdir, "simdata", "_part_0.npz")
    p1 = os.path.join(outdir, "simdata", "_part_1.npz")
    t0 = os.stat(p0).st_mtime_ns
    os.remove(p1)
    vs2, _ = _chunked(parms, outdir=outdir, verbose=True)
    out = capsys.readouterr().out
    assert out.count("resume: part") == 1 and os.path.exists(p1)
    assert os.stat(p0).st_mtime_ns == t0
    for name in ("skyvis", "vis", "vis_noise"):
        np.testing.assert_array_equal(getattr(vs2, name),
                                      getattr(vs1, name), err_msg=name)


def test_cleanup_removes_parts(tmp_path):
    vs, outdir = _chunked(_parms(tmp_path, 2, cleanup=1), verbose=False)
    assert not os.path.exists(os.path.join(outdir, "simdata",
                                           "_part_0.npz"))
    assert os.path.exists(os.path.join(outdir, "simdata",
                                       "simvis.hdf5"))
    meta = os.path.join(outdir, "metainfo", "chunkinfo")
    if os.path.exists(meta + ".yaml"):
        import yaml
        with open(meta + ".yaml") as f:
            info = yaml.safe_load(f)
    else:
        with open(meta + ".json") as f:
            info = json.load(f)
    assert info["parts"] == ["_part_0.npz", "_part_1.npz"]
    assert info["chunk_edges"] == [0, 8, 16]


def test_chunked_noise_independent_per_chunk(tmp_path):
    """Equal-size chunks must NOT repeat the same thermal-noise block: each
    chunk seeds its generator from (seed, chunk index), so the two
    frequency halves draw their own noise; each half's rms matches the
    radiometer rms, and the same seed repeats the same draws."""
    parms = _parms(tmp_path, 2)
    parms["telescope"]["Tsys"] = 200.0
    vs, _ = _chunked(parms, verbose=False)
    n = np.asarray(vs.vis_noise)
    half = n.shape[1] // 2
    a, b = n[:, :half, :], n[:, half:, :]
    assert np.abs(a - b).max() > 1e-6 * np.abs(a).max()
    rms = np.asarray(vs.vis_rms)
    for part, r in ((a, rms[:, :half]), (b, rms[:, half:])):
        got = np.sqrt(np.mean(np.abs(part) ** 2))
        # 21 x 8 x 4 complex samples: the rms within 15% (~6 sigma)
        assert abs(got / np.sqrt(np.mean(r ** 2)) - 1.0) < 0.15
    again, _ = _chunked(_parms(tmp_path / "again", 2) | {
        "telescope": dict(parms["telescope"])}, verbose=False)
    np.testing.assert_array_equal(again.vis_noise, vs.vis_noise)
    single, _ = run_simulation(parms, verbose=False, save=False,
                               device="cpu")
    assert not np.array_equal(single.vis_noise[:, :half], a)


def test_chunked_bandpass_global_flags(tmp_path):
    """flags.flag_chan indices are FULL-BAND channel indices; edge flags
    apply to the full band only (run_prisim.py:898-981). A 2-chunk run
    must flag the same channels as the single-shot run, and as JAX's."""
    def with_flags(p):
        p["flags"]["flag_chan"] = [9]       # inside chunk 1 (chans 8-15)
        p["flags"]["n_edge_flag"] = [2, 1]
        p["processing"]["bpass_shape"] = "bhw"
        return p
    vs, _ = _chunked(with_flags(_parms(tmp_path, 2)), verbose=False)
    single, _ = run_simulation(with_flags(_parms(tmp_path / "s", 1)),
                               verbose=False, save=False, device="cpu")
    np.testing.assert_allclose(vs.bp, single.bp)
    np.testing.assert_allclose(vs.bp_wts, single.bp_wts, rtol=1e-12)
    # sanity: chunk-local edges were NOT flagged (chans 6,7 stay alive)
    assert vs.bp[0, 6, 0] == 1.0 and vs.bp[0, 7, 0] == 1.0
    assert vs.bp[0, 9, 0] == 0.0
    assert vs.bp[0, 0, 0] == 0.0 and vs.bp[0, 15, 0] == 0.0
    # the chunk's own weights against JAX's _bandpass_weights
    p1 = with_flags(_parms(tmp_path, 1))
    p1["pp"]["_chunk"] = {"index": 1, "axis": 1, "chan0": 8,
                          "nchan_total": 16}
    freqs = drv_t.build_frequencies(_parms(tmp_path, 1))[8:]
    for got, want in zip(drv_t._bandpass_weights(p1, 21, freqs, 4),
                         drv_j._bandpass_weights(p1, 21, freqs, 4)):
        np.testing.assert_array_equal(got, want)


def test_chunked_delay_transform_recomputed(tmp_path):
    """Merged chunked runs recompute the delay transform over the full
    band (concatenate drops partial-band lag products)."""
    from prisim_tpu_torch.vis import delay_transform
    parms = _parms(tmp_path, 2)
    parms["processing"]["delay_transform"] = True
    vs, _ = _chunked(parms, verbose=False)
    assert vs.lags is not None and vs.skyvis_lag is not None
    assert vs.lags.size == 16
    golden = delay_transform(vs, device="cpu")
    np.testing.assert_allclose(np.asarray(vs.skyvis_lag),
                               np.asarray(golden.skyvis_lag),
                               rtol=1e-5, atol=1e-8)


def test_part_file_round_trip(tmp_path):
    """A part file gives back every field of the run, of the same type,
    arrays bit for bit (telescope, layout and blgroups dicts included)."""
    import dataclasses
    from prisim_tpu_torch.io.parts import load_part_npz, save_part_npz
    from prisim_tpu_torch.tools import _load_any
    p = _parms(tmp_path, 1)
    p["array"]["redundant"] = True
    vs, _ = run_simulation(p, verbose=False, save=False, device="cpu")
    path = str(tmp_path / "_part_0.npz")
    save_part_npz(vs, path)
    for back in (load_part_npz(path), _load_any(path)):
        for f in dataclasses.fields(vs):
            a, b = getattr(back, f.name), getattr(vs, f.name)
            assert type(a) is type(b), f.name
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert repr(a) == repr(b), f.name
    with np.load(path, allow_pickle=False) as d:
        assert all(d[k].dtype.kind != "O" for k in d.files)


def test_cli_runs_chunked(tmp_path, monkeypatch):
    """The CLI's main takes the chunked branch for pp.n_chunks > 1."""
    seen = {}
    monkeypatch.setattr(drv_t, "run_simulation_chunked",
                        lambda parms, **kw: seen.update(kw, chunked=True))
    monkeypatch.setattr(drv_t, "load_parms", lambda path: _parms(tmp_path,
                                                                 2))
    drv_t.main(["-i", "x.yaml", "-q", "--device", "cpu"])
    assert seen == dict(chunked=True, outdir=None, verbose=False,
                        device="cpu")


def test_chunked_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_simulation_chunked(_parms(tmp_path, 2), verbose=False)
    assert not os.path.exists(os.path.join(str(tmp_path), "p"))


# -- diagnosis ---------------------------------------------------------------

def test_jax_profile_writes_torch_trace(tmp_path):
    """diagnosis.jax_profile: a torch.profiler chrome trace of the run."""
    parms = _parms(tmp_path, 1)
    prof = str(tmp_path / "prof")
    parms["diagnosis"]["jax_profile"] = prof
    run_simulation(parms, verbose=False, save=False, device="cpu")
    (name,) = [n for n in os.listdir(prof) if n.startswith("trace_")]
    with open(os.path.join(prof, name)) as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0


def test_resource_monitor_writes_rows(tmp_path):
    pytest.importorskip("psutil")
    parms = _parms(tmp_path, 1)
    parms["diagnosis"]["resource_monitor"] = True
    parms["diagnosis"]["refresh_interval"] = 0.05
    run_simulation(parms, verbose=False, save=False, device="cpu")
    with open(os.path.join(str(tmp_path), "resource_monitor.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows and all({"t", "cpu_percent", "rss_bytes"} <= set(r)
                        for r in rows)
    # the CPU has no device memory to read
    assert not any("device_bytes_in_use" in r for r in rows)


def test_resource_monitor_without_psutil_raises_before_compute(
        tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "psutil", None)

    def no_compute(*a, **k):
        raise AssertionError("compute reached")
    monkeypatch.setattr(drv_t, "prepare_simulation", no_compute)
    parms = _parms(tmp_path, 1)
    parms["diagnosis"]["resource_monitor"] = True
    with pytest.raises(ImportError):
        run_simulation(parms, verbose=False, save=False, device="cpu")


def test_resource_monitor_thread_failure_is_raised(tmp_path):
    """An error inside the sampling thread is raised by stop(), not lost."""
    pytest.importorskip("psutil")
    from prisim_tpu_torch.diagnostics import ResourceMonitor
    mon = ResourceMonitor(str(tmp_path / "no_dir" / "mon.jsonl"),
                          interval=0.01)
    mon.start()
    mon._thread.join(timeout=5.0)
    with pytest.raises(RuntimeError, match="resource monitor failed"):
        mon.stop()
