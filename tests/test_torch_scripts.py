"""The port's card scripts, chip_smoke.py and profile_banded.py, off the
card: they import neither jax nor the JAX package themselves, and they
exit non-zero with no result line when no CUDA card is visible. The
profiler's device busy time is the union of the device events' intervals.
chip_smoke's north-star run (phase p) takes hera331_northstar.yaml's
sections, and the phase runs on the CPU at a small size, as do phase q
(kernel airy_amps against the torch chain), phase r (kernel banded_prep
against the torch chain) and phase n's split of the sorted snapshot by
its spans."""

import ast
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCRIPTS = ["chip_smoke.py", "profile_banded.py"]


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_imports_no_jax(script):
    tops = {n.split(".")[0] for n in _imported(os.path.join(ROOT, script))}
    assert "prisim_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "prisim_tpu"}, tops


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_fails_without_cuda(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA card" in proc.stderr


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 2.0), (3.0, 4.0)], 3.0),            # disjoint
    ([(0.0, 2.0), (1.0, 4.0), (3.5, 5.0)], 5.0),  # chained overlaps
    ([(5.0, 6.0), (0.0, 10.0), (2.0, 3.0)], 10.0),  # nested, unsorted
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),            # touching
])
def test_busy_us_is_union_length(spans, want):
    sys.path.insert(0, ROOT)
    try:
        from profile_banded import busy_us
    finally:
        sys.path.remove(ROOT)
    assert busy_us(spans) == want


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_northstar_run_parms_are_the_yaml(tmp_path):
    """Phase p's parameters equal load_parms of hera331_northstar.yaml
    (all 100 accumulations, processing at its defaults: engine auto) but
    for save_formats (native FITS, no NPZ: the card has no h5py) and
    dirstruct.rootdir."""
    from prisim_tpu_torch.config import load_parms
    got = _chip_smoke().northstar_run_parms(str(tmp_path))
    want = load_parms(os.path.join(ROOT, "prisim_tpu", "examples",
                                   "simparms", "hera331_northstar.yaml"))
    assert got["dirstruct"]["rootdir"] == str(tmp_path)
    assert (got["save_formats"]["fmt"], got["save_formats"]["npz"]) == \
        ("fits", False)
    assert want["obsparm"]["n_acc"] == 100
    assert want["processing"]["engine"] == "auto"
    a, b = copy.deepcopy(got), copy.deepcopy(want)
    for x in (a, b):
        del x["save_formats"], x["dirstruct"]["rootdir"]
    assert a == b


def test_northstar_run_phase_on_cpu(tmp_path, monkeypatch):
    """Phase p on the CPU at a small size (HERA-19, 128 channels, nside 8,
    2 accumulations): the CUDA calls stubbed, engine auto taken to the
    banded engine and the plain NUDFT and K2 calls counted as launches, as
    a card counts them. It holds the run to K1a on the model amps, checks
    the launch counts and reads the FITS product back."""
    cs = _chip_smoke()
    from prisim_tpu_torch import driver
    from prisim_tpu_torch.engine import (cuda_banded, cuda_nudft,
                                         nufft_banded, observe)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)

    def counted(fn, counter):
        def wrapper(*a, **k):
            counter.launches += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(observe, "nudft_visibilities", counted(
        observe.nudft_visibilities, cuda_nudft.nudft_cuda))
    monkeypatch.setattr(nufft_banded, "_spread", counted(
        nufft_banded._spread, cuda_banded.banded_spread_cuda))
    resolve = driver._resolve_engine
    monkeypatch.setattr(driver, "_resolve_engine", lambda parms, dev: (
        "nufft" if (parms["processing"].get("engine") or "auto") == "auto"
        else resolve(parms, dev)))
    full = cs.northstar_run_parms

    def small(rootdir):
        p = full(rootdir)
        p["array"]["layout"] = "HERA-19"
        p["bandpass"]["nchan"] = 128
        p["skyparm"]["nside"] = 8
        p["obsparm"]["n_acc"] = 2
        return p

    monkeypatch.setattr(cs, "northstar_run_parms", small)
    got = cs.northstar_run_phase(str(tmp_path), torch.device("cpu"))
    assert got == dict(k1a=2, k1b=0, k1c=0, k2=3, spread=0)
    assert not os.listdir(tmp_path)          # the run's directory is gone


def test_airy_amps_phase_on_cpu(monkeypatch):
    """Phase q on the CPU at small shapes: the slice's beam (HERA about its
    default orientation), airy_amps_cuda replaced by a counting copy of
    the torch chain, the CUDA timer stubbed. The tables agree, one launch
    is checked per shape, the bound counts the rows above the horizon;
    a table one ulp off fails the phase."""
    cs = _chip_smoke()
    from prisim_tpu_torch import config, driver
    from prisim_tpu_torch.beams.analytic import airy_beam
    from prisim_tpu_torch.engine import cuda_beam
    cpu = torch.device("cpu")
    telescope = driver._telescope(config.load_parms(
        {"telescope": {"id": "hera"}}))
    freqs = np.linspace(100e6, 200e6, 64)
    beam_fn = driver._make_beam_fn({"beam": {}}, telescope, freqs)

    def fake(s, flux, dia, f, axis=None):
        fake.launches += 1
        pb = airy_beam(s, f, dia, pointing_dircos=axis)
        out = torch.where((s[:, 2] > 0.0)[:, None], pb * flux,
                          torch.zeros_like(flux))
        if fake.off:
            out[7, 3] = torch.nextafter(out[7, 3], torch.tensor(1e9))
        return out

    fake.launches, fake.off = 0, False
    monkeypatch.setattr(cuda_beam, "airy_amps_cuda", fake)
    monkeypatch.setattr(cs, "cuda_time_ms", lambda fn: (fn(), 1.0)[1])
    shapes = ((300, 64), (97, 13))
    got = cs.airy_amps_phase(beam_fn, freqs, cpu, shapes=shapes)
    assert fake.launches == 2 * 3            # checked once, timed twice
    assert got["shape"] == (300, 64) and got["max_abs_err"] == 0.0
    assert [r["shape"] for r in got["shapes"]] == list(shapes)
    for (S, C), r in zip(shapes, got["shapes"]):
        pick = np.linspace(0, 63, C).round().astype(int)
        s, _ = cs.airy_rows(S, freqs[pick], 14.0, cpu)
        live = int((s[:, 2] > 0).sum())
        assert r["live"] == live and 0 < live < S
        assert r["bound_ms"] == pytest.approx(
            (live * C * 4 + S * C * 4 + S * 12 + C * 4) / 3.35e12 * 1e3,
            rel=1e-12)
    fake.off = True
    with pytest.raises(SystemExit, match="differs"):
        cs.airy_amps_phase(beam_fn, freqs, cpu, shapes=shapes[:1])


@pytest.mark.parametrize("src_chunk", [None, 2500])
def test_banded_prep_phase_on_cpu(monkeypatch, src_chunk):
    """Phase r on the CPU at a small size (HERA-19, 256 channels, nside 16:
    rank 16 with the truth amps of HERA's Airy dish), banded_prep_cuda
    replaced by a counting copy of the chain, the CUDA timer stubbed: every
    chunk's outputs agree (one chunk of 3,072 sources padded to 4,096, or
    2 of 2,500 that the tile pads),
    one launch a chunk is checked, the bound counts the u streams, the
    vectors, the payload rows and the node fluxes; a u stream one ulp off
    fails the phase, as does a run with no Airy truth payload."""
    cs = _chip_smoke()
    from prisim_tpu_torch import driver
    from prisim_tpu_torch.engine import cuda_prep
    from prisim_tpu_torch.engine import nufft_banded as nb
    cpu = torch.device("cpu")

    def fake(*a, **k):
        fake.launches += 1
        out = nb.banded_prep_plain(*a, **k)
        if fake.off:
            out[0][0, 7] = torch.nextafter(out[0][0, 7], torch.tensor(9.0))
        return out

    fake.launches, fake.off = 0, False
    monkeypatch.setattr(cuda_prep, "banded_prep_cuda", fake)
    monkeypatch.setattr(cs, "cuda_time_ms", lambda fn: (fn(), 1.0)[1])
    if src_chunk:
        make = nb.make_banded_snapshot_fns
        monkeypatch.setattr(driver, "make_banded_snapshot_fns", lambda *a, **k:
                            make(*a, **dict(k, src_chunk=src_chunk)))
    parms = cs.northstar_parms(array={"layout": "HERA-19"},
                               bandpass={"nchan": 256},
                               skyparm={"nside": 16})
    got = cs.banded_prep_phase("small", parms, cpu)
    n = 2 if src_chunk else 1
    assert got["launches"] == fake.launches == n * (1 + 2)
    assert got["max_abs_err"] == 0.0 and got["ms"] == got["plain_ms"] == 1.0
    sim = driver.prepare_simulation(parms, cpu)
    plan, run = driver.banded_engine(parms, sim)
    assert plan.rank == 16 and run.truth and run.n_chunks == n
    assert sim.sky.flux.shape[0] == 3072
    S_c = run.src_chunk          # whole tiles, or the given chunk
    assert S_c == (src_chunk or 4096)
    S_pad = -(-S_c // plan.T_s) * plan.T_s
    want = n * (8 * plan.ndir * S_pad + 24 * S_c + 8 * 16 * (S_pad + S_c))
    assert got["bound_ms"] == pytest.approx(want / 3.35e12 * 1e3, rel=1e-12)
    fake.off = True
    with pytest.raises(SystemExit, match="differs"):
        cs.banded_prep_phase("small", parms, cpu)
    fake.off = False
    with pytest.raises(SystemExit, match="no Airy payload"):
        cs.banded_prep_phase("small", cs.northstar_parms(
            array={"layout": "HERA-19"}, bandpass={"nchan": 256},
            skyparm={"nside": 16}, processing={"nufft_truth_amps": False}),
            cpu)


def test_snapshot_span_ms_on_cpu():
    """Phase n's split of the north-star sorted snapshot by its spans, on a
    small sorted snapshot on the CPU: the six spans are found (their stream
    times exist on a card only and read 0 here); a snapshot without them
    fails the check."""
    cs = _chip_smoke()
    from prisim_tpu_torch import config, driver
    from prisim_tpu_torch.engine import nufft_delay as nd
    from prisim_tpu_torch.engine.observe import schedule_tensors
    cpu = torch.device("cpu")
    parms = config.load_parms({
        "array": {"layout": "HERA-7", "redundant": True},
        "bandpass": {"freq": 150e6, "freq_resolution": 100e6 / 32,
                     "nchan": 32},
        "skyparm": {"model": "usm", "nside": 8},
        "obsparm": {"obs_mode": "drift", "n_acc": 1, "t_acc": 60.0},
        "processing": {"engine": "nufft", "nufft_spread": "sorted"}})
    sim = driver.prepare_simulation(parms, cpu)
    sched = [a[0] for a in schedule_tensors(sim.obs, sim.inst.latitude, cpu)]
    pinvQ, Q = nd.chebyshev_projection(sim.freqs, 16)

    def snap():
        return nd.simulate_snapshot_nufft_jit(sim.inst, sim.sky, *sched,
                                              sim.beam_fn, pinvQ, Q)
    by, total = cs.snapshot_span_ms(snap, cpu)
    assert sorted(by) == sorted(cs.SNAPSHOT_SPANS)
    assert total == 0.0 and not any(by.values())
    with pytest.raises(SystemExit, match="sorted snapshot spans"):
        cs.snapshot_span_ms(lambda: None, cpu)


def test_finalize_phase_on_cpu(monkeypatch):
    """Phase s on the CPU at small shapes: phase_cubes_cuda replaced by a
    counting copy of its twin, the CUDA timers stubbed. The cubes agree with the host path within the bar, one
    launch is checked per shape, the bound counts three cubes read and
    written with the path and channel factors; a cube 5 ulps off fails
    the phase."""
    cs = _chip_smoke()
    from prisim_tpu_torch.engine import cuda_finalize

    def fake(*a, **k):
        fake.launches += 1
        out = cuda_finalize.phase_cubes_plain(*a, **k)
        if fake.off:
            out[1, 2, 3, 0] += 5 * np.spacing(np.float32(abs(
                complex(out[1, 2, 3, 0]))))
        return out

    fake.launches, fake.off = 0, False
    monkeypatch.setattr(cuda_finalize, "phase_cubes_cuda", fake)
    monkeypatch.setattr(cs, "cuda_time_ms", lambda fn: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "copy_to_host_ms", lambda out: 2.0)
    shapes = ((5, 21, 64), (3, 4, 33))
    got = cs.finalize_phase(torch.device("cpu"), shapes=shapes)
    assert fake.launches == 3 * len(shapes)      # checked once, timed twice
    assert [r["shape"] for r in got["shapes"]] == list(shapes)
    for (T, B, C), r in zip(shapes, got["shapes"]):
        assert r["ulps"] <= cs.FINALIZE_ULPS and r["ms"] == 1.0
        assert r["copy_ms"] == 2.0
        assert r["bound_ms"] == pytest.approx(
            (48 * T * B * C + 8 * B * T + 8 * C) / 3.35e12 * 1e3, rel=1e-12)
    fake.off = True
    with pytest.raises(SystemExit, match="differs"):
        cs.finalize_phase(torch.device("cpu"), shapes=shapes[:1])


def test_plan_phase_on_cpu(monkeypatch):
    """Phase t on the CPU at a small size (HERA-19, 256 channels, nside 16:
    3,072 sources of a precessed sky, rank 16, truth amps): the torch
    order is numpy's with no row from the host, the node fluxes within 2
    ulps, the host path's snapshot the card path's bit for bit; an order
    that swaps two sources fails the phase."""
    cs = _chip_smoke()
    from prisim_tpu_torch.engine import nufft_banded as nb
    cpu = torch.device("cpu")
    parms = cs.northstar_parms(array={"layout": "HERA-19"},
                               bandpass={"nchan": 256},
                               skyparm={"nside": 16})
    got = cs.plan_phase(cpu, parms, repeats=1)
    assert got["S"] == 3072 and got["differ"] == 0 and got["n_host"] == 0
    assert got["ulps"] <= 2.0 and got["snap_err"] == 0.0
    assert set(got["wall"]) == {"card", "host"}
    order = nb.spatial_order

    def swapped(*a, **k):
        perm, n = order(*a, **k)
        return perm[torch.tensor([1, 0] + list(range(2, perm.numel())))], n

    monkeypatch.setattr(nb, "spatial_order", swapped)
    with pytest.raises(SystemExit, match="differs"):
        cs.plan_phase(cpu, parms, repeats=1)
