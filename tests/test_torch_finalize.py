"""The finalize's card route on the CPU: kernel phase_cubes's plain twin
(engine/cuda_finalize.phase_cubes_plain) against vis.phase_centering and
the host's transpose, the wrapper's checks, the route choice, and the whole
card route of driver._finalize_simulation driven on the CPU with the twin
in place of the kernel, against the host route."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from prisim_tpu_torch import driver as drv
from prisim_tpu_torch.config import load_parms
from prisim_tpu_torch.engine import cuda_finalize
from prisim_tpu_torch.vis import (VisibilitySet, phase_centering, phase_path,
                                  project_baselines)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# off zenith the twin (and the kernel) land within 2 float32 ulps of |V|
# of the exact product of the cubes and their float32 angle's phasor
# (phase_cubes_exact); the host's float32 cos and sin are an ulp or two
# off it, so the two routes agree within twice that
ULPS = 2.0
HOST_ULPS = 2 * ULPS
# the cells' zenith centre and two off-zenith centres
CENTRES = {"zenith": ([90.0, 270.0], "altaz"),
           "altaz_off": ([62.5, 131.0], "altaz"),
           "radec_off": ([17.0, -30.7224], "radec")}


def ulps(got, want, dtype=np.float32):
    """The largest difference of a real or an imaginary part, in ulps of
    |want| in `dtype` (float32 by default)."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.maximum(np.abs(got.real - want.real), np.abs(got.imag - want.imag))
    return float((d / np.spacing(np.abs(want).astype(dtype))).max())


def _cubes(T, B, C, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.complex(torch.randn(T, B, C, generator=g),
                          torch.randn(T, B, C, generator=g))
            for _ in range(3)]


def _container(B, C, T, seed=1):
    """A VisibilitySet without cubes: baselines up to 876 m, the band of
    the north star, a drift scan's LSTs, pointing and phase centre at
    zenith."""
    rng = np.random.RandomState(seed)
    bl = rng.uniform(-1.0, 1.0, (B, 3)) * [1.0, 1.0, 0.02]
    bl *= 876.0 / np.linalg.norm(bl, axis=1).max()
    zen = np.tile([90.0, 270.0], (T, 1))
    return VisibilitySet(
        baselines=bl, labels=np.zeros((B, 2), str),
        freqs=100e6 + 97656.25 * np.arange(C) * (1024 // C),
        lst=40.0 + 0.25 * np.arange(T), latitude=-30.7224,
        pointing_center=zen, phase_center=zen.copy())


@pytest.mark.parametrize("centre", sorted(CENTRES))
def test_twin_matches_phase_centering(centre):
    """phase_cubes_plain on random (T, B, C) complex64 cubes against the
    host's transpose and phase_centering: bit for bit at the zenith
    centre (a zero path); off zenith, where the cycle counts reach
    hundreds, within 2 ulps of |V| of the exact product and 4 of the
    host's."""
    T, B, C = 5, 19, 64
    sky, vis, noise = _cubes(T, B, C)
    vs = _container(B, C, T)
    host = [np.ascontiguousarray(x.numpy().transpose(1, 2, 0))
            for x in (sky, vis, noise)]
    vs = VisibilitySet(**{**vs.__dict__, "skyvis": host[0], "vis": host[1],
                          "vis_noise": host[2]})
    center, coords = CENTRES[centre]
    want = phase_centering(vs, np.atleast_2d(center), coords)
    path = phase_path(vs, np.atleast_2d(center), coords)
    cyc = np.abs(path).max() * vs.freqs.max() / 299792458.0
    assert (cyc == 0.0) if centre == "zenith" else cyc > 100.0
    args = (sky, vis, noise, torch.as_tensor(path), torch.as_tensor(vs.freqs))
    got = cuda_finalize.phase_cubes_plain(*args)
    exact = cuda_finalize.phase_cubes_exact(*args).numpy()
    assert got.shape == (3, B, C, T) and got.dtype == torch.complex64
    for k, name in enumerate(("skyvis", "vis", "vis_noise")):
        w = getattr(want, name)
        if centre == "zenith":
            np.testing.assert_array_equal(got[k].numpy(), w)
        else:
            assert ulps(got[k].numpy(), exact[k]) <= ULPS, name
            assert ulps(w, exact[k]) <= HOST_ULPS, name
            assert ulps(got[k].numpy(), w) <= HOST_ULPS, name


def test_twin_without_a_path_is_the_transpose():
    sky, vis, noise = _cubes(3, 4, 5)
    got = cuda_finalize.phase_cubes_plain(sky, vis, noise)
    assert got.is_contiguous()
    for k, x in enumerate((sky, vis, noise)):
        assert torch.equal(got[k], x.permute(1, 2, 0))


@pytest.mark.parametrize("centre", sorted(CENTRES))
def test_wide_twin_matches_phase_centering(centre):
    """With vis complex128 (a gains file's), phase_cubes_plain widens the
    other two cubes and takes phase_centering's np.exp branch: the
    argument ((-2 pi path) nu) (1 / c) is the host's bit for bit, so the
    cubes are the host's bit for bit about zenith and, elsewhere, within 4
    float64 ulps of |V| (torch's cos and sin against numpy's)."""
    T, B, C = 5, 19, 64
    sky, vis, noise = _cubes(T, B, C)
    vis = vis * torch.complex(torch.rand(T, B, C, dtype=torch.float64),
                              torch.rand(T, B, C, dtype=torch.float64))
    vs = _container(B, C, T)
    host = [np.ascontiguousarray(x.numpy().transpose(1, 2, 0))
            for x in (sky, vis, noise)]
    vs = VisibilitySet(**{**vs.__dict__, "skyvis": host[0], "vis": host[1],
                          "vis_noise": host[2]})
    center, coords = CENTRES[centre]
    want = phase_centering(vs, np.atleast_2d(center), coords)
    path = phase_path(vs, np.atleast_2d(center), coords)
    got = cuda_finalize.phase_cubes_plain(
        sky, vis, noise, torch.as_tensor(path), torch.as_tensor(vs.freqs))
    assert got.shape == (3, B, C, T) and got.dtype == torch.complex128
    for k, name in enumerate(("skyvis", "vis", "vis_noise")):
        w = getattr(want, name)
        assert w.dtype == np.complex128
        if centre == "zenith":
            np.testing.assert_array_equal(got[k].numpy(), w)
        else:
            assert ulps(got[k].numpy(), w, np.float64) <= 4.0, name


def _bad_cases():
    def base():
        sky, vis, noise = _cubes(3, 4, 5)
        return dict(skyvis=sky, vis=vis, noise=noise,
                    path=torch.zeros(4, 3, dtype=torch.float64),
                    freqs=torch.zeros(5, dtype=torch.float64))

    def spoil(**kw):
        return lambda: {**base(), **kw}

    sky = _cubes(3, 4, 5)[0]
    return {
        "cpu_tensors": (ValueError, base),
        "cpu_tensors_no_path": (ValueError, spoil(path=None, freqs=None)),
        "not_a_tensor": (TypeError, spoil(vis=sky.numpy())),
        "real_cube": (TypeError, spoil(noise=sky.real.contiguous())),
        "cube_shape": (ValueError, spoil(vis=sky[:, :, :4].contiguous())),
        "not_3d": (ValueError, spoil(skyvis=sky[0])),
        "not_contiguous": (ValueError,
                           spoil(vis=sky.transpose(1, 2).contiguous()
                                 .transpose(1, 2))),
        "lone_path": (ValueError, spoil(freqs=None)),
        "path_shape": (ValueError,
                       spoil(path=torch.zeros(3, 4, dtype=torch.float64))),
        "path_dtype": (TypeError, spoil(path=torch.zeros(4, 3))),
        "freqs_shape": (ValueError,
                        spoil(freqs=torch.zeros(4, dtype=torch.float64))),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_phase_cubes_cuda_rejects_bad_inputs(case):
    """Each bad input raises before any launch, CPU tensors included (the
    wrapper runs on CUDA tensors only)."""
    exc, make = _bad_cases()[case]
    n0 = cuda_finalize.phase_cubes_cuda.launches
    with pytest.raises(exc):
        cuda_finalize.phase_cubes_cuda(**make())
    assert cuda_finalize.phase_cubes_cuda.launches == n0


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_a_cpu_cube_takes_the_host_route(monkeypatch, dtype):
    """A CPU cube finalizes on the host whatever its dtype, without asking
    for the kernel library."""
    def no(*a):
        raise AssertionError("the library was asked for")
    monkeypatch.setattr(cuda_finalize, "_library", no)
    assert not drv._finalize_on_card(torch.zeros((2, 3, 4), dtype=dtype))


def test_a_cuda_cube_whose_library_fails_raises(monkeypatch):
    """A CUDA cube takes the card route, and a kernel library that fails
    to build raises there: no quiet fall back to the host."""
    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(cuda_finalize, "_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        drv._finalize_on_card(SimpleNamespace(is_cuda=True))
    monkeypatch.setattr(cuda_finalize, "_library", lambda: None)
    assert drv._finalize_on_card(SimpleNamespace(is_cuda=True))


_SECTIONS = {
    "telescope": {"id": "custom"},
    "bandpass": {"nchan": 32, "freq": 150e6, "freq_resolution": 3.125e6},
    "array": {"layout": "HERA-7", "redundant": False},
    "obsparm": {"n_acc": 3, "t_acc": 60.0},
    "skyparm": {"model": "random", "nsrc": 128, "seed": 5},
    "processing": {"engine": "direct"},
    "save_formats": {"fmt": "none", "npz": False},
}


def _parms(centre=None, **sections):
    sec = dict(_SECTIONS, **sections)
    sec["phasing"] = ({"center": None} if centre is None else
                      {"center": CENTRES[centre][0],
                       "coords": CENTRES[centre][1]})
    return load_parms(sec)


def _run(parms):
    vs, _ = drv.run_simulation(parms, verbose=False, save=False,
                               device="cpu")
    return vs


@pytest.mark.parametrize("centre", sorted(CENTRES))
def test_host_run_phases_as_phase_centering(centre):
    """run_simulation on the CPU (the host route) returns what
    phase_centering and project_baselines make of the same run unphased,
    byte for byte."""
    got = _run(_parms(centre))
    raw = _run(_parms())
    center, coords = CENTRES[centre]
    want = project_baselines(phase_centering(
        raw, np.atleast_2d(np.asarray(center, np.float64)), coords))
    for name in ("skyvis", "vis", "vis_noise", "vis_rms", "Tsys", "bp",
                 "bp_wts", "lst", "projected_baselines", "phase_center"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert got.phase_center_coords == coords


class _CardOnCpu:
    """The card route of _finalize_simulation on the CPU: the route forced
    on, the twin counted in place of the kernel, and a fixed noise cube
    handed out in the order each route draws it ((T, B, C) from an rms
    tensor on the card route, (B, C, T) from the host's array)."""

    def __init__(self, monkeypatch, shape, card=True, seed=7):
        g = torch.Generator().manual_seed(seed)
        self.noise = torch.complex(torch.randn(shape, generator=g),
                                   torch.randn(shape, generator=g))
        self.launches = 0
        self.rms = []
        monkeypatch.setattr(drv, "generate_noise", self.draw)
        if card:
            monkeypatch.setattr(drv, "_finalize_on_card", lambda v: True)
            monkeypatch.setattr(cuda_finalize, "phase_cubes_cuda",
                                self.kernel)

    def draw(self, gen, rms):
        self.rms.append(rms)
        if isinstance(rms, torch.Tensor):
            assert rms.is_contiguous() and rms.dtype == torch.float32
            return self.noise.permute(2, 0, 1).contiguous()
        return self.noise.clone()

    def kernel(self, *a, **k):
        self.launches += 1
        return cuda_finalize.phase_cubes_plain(*a, **k)


@pytest.mark.parametrize("centre", [None] + sorted(CENTRES))
def test_card_route_matches_the_host_route(monkeypatch, centre):
    """The card route (noise drawn and gains applied in the cube's order,
    the twin once, one copy) against the host route on the same run with
    the same noise: the three cubes bit for bit at zenith and unphased,
    within 4 ulps of |V| off zenith; everything else byte-identical; the
    rms handed to the draw is the host's, transposed to (T, B, C)."""
    parms = _parms(centre)
    shape = (21, 32, 3)
    host = _CardOnCpu(monkeypatch, shape, card=False)
    want = _run(parms)
    monkeypatch.undo()
    card = _CardOnCpu(monkeypatch, shape)
    got = _run(parms)
    assert card.launches == 1 and host.launches == 0
    np.testing.assert_array_equal(
        card.rms[0].numpy(),
        np.asarray(host.rms[0], np.float32).transpose(2, 0, 1))
    for name in ("skyvis", "vis", "vis_noise"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.complex64 and a.shape == b.shape
        if centre in (None, "zenith"):
            assert a.tobytes() == b.tobytes(), name
        else:
            assert ulps(a, b) <= HOST_ULPS, name
    for name in ("vis_rms", "Tsys", "bp", "bp_wts", "lst",
                 "projected_baselines", "phase_center"):
        a, b = getattr(got, name), getattr(want, name)
        if a is None or b is None:
            assert a is b is None, name
        else:
            assert a.tobytes() == b.tobytes(), name
    assert got.phase_center_coords == want.phase_center_coords


@pytest.mark.parametrize("fault", ["noise_dropped", "noise_doubled",
                                   "noise_not_added"])
def test_noise_faults_reach_the_card_route(monkeypatch, fault):
    """Each noise fault of gpubench/faults.py, planted through the
    driver's generate_noise and apply_gains, changes what the card route
    returns."""
    from gpubench import faults
    parms = _parms("zenith")
    _CardOnCpu(monkeypatch, (21, 32, 3))
    clean = _run(parms)
    undo = faults.plant(fault)
    try:
        bad = _run(parms)
    finally:
        undo()
    changed = ("vis",) if fault == "noise_not_added" else ("vis",
                                                           "vis_noise")
    for name in ("skyvis", "vis", "vis_noise"):
        same = np.array_equal(getattr(bad, name), getattr(clean, name))
        assert same == (name not in changed), name


def test_card_route_seeds_its_draw_as_the_host(monkeypatch):
    """The card route draws with a generator on the cube's device, seeded
    as the host's is (a chunk from its SeedSequence seed)."""
    seen = []
    real = drv._noise_generator

    def spy(parms, device="cpu"):
        gen = real(parms, device)
        seen.append((torch.device(device), gen.initial_seed()))
        return gen
    monkeypatch.setattr(drv, "_noise_generator", spy)
    _CardOnCpu(monkeypatch, (21, 32, 3))
    _run(_parms("zenith"))
    parms = _parms("zenith")
    parms["pp"] = dict(parms.get("pp") or {}, _chunk={"index": 2})
    _run(parms)
    (d0, s0), (d1, s1) = seen
    assert d0 == d1 == torch.device("cpu") and s0 == 5
    assert s1 == int(np.random.SeedSequence([5, 2]).generate_state(
        1, np.uint64)[0])


class _Gains:
    """A gains file's reader: complex128 per-baseline gains (B, C, T)."""

    def __init__(self, shape):
        rng = np.random.RandomState(4)
        self.g = 1.0 + 0.1 * (rng.randn(*shape) + 1j * rng.randn(*shape))

    def read_hdf5(self, path):
        return self

    def eval_gains(self, labels, **kw):
        return self.g.copy()


@pytest.mark.parametrize("centre", [None, "zenith", "altaz_off"])
def test_card_route_with_gains_matches_the_host_route(monkeypatch, centre):
    """A gains file's complex128 gains make vis complex128: the card route
    applies them on the device in the cube's order and launches the twin's
    complex128 branch once. Phased, the three cubes come back complex128
    as phase_centering makes them: bit for bit about zenith, elsewhere
    within 4 float64 ulps of |V| of the host's (numpy's cos and sin, the
    twin's torch ones, an ulp or two apart); unphased, each keeps its
    dtype, bit for bit."""
    parms = _parms(centre)
    parms["gains"] = dict(parms.get("gains") or {}, file="gains.hdf5")
    shape = (21, 32, 3)
    monkeypatch.setattr(drv, "GainInfo", _Gains(shape))
    _CardOnCpu(monkeypatch, shape, card=False)
    want = _run(parms)
    card = _CardOnCpu(monkeypatch, shape)
    got = _run(parms)
    assert card.launches == 1
    assert want.vis.dtype == got.vis.dtype == np.complex128
    for name in ("skyvis", "vis", "vis_noise"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if centre is not None:
            assert a.dtype == np.complex128, name
        if centre in (None, "zenith"):
            np.testing.assert_array_equal(a, b)
        else:
            assert ulps(a, b, np.float64) <= 4.0, name
