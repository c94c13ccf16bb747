"""Kernels K1a, K1b, K1c, K2 and delay_spread on the card against their
plain PyTorch versions (and the NUDFT kernels against the f64 golden).
Every test here needs a CUDA card and skips without one; run them on the
card, from the repo root, with

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports jax, which these tests do not
need.)
"""

import numpy as np
import pytest
import torch

from prisim_tpu_torch import twofloat as tf
from prisim_tpu_torch.engine import nufft_banded as nb
from prisim_tpu_torch.engine.cuda_banded import (banded_spread_cuda,
                                                banded_worklist_cuda)
from prisim_tpu_torch.engine.cuda_nudft import nudft_cuda
from prisim_tpu_torch.engine.nudft import (freq_grid_scalars,
                                           nudft_reference_f64,
                                           nudft_visibilities)

# f32 engines against the f64 golden and each other: the bar of
# tests/test_pallas_nudft.py (max|dV| / max|V|).
BAR = 2e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(S, B, C, seed, bl_scale):
    rng = np.random.RandomState(seed)
    s = rng.randn(S, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    s[:, 2] = np.abs(s[:, 2])
    se = s - np.asarray([0.0, 0.0, 1.0])
    bl = rng.randn(B, 3) * bl_scale
    amps = rng.rand(S, C).astype(np.float32)
    return se, bl, amps


@pytest.mark.gpu
@pytest.mark.parametrize("S,B,C,chan0,bl_scale", [
    (53, 13, 24, 0, 200.0),        # ragged S, B and C
    (100, 37, 48, 7, 200.0),       # chan0 != 0
    (40, 8, 16, 0, 3000.0),        # ~2000 phase cycles: frac reduction
    (4096, 64, 1024, 0, 300.0),    # one full channel tile, many tiles of S
    (300, 5, 1500, 0, 200.0),      # two channel tiles, ragged second
])
def test_k1a_matches_plain_and_golden(cuda, S, B, C, chan0, bl_scale):
    se, bl, amps = _problem(S, B, C, seed=S + B + C, bl_scale=bl_scale)
    nu0, dnu = 150e6, 97656.25
    freqs = nu0 + dnu * (chan0 + np.arange(C))
    seh, sel = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(se))
    blh, bll = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(bl))
    a = torch.as_tensor(amps, device=cuda)
    gs = freq_grid_scalars(nu0, dnu)
    n0 = nudft_cuda.launches
    got = nudft_cuda(seh, sel, blh, bll, a, gs, C, chan0=chan0)
    torch.cuda.synchronize()
    assert nudft_cuda.launches == n0 + 1
    plain = nudft_visibilities(seh, sel, blh, bll, a, gs, C, chan0=chan0)
    gold = nudft_reference_f64(torch.as_tensor(se, device=cuda),
                               torch.as_tensor(bl, device=cuda), a,
                               torch.as_tensor(freqs, device=cuda))
    got, plain, gold = (x.cpu().numpy() for x in (got, plain, gold))
    assert got.shape == (B, C) and np.isfinite(got).all()
    scale = np.abs(gold).max()
    assert np.abs(got - plain).max() / scale < BAR
    assert np.abs(got - gold).max() / scale < BAR


@pytest.mark.gpu
@pytest.mark.parametrize("anchor", [1, 4, 16, 32])
def test_k1a_anchor_periods_match_plain_and_golden(cuda, anchor):
    """K1a at other phasor chain lengths against the plain version on the
    same chains and the f64 golden; and rows of zero amplitude (a third of
    the sources, as below the horizon), which K1a does not visit, change
    nothing beyond the bar."""
    S, B, C = 3000, 50, 1024
    se, bl, amps = _problem(S, B, C, seed=anchor, bl_scale=300.0)
    amps[np.random.RandomState(anchor).rand(S) < 0.33] = 0.0
    nu0, dnu = 150e6, 97656.25
    seh, sel = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(se))
    blh, bll = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(bl))
    a = torch.as_tensor(amps, device=cuda)
    gs = freq_grid_scalars(nu0, dnu)
    got = nudft_cuda(seh, sel, blh, bll, a, gs, C, anchor=anchor)
    again = nudft_cuda(seh, sel, blh, bll, a, gs, C, anchor=anchor)
    plain = nudft_visibilities(seh, sel, blh, bll, a, gs, C, anchor=anchor)
    gold = nudft_reference_f64(torch.as_tensor(se, device=cuda),
                               torch.as_tensor(bl, device=cuda), a,
                               torch.as_tensor(nu0 + dnu * np.arange(C),
                                               device=cuda))
    assert torch.equal(got, again)
    got, plain, gold = (x.cpu().numpy() for x in (got, plain, gold))
    scale = np.abs(gold).max()
    assert np.abs(got - plain).max() / scale < BAR
    assert np.abs(got - gold).max() / scale < BAR


# K1b/K1c against their plain version: both sum in float64 from the same
# float32 weights (the kernel pins the plain version's roundings), so they
# agree to the complex64 rounding of the output; an f32 sum would read
# ~1e-6 (PERF.md). Against the golden: the bars of
# tests/test_pallas_nudft.py.
PLAIN_BAR = 1e-7
GRAD_BAR = 5e-6
EXT_BAR = 3e-6


@pytest.mark.gpu
@pytest.mark.parametrize("anchor", [4, 16, 32])
@pytest.mark.parametrize("mode", ["grad", "ext", "both"])
@pytest.mark.parametrize("S,B,C,chan0,bl_scale", [
    (53, 13, 24, 0, 200.0),        # ragged S, B and C
    (100, 37, 48, 7, 200.0),       # chan0 != 0
    (40, 8, 16, 0, 3000.0),        # long baselines: weights down to ~0
    (2048, 24, 1024, 0, 300.0),    # full channel tiles, many tiles of S
    (300, 5, 1500, 0, 200.0),      # ragged last channel tile
    (40000, 6, 1024, 0, 300.0),    # many sources, few baselines: splits
])
def test_k1b_k1c_match_plain_and_golden(cuda, mode, S, B, C, chan0,
                                        bl_scale, anchor):
    """K1b, K1c and both at once against the plain version on the same
    phasor chains and the f64 golden, at chain lengths 4, 16 and 32, with
    a third of the sources given zero amplitudes (as below the horizon;
    the kernels do not visit them, and must read s_sky and sigma of the
    sources they do visit through the same order); two launches are
    bit-identical."""
    grad, ext = {"grad": (True, False), "ext": (False, True),
                 "both": (True, True)}[mode]
    se, bl, amps = _problem(S, B, C, seed=S + B + C, bl_scale=bl_scale)
    rng = np.random.RandomState(S)
    sigma = rng.uniform(20.0, 200.0, S).astype(np.float32)
    sigma[::3] = np.inf
    amps[rng.rand(S) < 0.33] = 0.0
    nu0, dnu = 150e6, 97656.25
    freqs = nu0 + dnu * (chan0 + np.arange(C))
    seh, sel = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(se))
    blh, bll = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(bl))
    kw = dict(s_sky=torch.as_tensor((se + [0.0, 0.0, 1.0]).astype(np.float32),
                                    device=cuda),
              src_shape_sigma=torch.as_tensor(sigma, device=cuda)
              if ext else None, gradient=grad, anchor=anchor)
    a = torch.as_tensor(amps, device=cuda)
    gs = freq_grid_scalars(nu0, dnu)
    n0 = (nudft_cuda.launches, nudft_cuda.launches_grad,
          nudft_cuda.launches_ext)
    got = nudft_cuda(seh, sel, blh, bll, a, gs, C, chan0=chan0, **kw)
    torch.cuda.synchronize()
    assert (nudft_cuda.launches, nudft_cuda.launches_grad,
            nudft_cuda.launches_ext) == (n0[0], n0[1] + grad, n0[2] + ext)
    if S == 40000:
        assert nudft_cuda.last_splits > 1
    again = nudft_cuda(seh, sel, blh, bll, a, gs, C, chan0=chan0, **kw)
    plain = nudft_visibilities(seh, sel, blh, bll, a, gs, C, chan0=chan0,
                               **kw)
    del kw["anchor"]
    gold = nudft_reference_f64(torch.as_tensor(se, device=cuda),
                               torch.as_tensor(bl, device=cuda), a,
                               torch.as_tensor(freqs, device=cuda), **kw)
    if not grad:
        got, again, plain, gold = (got,), (again,), (plain,), (gold,)
    for i, (k, k2, p, g) in enumerate(zip(got, again, plain, gold)):
        assert torch.equal(k, k2)
        k, p, g = (x.cpu().numpy() for x in (k, p, g))
        assert k.shape == ((B, C) if i == 0 else (3, B, C))
        assert np.isfinite(k).all()
        scale = np.abs(g).max()
        bar = GRAD_BAR if i else (EXT_BAR if ext else BAR)
        assert np.abs(k - p).max() / scale < PLAIN_BAR
        assert np.abs(k - g).max() / scale < bar


@pytest.mark.gpu
def test_k1a_rejects_bad_inputs(cuda):
    se, bl, amps = _problem(8, 3, 16, seed=0, bl_scale=100.0)
    seh, sel = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(se))
    blh, bll = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(bl))
    gs = freq_grid_scalars(150e6, 1e5)
    with pytest.raises(TypeError):
        nudft_cuda(seh.double(), sel, blh, bll,
                   torch.as_tensor(amps, device=cuda), gs, 16)
    with pytest.raises(ValueError):
        nudft_cuda(seh, sel, blh.cpu(), bll,
                   torch.as_tensor(amps, device=cuda), gs, 16)
    with pytest.raises(ValueError):
        nudft_cuda(seh, sel, blh, bll,
                   torch.as_tensor(amps[:, :8], device=cuda), gs, 16)


@pytest.mark.gpu
def test_run_simulation_cuda_matches_cpu(cuda, tmp_path):
    """The whole slice on the card (K1a) against the same run on the CPU
    (plain versions): HERA-7, 32 channels, nside-8 sky, 2 accumulations."""
    from prisim_tpu_torch.config import load_parms
    from prisim_tpu_torch.driver import run_simulation
    parms = load_parms({
        "dirstruct": {"rootdir": str(tmp_path)},
        "telescope": {"id": "hera"},
        "array": {"layout": "HERA-7", "redundant": False},
        "bandpass": {"nchan": 32, "freq_resolution": 97656.25},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "usm", "nside": 8},
        "processing": {"engine": "direct"},
        "save_formats": {"fmt": "none", "npz": True}})
    n0 = nudft_cuda.launches
    vs_gpu, _ = run_simulation(parms, verbose=False, device="cuda")
    assert nudft_cuda.launches == n0 + 2
    vs_cpu, _ = run_simulation(parms, verbose=False, save=False,
                               device="cpu")
    scale = np.abs(vs_cpu.skyvis).max()
    assert np.abs(vs_gpu.skyvis - vs_cpu.skyvis).max() / scale < BAR
    # the card draws its noise with a CUDA generator of the same seed, in
    # the engine's (T, B, C) order, and phases it about zenith
    from prisim_tpu_torch.engine.noise import generate_noise
    rms = torch.as_tensor(vs_cpu.vis_rms.astype(np.float32), device=cuda)
    want = generate_noise(
        torch.Generator(device=cuda).manual_seed(100),
        rms.permute(2, 0, 1).contiguous()).permute(1, 2, 0).cpu().numpy()
    assert _ulps(vs_gpu.vis_noise, want) <= FINALIZE_ULPS
    np.testing.assert_array_equal(vs_gpu.vis_rms, vs_cpu.vis_rms)


@pytest.mark.gpu
@pytest.mark.parametrize("key", ["freq", "bl", "src"])
def test_direct_mesh_on_one_card_matches_single_device(cuda, key):
    """A 2-shard mesh on one card, devices=[cuda:0] * 2: K1a on each shard
    (2 launches an accumulation; chan0 = 16 on the second freq shard),
    against the single-device run on the card, within 1e-6 of max|V|: the
    same float64 sums, split across the grid in another number of source
    splits (or across two src shards) before their complex64 rounding."""
    from prisim_tpu_torch.config import load_parms
    from prisim_tpu_torch.driver import run_simulation

    def parms(k):
        return load_parms({
            "telescope": {"id": "hera"},
            "array": {"layout": "HERA-7", "redundant": False},
            "bandpass": {"nchan": 32, "freq_resolution": 97656.25},
            "obsparm": {"n_acc": 2, "t_acc": 60.0},
            "skyparm": {"model": "usm", "nside": 8},
            "processing": {"engine": "direct"}, "pp": {"key": k},
            "save_formats": {"fmt": "none", "npz": False}})
    one, _ = run_simulation(parms("none"), verbose=False, save=False,
                            device="cuda:0")
    n0 = nudft_cuda.launches
    two, _ = run_simulation(parms(key), verbose=False, save=False,
                            devices=["cuda:0"] * 2)
    assert nudft_cuda.launches == n0 + 4
    scale = np.abs(one.skyvis).max()
    d = np.abs(two.skyvis - one.skyvis).max() / scale
    assert d <= 1e-6, d


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["gradient", "dsm_fits"])
def test_shaped_and_gradient_runs_cuda_match_cpu(cuda, tmp_path, case):
    """A gradient run (K1b) and a DSM FITS run (K1c), each with engine auto,
    on the card against the same run on the CPU (plain versions): HERA-7,
    32 channels, nside-8 sky, 2 accumulations; K2 never runs."""
    from prisim_tpu_torch.catalogs import write_dsm_fits
    from prisim_tpu_torch.config import load_parms
    from prisim_tpu_torch.driver import run_simulation
    from prisim_tpu_torch.engine.cuda_banded import banded_spread_cuda
    sky, cat, proc = {"model": "usm", "nside": 8}, {}, {"engine": "auto"}
    if case == "gradient":
        proc["gradient_mode"] = "baseline"
    else:
        path = str(tmp_path / "dsm.fits")
        write_dsm_fits(path, 100.0 + 10.0 * np.random.RandomState(0).rand(
            12 * 8 * 8), -2.55)
        sky, cat = {"model": "dsm", "nside": 8}, {"DSM_file_prefix": path}
    parms = load_parms({
        "dirstruct": {"rootdir": str(tmp_path)},
        "telescope": {"id": "hera"},
        "array": {"layout": "HERA-7", "redundant": False},
        "bandpass": {"nchan": 32, "freq_resolution": 97656.25},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": sky, "catalog": cat, "processing": proc,
        "save_formats": {"fmt": "none", "npz": False}})
    n0 = (nudft_cuda.launches, nudft_cuda.launches_grad,
          nudft_cuda.launches_ext, banded_spread_cuda.launches)
    vs_gpu, _ = run_simulation(parms, verbose=False, save=False,
                               device="cuda")
    grad = case == "gradient"
    assert (nudft_cuda.launches, nudft_cuda.launches_grad,
            nudft_cuda.launches_ext, banded_spread_cuda.launches) == (
                n0[0], n0[1] + 2 * grad, n0[2] + 2 * (not grad), n0[3])
    vs_cpu, _ = run_simulation(parms, verbose=False, save=False,
                               device="cpu")
    # the f32 beam (and the weights' expf) round differently on the card
    # and on the CPU, so the runs agree at the engines' bars, not bit for
    # bit (as test_run_simulation_cuda_matches_cpu)
    scale = np.abs(vs_cpu.skyvis).max()
    assert np.abs(vs_gpu.skyvis - vs_cpu.skyvis).max() / scale < (
        BAR if grad else EXT_BAR)
    if grad:
        g, c = vs_gpu.gradients["baseline"], vs_cpu.gradients["baseline"]
        assert g.shape == (3, 21, 32, 2)
        assert np.abs(g - c).max() / np.abs(c).max() < GRAD_BAR


def _banded_problem(bl, C, r, S, T_s, seed, cuda, dtype=torch.float64):
    plan = nb.make_banded_plan(np.asarray(bl, np.float64), 150e6, 97656.25,
                               C, rank=r, T_s=T_s)
    rng = np.random.RandomState(seed)
    s = rng.randn(S, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    s[:, 2] = np.abs(s[:, 2])
    seh, sel = (torch.as_tensor(x, device=cuda)
                for x in tf.split_f64(s - np.asarray([0.0, 0.0, 1.0])))
    P = torch.as_tensor(rng.rand(S, r), dtype=dtype, device=cuda)
    return plan, nb._prep(plan, seh, sel, P)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "beyond_smem", "f32_payload",
                                  "wide_rank"])
def test_k2_matches_plain(cuda, case):
    """K2 against banded_spread_plain on the same prep outputs: 1e-12 of
    max|rows| (both sum in float64, in another order), and bit-equal from
    one launch to the next. beyond_smem: 300-1000 m baselines give rows of
    R_max x 2r doubles far past one block's 227 KB of shared memory."""
    rng = np.random.RandomState(0)
    bl, C, r, S, T_s = {
        "ragged": (rng.uniform(-60, 60, (12, 3)), 64, 6, 300, 128),
        "beyond_smem": ([[300.0, 10.0, 0.0], [-1000.0, 40.0, 1.0],
                         [14.6, 0.0, 0.0]], 1024, 32, 5000, 2048),
        "f32_payload": (rng.uniform(-80, 80, (40, 3)), 256, 16, 3000, 256),
        "wide_rank": (rng.uniform(-40, 40, (5, 3)), 128, 40, 700, 256),
    }[case]
    plan, (u_h, u_l, P_r, ok) = _banded_problem(
        bl, C, r, S, T_s, seed=len(case), cuda=cuda,
        dtype=torch.float32 if case == "f32_payload" else torch.float64)
    if case == "beyond_smem":
        assert plan.R_max * 2 * r * 8 > 232448
    n0 = banded_spread_cuda.launches
    cached = len(plan.__dict__.get("_on_device", {}))      # _prep's
    got = banded_spread_cuda(plan, u_h, u_l, P_r)
    again = banded_spread_cuda(plan, u_h, u_l, P_r)
    torch.cuda.synchronize()
    assert banded_spread_cuda.launches == n0 + 2
    want = nb.banded_spread_plain(plan, u_h, u_l, P_r)
    assert bool(ok) and got.shape == (plan.nbl, plan.R_max, 2 * r)
    assert torch.equal(got, again)
    assert len(plan._on_device) == cached + 6   # K2's tables, once
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) / scale < 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["north_star_like", "dead_sources"])
def test_k2_worklist_matches_plain(cuda, case):
    """K2's worklist passes on the card against banded_worklist_plain:
    urange, counts, offsets and tiles equal; the spread over it agrees with
    the plain rows to 1e-12. dead_sources: payload columns of zero (a
    third of the sources) make no tile live and change no row."""
    rng = np.random.RandomState(1)
    bl = np.concatenate([rng.uniform(-300, 300, (30, 3)) * [1, 1, 0.01],
                         [[14.6, 0.0, 0.0]]])
    plan, (u_h, u_l, P_r, _) = _banded_problem(bl, 1024, 32, 20000, 2048,
                                               seed=2, cuda=cuda)
    if case == "dead_sources":
        P_r[:, torch.as_tensor(rng.rand(P_r.shape[1]) < 0.33,
                               device=cuda)] = 0.0
    got = banded_worklist_cuda(plan, u_h, u_l, P_r)
    live = (P_r != 0).any(dim=0).to(torch.uint8)
    want = nb.banded_worklist_plain(plan, u_h.reshape(-1), live)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    rows = banded_spread_cuda(plan, u_h, u_l, P_r)
    assert torch.equal(banded_spread_cuda.last_counts, want[1])
    plain = nb.banded_spread_plain(plan, u_h, u_l, P_r)
    scale = float(plain.abs().max())
    assert float((rows - plain).abs().max()) / scale < 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["north_star_like", "dead_sources"])
def test_span_counters_match_the_kernels_own_counts(cuda, case):
    """With the recorder on, a K2 launch counts k2.tiles and k2.items_live
    equal to the sum and the live count of banded_worklist_cuda's counts,
    k2.items equal to B x n_rb (every item of the worklist),
    and src.live equal to the sources with a payload; a K1a launch counts
    src.live equal to live_order's n_live; the spans record the launches
    and their stream milliseconds."""
    from prisim_tpu_torch import tracing
    from prisim_tpu_torch._build import load_kernel_library
    from prisim_tpu_torch.engine.cuda_nudft import live_order
    rng = np.random.RandomState(1)
    bl = np.concatenate([rng.uniform(-300, 300, (30, 3)) * [1, 1, 0.01],
                         [[14.6, 0.0, 0.0]]])
    plan, (u_h, u_l, P_r, _) = _banded_problem(bl, 1024, 32, 20000, 2048,
                                               seed=2, cuda=cuda)
    if case == "dead_sources":
        P_r[:, torch.as_tensor(rng.rand(P_r.shape[1]) < 0.33,
                               device=cuda)] = 0.0
    counts = banded_worklist_cuda(plan, u_h, u_l, P_r)[1]
    se, bl1, amps = _problem(4096, 64, 256, seed=3, bl_scale=300.0)
    amps[::3] = 0.0
    sh, sl = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(se))
    bh, blo = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(bl1))
    amps = torch.as_tensor(amps, device=cuda)
    # loaded before the trace opens: a first load is a kernels.load span
    for lib in ("banded", "nudft"):
        load_kernel_library(lib)
    tracing.take()
    with tracing.on():
        with tracing.span("simulation", device=str(cuda)):
            with tracing.span("k2"):
                banded_spread_cuda(plan, u_h, u_l, P_r)
            with tracing.span("k1a"):
                nudft_cuda(sh, sl, bh, blo, amps,
                           freq_grid_scalars(150e6, 97656.25), 256)
    _, k2, worklist, k1a = tracing.take()
    assert worklist["name"] == "k2.worklist"
    n_rb = -(-plan.R_max // nb.K2_ROWS)
    assert worklist["counts"] == {"k2.tiles": int(counts.sum()),
                                  "k2.items": plan.nbl * n_rb,
                                  "k2.items_live": int((counts > 0).sum())}
    assert k2["counts"] == {"src.live": int((P_r != 0).any(dim=0).sum())}
    assert k1a["counts"] == {"src.live": int(live_order(amps)[1])}
    assert k2["launches"] == {"k2": 1} and k1a["launches"] == {"k1a": 1}
    assert k2["device_ms"] > 0 and k1a["device_ms"] > 0


def _hera37_slice(cuda, seed=4):
    """The HERA-37 slice's K2 problem: all 666 pairs (63 unique rows),
    1024 channels, rank 32, 12,288 sources: too few live items to fill the
    card, so K2 splits their lists."""
    from prisim_tpu_torch import baselines, layouts
    bl = baselines.build_baselines(layouts.preset_layout("HERA-37"),
                                   redundant=False).vectors
    return _banded_problem(bl, 1024, 32, 12288, 2048, seed=seed, cuda=cuda)


def _random_rows(plan, scale, cuda, seed=6):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return scale * torch.randn((plan.nbl, plan.R_max, 2 * plan.rank),
                               dtype=torch.float64, device=cuda, generator=g)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["north_star_like", "hera37_slice"])
def test_k2_adds_into_rows(cuda, case):
    """K2 with rows=R adds into R and returns it: R + banded_spread_plain to
    1e-12 of max|rows| (test_k2_matches_plain's bar), as K2 alone (rows
    None) plus R."""
    if case == "hera37_slice":
        plan, (u_h, u_l, P_r, _) = _hera37_slice(cuda)
    else:
        rng = np.random.RandomState(1)
        bl = np.concatenate([rng.uniform(-300, 300, (30, 3))
                             * [1, 1, 0.01], [[14.6, 0.0, 0.0]]])
        plan, (u_h, u_l, P_r, _) = _banded_problem(bl, 1024, 32, 20000,
                                                   2048, seed=2, cuda=cuda)
    plain = nb.banded_spread_plain(plan, u_h, u_l, P_r)
    scale = float(plain.abs().max())
    R = _random_rows(plan, scale, cuda)
    want = R + plain
    got = banded_spread_cuda(plan, u_h, u_l, P_r, rows=R)
    torch.cuda.synchronize()
    assert got is R
    assert float((got - want).abs().max()) / scale < 1e-12


@pytest.mark.gpu
def test_k2_one_split_adds_the_dense_rows_bit_for_bit(cuda, monkeypatch):
    """With one split the accumulating epilogue does the float64
    operations of a dense write and an add, in that order: rows=R gives
    R + (K2 into zeros), bit for bit; and no launch of the north-star-like
    problem splits."""
    from prisim_tpu_torch.engine import cuda_banded
    rng = np.random.RandomState(1)
    bl = np.concatenate([rng.uniform(-300, 300, (30, 3)) * [1, 1, 0.01],
                         [[14.6, 0.0, 0.0]]])
    plan, (u_h, u_l, P_r, _) = _banded_problem(bl, 1024, 32, 20000, 2048,
                                               seed=2, cuda=cuda)
    monkeypatch.setattr(cuda_banded, "spread_splits", lambda *a, **k: 1)
    dense = banded_spread_cuda(plan, u_h, u_l, P_r)
    assert banded_spread_cuda.last_splits == 1
    R = _random_rows(plan, float(dense.abs().max()), cuda)
    want = R + dense
    got = banded_spread_cuda(plan, u_h, u_l, P_r, rows=R)
    assert banded_spread_cuda.last_splits == 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", [None, 3, 8])
def test_k2_splits_match_plain(cuda, monkeypatch, n_split):
    """The HERA-37 slice's lists split among blocks (as chosen, and forced
    to 3 and 8): the splits' partial rows summed in split order and added
    into R equal R + banded_spread_plain to 1e-12 of max|rows|, and two
    launches agree bit for bit."""
    from prisim_tpu_torch.engine import cuda_banded
    plan, (u_h, u_l, P_r, _) = _hera37_slice(cuda)
    if n_split is not None:
        monkeypatch.setattr(cuda_banded, "spread_splits",
                            lambda *a, **k: n_split)
    plain = nb.banded_spread_plain(plan, u_h, u_l, P_r)
    scale = float(plain.abs().max())
    R = _random_rows(plan, scale, cuda)
    want = R + plain
    again = R.clone()
    got = banded_spread_cuda(plan, u_h, u_l, P_r, rows=R)
    banded_spread_cuda(plan, u_h, u_l, P_r, rows=again)
    torch.cuda.synchronize()
    if n_split is not None:
        assert banded_spread_cuda.last_splits == n_split
    assert banded_spread_cuda.last_splits > 1
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) / scale < 1e-12


@pytest.mark.gpu
def test_k2_without_live_sources_launches_nothing(cuda):
    """A chunk whose payload is all zero (below the horizon) has no live
    item: the worklist runs, no spread is launched, and rows are left as
    they were."""
    plan, (u_h, u_l, P_r, _) = _hera37_slice(cuda)
    P_r = torch.zeros_like(P_r)
    R = _random_rows(plan, 1.0, cuda)
    before = R.clone()
    n0 = banded_spread_cuda.launches
    got = banded_spread_cuda(plan, u_h, u_l, P_r, rows=R)
    torch.cuda.synchronize()
    assert got is R and torch.equal(R, before)
    assert banded_spread_cuda.launches == n0
    assert banded_spread_cuda.last_splits == 0
    assert int(banded_spread_cuda.last_counts.sum()) == 0
    zero = banded_spread_cuda(plan, u_h, u_l, P_r)
    assert zero.shape == R.shape and not bool(zero.any())


@pytest.mark.gpu
def test_k2_rejects_bad_inputs(cuda):
    plan, (u_h, u_l, P_r, _) = _banded_problem(
        [[30.0, 0.0, 0.0]], 64, 4, 100, 128, seed=0, cuda=cuda)
    with pytest.raises(TypeError):
        banded_spread_cuda(plan, u_h.double(), u_l, P_r)
    with pytest.raises(ValueError):
        banded_spread_cuda(plan, u_h, u_l.cpu(), P_r)
    with pytest.raises(ValueError):
        banded_spread_cuda(plan, u_h, u_l, P_r[:2])
    rows = torch.zeros((plan.nbl, plan.R_max, 2 * plan.rank),
                       dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        banded_spread_cuda(plan, u_h, u_l, P_r, rows=rows.float())
    with pytest.raises(ValueError):
        banded_spread_cuda(plan, u_h, u_l, P_r, rows=rows.cpu())
    with pytest.raises(ValueError):
        banded_spread_cuda(plan, u_h, u_l, P_r, rows=rows[:, :-1])


@pytest.mark.gpu
def test_banded_run_cuda_matches_cpu(cuda, tmp_path):
    """The banded engine on the card (K2, gated by K1a) against the same
    run on the CPU (plain versions): 1e-6 of max|V| (float64 rows in both,
    complex64 output)."""
    from prisim_tpu_torch.config import load_parms
    from prisim_tpu_torch.driver import run_simulation
    parms = load_parms({
        "dirstruct": {"rootdir": str(tmp_path)},
        "telescope": {"id": "hera"},
        "array": {"layout": "HERA-7", "redundant": False},
        "bandpass": {"nchan": 64, "freq_resolution": 97656.25},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "usm", "nside": 8},
        "processing": {"engine": "auto"},
        "save_formats": {"fmt": "none", "npz": False}})
    n0, k0 = banded_spread_cuda.launches, nudft_cuda.launches
    vs_gpu, _ = run_simulation(parms, verbose=False, save=False,
                               device="cuda")
    assert banded_spread_cuda.launches == n0 + 3       # gate + 2 snapshots
    assert nudft_cuda.launches == k0 + 2               # gate: hi + lo
    parms["processing"]["engine"] = "nufft"
    vs_cpu, _ = run_simulation(parms, verbose=False, save=False,
                               device="cpu")
    scale = np.abs(vs_cpu.skyvis).max()
    assert np.abs(vs_gpu.skyvis - vs_cpu.skyvis).max() / scale < 1e-6


# --------------------------------------------------------------------------
# beams on CUDA tensors, and the beam routes of the driver on the card
# --------------------------------------------------------------------------

# a beam on the card against the same torch code on the CPU, max|d| / max:
# float32 maths, rounded by other libraries
BEAM_BAR = 1e-5
_STEER = {"pointing_center_dircos": (0.1, -0.05, 0.99373)}
_LOCS = np.random.RandomState(11).uniform(-3, 3, (12, 3)) * [1, 1, 0.1]
_BEAMS = dict(
    [("id_%s" % t, ({"id": t}, None)) for t in
     ("vla", "gmrt", "ugmrt", "hera", "hirax", "mwa", "mwa_dipole", "paper")]
    + [("%s%s" % (s, "_gp" if gp else ""),
        ({"id": "custom", "shape": s, "groundplane": gp,
          "size": {"rect": (4.0, 2.0), "dipole": 0.74}.get(s, 2.0)}, None))
       for s in ("delta", "dipole", "dish", "gaussian", "rect", "square")
       for gp in (None, 0.3)]
    + [("mwa_steered", ({"id": "mwa"}, _STEER)),
       ("mwa_errors", ({"id": "mwa"},
                       dict(_STEER, delayerr=1e-9, gainerr=0.5, nrand=4))),
       ("aperture", ({"id": "custom", "aperture_locs": _LOCS}, _STEER)),
       ("aperture_feed", ({"id": "custom", "aperture_locs": _LOCS,
                           "feedinfo": {"shape": "dipole", "size": 1.2,
                                        "position": (0.0, 0.0, 2.0)}},
                          _STEER))])


def _beam_inputs(S=2000, C=48, seed=5):
    rng = np.random.RandomState(seed)
    s = rng.randn(S, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    return (torch.as_tensor(s, dtype=torch.float32),
            torch.as_tensor(140e6 + 0.5e6 * np.arange(C), dtype=torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_BEAMS))
def test_beams_on_cuda_match_cpu(cuda, name):
    """Every branch of the dispatcher given CUDA tensors computes on the
    card, in float32, and agrees with the CPU; a beam with errors draws
    the same realization from one CPU generator on both, and repeats
    itself bit for bit with its default (card) generator."""
    from prisim_tpu_torch.beams import primary_beam
    tel, pinfo = _BEAMS[name]
    dc, f = _beam_inputs()
    if tel["id"] in ("vla", "gmrt", "ugmrt"):
        f = f + 250e6
    gen = (lambda: torch.Generator().manual_seed(0)) if name == "mwa_errors" \
        else (lambda: None)
    got = primary_beam(dc.to(cuda), f.to(cuda), tel, pointing_info=pinfo,
                       generator=gen())
    assert got.device.type == "cuda" and got.dtype == torch.float32
    want = primary_beam(dc, f, tel, pointing_info=pinfo, generator=gen())
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert float((got.cpu() - want).abs().max()) <= BEAM_BAR * float(
        want.abs().max())
    a = primary_beam(dc.to(cuda), f.to(cuda), tel, pointing_info=pinfo)
    b = primary_beam(dc.to(cuda), f.to(cuda), tel, pointing_info=pinfo)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_external_device_evaluate_cuda_matches_cpu(cuda):
    """ExternalBeam.device_evaluate on CUDA tensors: on the card, the same
    for every chunk of its gather, and within 1e-6 of the CPU's."""
    from prisim_tpu_torch import healpix as hp
    from prisim_tpu_torch.beams import ExternalBeam
    theta, phi = hp.pix2ang(16, np.arange(hp.nside2npix(16)))
    bf = np.asarray([120e6, 150e6, 180e6, 210e6])
    maps = np.stack([np.exp(-(np.sin(theta) / (0.3 * 150e6 / f)) ** 2)
                     for f in bf], axis=1)
    ext = ExternalBeam(maps, bf)
    rng = np.random.default_rng(5)
    altaz = np.stack([rng.uniform(-20, 90, 3000), rng.uniform(0, 360, 3000)],
                     axis=-1)
    table = torch.as_tensor(ext.channel_table(150e6 + 2e5 * np.arange(64)))
    pix, wgt = (torch.as_tensor(x) for x in ext.interp_weights(altaz))
    want = ExternalBeam.device_evaluate(table, pix, wgt)
    got = ExternalBeam.device_evaluate(table.to(cuda), pix.to(cuda),
                                       wgt.to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert float((got.cpu() - want).abs().max()) <= 1e-6
    chunked = ExternalBeam.device_evaluate(table.to(cuda), pix.to(cuda),
                                           wgt.to(cuda), 777)
    assert torch.equal(got, chunked)


def _route_parms(tmp_path, case):
    from prisim_tpu_torch.config import load_parms
    p = {"dirstruct": {"rootdir": str(tmp_path)},
         "telescope": {"id": "hera", "latitude": -30.7},
         "array": {"layout": "HERA-7", "redundant": False},
         "bandpass": {"nchan": 32, "freq_resolution": 390625.0},
         "obsparm": {"n_acc": 2, "t_acc": 600.0},
         "skyparm": {"model": "random", "nsrc": 96, "seed": 7},
         "processing": {"engine": "direct"},
         "pp": {"key": "none"},
         "save_formats": {"fmt": "none", "npz": False}}
    if case == "mwa_dipole":
        p["telescope"] = {"id": "mwa_dipole", "latitude": -26.7}
    elif case == "phased_track":
        p["telescope"] = {"id": "mwa", "latitude": -26.7}
        p["antenna"] = {"shape": "dipole", "size": 0.74, "phased_array": True}
        p["obsparm"] = {"n_acc": 2, "t_acc": 3600.0, "obs_mode": "track"}
        p["pointing"] = {"track_init": {"ra": 30.0, "dec": -26.7}}
    elif case == "sectors":
        p["processing"]["n_sky_sectors"] = 3
    elif case == "external":
        from prisim_tpu_torch import healpix as hp
        from prisim_tpu_torch.io.fitsio import write_image
        theta, _ = hp.pix2ang(8, np.arange(hp.nside2npix(8)))
        path = str(tmp_path / "beam.fits")
        with open(path, "wb") as fh:
            write_image(fh, np.exp(-(np.sin(theta) / 0.3) ** 2)[:, None],
                        primary=True)
        p["beam"] = {"use_external": True, "file": path}
        p["skyparm"] = {"model": "usm", "nside": 8}
    return load_parms(p)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mwa_dipole", "phased_track", "sectors",
                                  "external"])
def test_beam_routes_cuda_match_cpu(cuda, tmp_path, case):
    """The beam routes on the card (K1a) against the same runs on the CPU
    (plain versions), within 1e-5 of max|V| (the float32 beams round
    differently on the card): mwa_dipole, a steered MWA tile tracking, three
    sky sectors (each sector), an external FITS beam."""
    from prisim_tpu_torch.driver import run_simulation
    parms = _route_parms(tmp_path, case)
    n0 = nudft_cuda.launches
    gpu, _ = run_simulation(parms, verbose=False, save=False, device="cuda")
    assert nudft_cuda.launches > n0
    cpu, _ = run_simulation(parms, verbose=False, save=False, device="cpu")
    pairs = zip(gpu, cpu) if case == "sectors" else [(gpu, cpu)]
    for g, c in pairs:
        assert (g is None) == (c is None)
        if g is not None:
            scale = np.abs(c.skyvis).max()
            assert np.abs(g.skyvis - c.skyvis).max() / scale < 1e-5


# --------------------------------------------------------------------------
# full polarization: the Mueller weights on CUDA tensors, and a full-pol
# run on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    {}, {"half_wave": False, "short_dipole": True},
    {"half_wave": False, "ground_height": 0.3, "length": 1.3},
    {"y_orientation_deg": 75.0}])
def test_mueller_weights_cuda_match_cpu(cuda, kw):
    """mueller_unpol_weights on the card: float32 on the card, within 1e-6
    of max of the CPU's per component, |B_XY| <= sqrt(B_XX B_YY)."""
    from prisim_tpu_torch.beams import mueller_unpol_weights
    dc, f = _beam_inputs(S=4000, C=64)
    dc[:, 2] = dc[:, 2].abs()
    got = mueller_unpol_weights(dc.to(cuda), f.to(cuda), **kw)
    want = mueller_unpol_weights(dc, f, **kw)
    for pq in ("XX", "YY", "XY"):
        assert got[pq].device.type == "cuda"
        assert got[pq].dtype == torch.float32
        assert float((got[pq].cpu() - want[pq]).abs().max()) <= 1e-6 * float(
            want[pq].abs().max())
    assert bool((got["XY"].abs() <= torch.sqrt(got["XX"] * got["YY"])
                 * (1 + 1e-6) + 1e-7).all())


@pytest.mark.gpu
def test_full_pol_run_cuda_matches_cpu(cuda, tmp_path):
    """beam.pol: full on the card, engine auto (each component banded behind
    its gate, K2 and K1a launched) against the same run on the CPU (engine
    nufft, the plain versions): each component within 1e-5 of its max|V|
    (the f32 weights round differently on the card); the combined 4-pol
    UVFITS reads back."""
    from prisim_tpu_torch.config import load_parms
    from prisim_tpu_torch.driver import run_simulation
    from prisim_tpu_torch.io.uvfits import load_uvfits
    import os
    parms = load_parms({
        "dirstruct": {"rootdir": str(tmp_path), "simid": "fp"},
        "telescope": {"id": "mwa_dipole", "latitude": -26.7},
        "array": {"layout": "HERA-7", "redundant": False},
        "bandpass": {"nchan": 64, "freq_resolution": 97656.25},
        "obsparm": {"n_acc": 2, "t_acc": 600.0},
        "skyparm": {"model": "random", "nsrc": 200, "seed": 3},
        "beam": {"pol": "full"},
        "processing": {"engine": "auto"},
        "save_formats": {"fmt": "none", "npz": False}})
    n0, k0 = banded_spread_cuda.launches, nudft_cuda.launches
    gpu, outdir = run_simulation(parms, verbose=False, device="cuda")
    assert banded_spread_cuda.launches > n0 and nudft_cuda.launches > k0
    parms["processing"]["engine"] = "nufft"
    cpu, _ = run_simulation(parms, verbose=False, save=False, device="cpu")
    for g, c in zip(gpu, cpu):
        scale = np.abs(c.skyvis).max()
        assert np.abs(g.skyvis - c.skyvis).max() / scale < 1e-5
    back = load_uvfits(os.path.join(outdir, "simdata",
                                    "simvis_fullpol.uvfits"))
    np.testing.assert_array_equal(back.skyvis, gpu[0].skyvis)


def _clean_inputs(seed=0, rows=96, n=256):
    """Delay-like spectra (sparse components through a sinc kernel, a weak
    noise floor) and horizon-like boxes of several widths."""
    rng = np.random.RandomState(seed)
    x = np.arange(n)
    kern = np.sinc((x - n // 2) / 2.5) * np.exp(0.2j * (x - n // 2) / 2.5)
    kern = np.roll(kern, -n // 2).astype(np.complex64)
    specs = 0.01 * (rng.randn(rows, n) + 1j * rng.randn(rows, n))
    for _ in range(4):
        pos = rng.randint(0, n, rows)
        amp = rng.uniform(0.2, 2.0, rows) * np.exp(2j * np.pi * rng.rand(rows))
        specs += amp[:, None] * kern[(x[None, :] - pos[:, None]) % n]
    half = rng.randint(1, n // 2, rows)
    box = np.abs(np.fft.fftshift(x - n // 2))[None, :] <= half[:, None]
    return specs.astype(np.complex64), np.broadcast_to(kern, specs.shape), box


@pytest.mark.gpu
@pytest.mark.parametrize("boxed", [False, True])
def test_clean_card_matches_cpu(cuda, boxed):
    """The batched CLEAN on the card against the same code on the CPU:
    niter and terminated_by equal, cc and res within 1e-5 of max|inp|."""
    from prisim_tpu_torch.analysis.clean import batch_clean
    specs, kern, box = _clean_inputs()
    kw = dict(cboxes=box if boxed else None, gain=0.1, maxiter=200,
              threshold=2e-2)
    a = batch_clean(specs, kern, device="cpu", **kw)
    b = batch_clean(specs, kern, device=cuda, **kw)
    np.testing.assert_array_equal(b["niter"], a["niter"])
    np.testing.assert_array_equal(b["terminated_by"], a["terminated_by"])
    scale = np.abs(specs).max()
    for key in ("cc", "res"):
        assert np.abs(b[key] - a[key]).max() / scale < 1e-5, key


@pytest.mark.gpu
def test_subband_delay_transform_card_matches_cpu(cuda):
    """subband_delay_transform with resampling on the card against the CPU:
    within 1e-6 of the max of each cube."""
    from prisim_tpu_torch.analysis.delay import subband_delay_transform
    from prisim_tpu_torch.vis import VisibilitySet
    rng = np.random.RandomState(3)
    shp = (20, 128, 4)
    vs = VisibilitySet(
        baselines=rng.randn(20, 3) * 50,
        labels=np.asarray([[str(i + 1), "0"] for i in range(20)]),
        freqs=150e6 + 1e5 * np.arange(128), lst=np.arange(4.0),
        skyvis=(rng.randn(*shp) + 1j * rng.randn(*shp)).astype(np.complex64))
    kw = dict(freq_center=[153e6, 158e6], bw_eff=3e6, resample=True)
    a = subband_delay_transform(vs, device="cpu", **kw)
    b = subband_delay_transform(vs, device=cuda, **kw)
    for key in ("skyvis_lag", "lag_kernel", "skyvis_lag_resampled"):
        scale = np.abs(a[key.replace("_resampled", "")]).max()
        assert np.abs(b[key] - a[key]).max() / scale < 1e-6, key


# delay_spread vs its plain version, max|d grid| / max|grid|: both sum in
# float64, atomics only change the order
SPREAD_BAR = 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("S,B,C,r,per_bl,span,chan0", [
    (700, 12, 256, 1, True, 1e-6, 0),      # per-baseline amplitudes
    (1000, 8, 64, 16, False, 3e-5, 3),     # several 1/dnu periods, chan0
    (5000, 30, 1024, 32, False, 5e-8, 0),  # crowded bins (a short baseline)
    (3000, 10, 128, 40, False, 1e-6, 0),   # two rank groups
    (2500, 4, 16, 7, False, 2e-9, 0),      # every source in a few bins
])
def test_delay_spread_matches_plain(cuda, S, B, C, r, per_bl, span, chan0):
    from prisim_tpu_torch.engine.cuda_spread import (delay_spread_cuda,
                                                     delay_spread_plain)
    rng = np.random.RandomState(S + B + r)
    th, tl = (torch.as_tensor(a, device=cuda) for a in
              tf.split_f64(rng.uniform(-span, span, (S, B))))
    P = rng.uniform(-1, 1, (B, S, r) if per_bl else (S, r))
    P[..., rng.rand(S) < 0.3, :] = 0.0         # sources below the horizon
    P = torch.as_tensor(P, device=cuda)
    args = (th, tl, P, 150e6, 97656.25, C)
    n0 = delay_spread_cuda.launches
    got = delay_spread_cuda(*args, chan0=chan0)
    want = delay_spread_plain(*args, chan0=chan0)
    torch.cuda.synchronize()
    assert delay_spread_cuda.launches == n0 + 1
    assert got.shape == want.shape == (B, 2 * C, r)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= SPREAD_BAR * scale



@pytest.mark.gpu
def test_generate_noise_takes_a_cuda_tensor(cuda):
    """generate_noise with the rms a CUDA tensor on the generator's device
    (no host round trip), a scalar rms broadcast to `shape`, and the
    numpy rms: complex64 on the card, the same draws for the same seed."""
    from prisim_tpu_torch.engine.noise import generate_noise
    rms = np.random.default_rng(2).uniform(0.5, 2.0, (7, 16, 5))

    def gen():
        return torch.Generator(device=cuda).manual_seed(9)

    host = generate_noise(gen(), rms)
    dev = generate_noise(gen(), torch.as_tensor(rms, device=cuda))
    assert dev.is_cuda and dev.dtype == torch.complex64
    assert dev.shape == (7, 16, 5) and torch.equal(dev, host)
    scalar = generate_noise(gen(), 1.5, (7, 16, 5))
    assert scalar.shape == (7, 16, 5) and scalar.is_cuda
    assert torch.equal(scalar, generate_noise(
        gen(), torch.tensor(1.5, device=cuda), (7, 16, 5)))


@pytest.mark.gpu
def test_kernel_knobs_on_cuda_tensors(cuda):
    """On CUDA tensors use_pallas=False and interpret=True raise before any
    launch, in simulate_drift and make_banded_snapshot_fns; use_pallas
    None or True launches K1a once an accumulation."""
    from prisim_tpu_torch.driver import prepare_simulation
    from prisim_tpu_torch.config import load_parms
    from prisim_tpu_torch.engine import observe
    from prisim_tpu_torch.engine.nufft_delay import chebyshev_projection
    parms = load_parms({
        "telescope": {"id": "hera"},
        "array": {"layout": "HERA-7", "redundant": False},
        "bandpass": {"nchan": 32, "freq_resolution": 97656.25},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "usm", "nside": 8},
        "save_formats": {"fmt": "none", "npz": False}})
    sim = prepare_simulation(parms, cuda)
    args = (sim.inst, sim.sky, sim.obs, sim.beam_fn)
    n0 = nudft_cuda.launches
    for kw in (dict(use_pallas=False), dict(interpret=True)):
        with pytest.raises(ValueError):
            observe.simulate_drift(*args, **kw)
    assert nudft_cuda.launches == n0
    v = observe.simulate_drift(*args, use_pallas=None)
    assert torch.equal(observe.simulate_drift(*args, use_pallas=True), v)
    assert v.is_cuda and nudft_cuda.launches == n0 + 4
    plan = nb.make_banded_plan(np.asarray(sim.bls.vectors), sim.inst.nu0,
                               sim.inst.dnu, sim.inst.nchan, rank=8)
    pinvQ, Q = chebyshev_projection(sim.freqs, 8)
    with pytest.raises(ValueError, match="interpret"):
        nb.make_banded_snapshot_fns(sim.inst, sim.sky, sim.beam_fn, plan,
                                    pinvQ, Q, True)


# --------------------------------------------------------------------------
# kernel airy_amps: the direct snapshot's Airy beam x flux in one pass
# --------------------------------------------------------------------------

# HERA's default orientation (antenna.orientation [90, 270] altaz), whose
# s.p the chain's matrix product takes exactly in any order, and an axis
# off zenith
_HERA_AXIS = (-6.123233995736766e-17, -1.1248198369963932e-32, 1.0)
_STEERED_AXIS = (0.1, -0.05, 0.99373)
_AIRY_TELESCOPES = {
    "hera_zenith": {"id": "hera", "orientation_dircos": _HERA_AXIS},
    "hera_steered": {"id": "hera", "orientation_dircos": _STEERED_AXIS},
    "dish": {"id": "custom", "shape": "dish", "size": 14.0}}


def _airy_rows(S, C, seed):
    """S direction cosines and (S, C) fluxes over 100-200 MHz with the rows
    the kernel must get right first (S = 1 keeps the first): x = a sin(t)
    crossing 8 at 150 MHz for a 14 m dish, zenith (x = 0), s_z = 0
    exactly, below the horizon, x < 1e-6 off zenith, zero flux; the rest
    random over the sphere."""
    rng = np.random.RandomState(seed)
    s = rng.randn(S, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    st = 8.0 / (2 * np.pi * 150e6 / 299792458.0 * 7.0)
    special = [[st, 0.0, np.sqrt(1 - st ** 2)], [0.0, 0.0, 1.0],
               [0.6, 0.8, 0.0], [0.3, -0.4, -np.sqrt(0.75)],
               [1e-9, 0.0, 1.0]]
    n = min(S, len(special))
    s[:n] = special[:n]
    flux = rng.uniform(0.5, 20.0, (S, C))
    flux[5:6] = 0.0
    return s, flux, 100e6 + 100e6 * np.arange(C) / C


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 3000])
@pytest.mark.parametrize("C", [256, 1024, 253])
@pytest.mark.parametrize("case", sorted(_AIRY_TELESCOPES))
def test_airy_amps_matches_the_torch_chain(cuda, case, C, S):
    """airy_amps against _beam_and_flux's torch chain on the same card: bit
    for bit about zenith (HERA's default orientation and the generic dish),
    to 1e-6 of max|amps| about a steered axis (the chain takes s.p through
    a matrix product); K1a's visibilities from both tables agree to the
    same bound; one launch, which the enclosing span records."""
    from prisim_tpu_torch import tracing
    from prisim_tpu_torch.driver import _make_beam_fn
    from prisim_tpu_torch.engine.cuda_beam import airy_amps_cuda
    from prisim_tpu_torch.engine.observe import _beam_and_flux
    s, flux, freqs = _airy_rows(S, C, seed=S + C)
    beam_fn = _make_beam_fn({"beam": {}}, _AIRY_TELESCOPES[case], freqs)
    assert beam_fn.airy == (14.0, _AIRY_TELESCOPES[case].get(
        "orientation_dircos"))

    def chain(d, f):            # the same beam, without .airy
        return beam_fn(d, f)
    sd, fl, f32 = (torch.as_tensor(x, dtype=torch.float32, device=cuda)
                   for x in (s, flux, freqs))
    want = _beam_and_flux(sd, fl, f32, chain)
    n0 = airy_amps_cuda.launches
    tracing.take()
    with tracing.on():
        with tracing.span("simulation", device=str(cuda)):
            with tracing.span("beam_flux"):
                got = _beam_and_flux(sd, fl, f32, beam_fn)
    torch.cuda.synchronize()
    rec = next(r for r in tracing.take() if r["name"] == "beam_flux")
    assert airy_amps_cuda.launches == n0 + 1
    assert rec["launches"] == {"airy_amps": 1}
    assert got.shape == (S, C) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert scale > 0
    if case == "hera_steered":
        assert float((got - want).abs().max()) <= 1e-6 * scale
    else:
        assert torch.equal(got, want)
    g = got.cpu().numpy()
    if S > 5:
        assert not g[[2, 3, 5]].any()            # s_z = 0, below, zero flux
    if S > 1 and case != "hera_steered":
        np.testing.assert_array_equal(g[1], fl[1].cpu().numpy())   # zenith
    # K1a from both tables
    rng = np.random.RandomState(C)
    se = s - np.asarray([0.0, 0.0, 1.0])
    seh, sel = (torch.as_tensor(x, device=cuda) for x in tf.split_f64(se))
    blh, bll = (torch.as_tensor(x, device=cuda)
                for x in tf.split_f64(rng.randn(9, 3) * 100.0))
    gs = freq_grid_scalars(float(freqs[0]), float(freqs[1] - freqs[0]))
    v_got, v_want = (nudft_cuda(seh, sel, blh, bll, a.contiguous(), gs, C)
                     for a in (got, want))
    vs = float(v_want.abs().max())
    assert float((v_got - v_want).abs().max()) <= 1e-6 * vs


@pytest.mark.gpu
def test_airy_amps_rejects_bad_inputs(cuda):
    from prisim_tpu_torch.engine.cuda_beam import airy_amps_cuda
    s = torch.zeros((4, 3), device=cuda)
    s[:, 2] = 1.0
    fl = torch.ones((4, 8), device=cuda)
    f = torch.linspace(1e8, 2e8, 8, device=cuda)
    n0 = airy_amps_cuda.launches
    with pytest.raises(TypeError):
        airy_amps_cuda(s.double(), fl, 14.0, f)
    with pytest.raises(ValueError):
        airy_amps_cuda(s, fl[:, :7], 14.0, f)
    with pytest.raises(ValueError):
        airy_amps_cuda(s, torch.ones((8, 4), device=cuda).t(), 14.0, f)
    with pytest.raises(ValueError):
        airy_amps_cuda(s, fl.cpu(), 14.0, f)
    assert airy_amps_cuda.launches == n0


# --------------------------------------------------------------------------
# kernel banded_prep against the torch chain it replaces
# --------------------------------------------------------------------------

# P_r of the kernel against the chain's, max|d| / max|P|: both float64, the
# node-to-coefficient sums in another order
PREP_BAR = 1e-13


def _prep_case(case, cuda):
    """(plan, the chain's arguments (s_eq_hi, s_eq_lo, Mh, Ml, pch, pcl),
    AiryPayload) of a prep case: the slice (HERA-37 non-redundant, 1024
    channels, rank 32, 49,152 sources), a north-star chunk's first 100,000
    sources (HERA-331 redundant: 384 directions, rank 32), 5,000 sources
    that the tile pads to 6,144 (HERA-19, rank 16), and that case with one
    source vector four times too long (ok False)."""
    from prisim_tpu_torch import baselines, layouts
    from prisim_tpu_torch.engine.cuda_prep import AiryPayload
    from prisim_tpu_torch.engine.nufft_delay import chebyshev_node_model
    from prisim_tpu_torch.engine.observe import enu_rotation_from_eq
    layout, redundant, S, r = {
        "slice": ("HERA-37", False, 49152, 32),
        "north_star_chunk": ("HERA-331", True, 100000, 32),
        "ragged": ("HERA-19", True, 5000, 16),
        "not_unit": ("HERA-19", True, 5000, 16)}[case]
    bl = baselines.build_baselines(layouts.preset_layout(layout),
                                   redundant=redundant).vectors
    freqs = 100e6 + 97656.25 * np.arange(1024)
    plan = nb.make_banded_plan(bl, freqs[0], 97656.25, 1024, rank=r)
    rng = np.random.RandomState(S + r)
    s = rng.randn(S, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    M = enu_rotation_from_eq(rng.uniform(0, 360), -30.7224)
    if case == "not_unit":
        s[7] = M.T @ [4.0, 0.0, 0.0]         # four times due east
    pc = np.asarray([0.0, 0.0, 1.0])
    dev = [torch.as_tensor(x, device=cuda) for pair in (
        tf.split_f64(s), tf.split_f64(M), tf.split_f64(pc)) for x in pair]
    nm = chebyshev_node_model(freqs, r)
    flux = rng.uniform(0.5, 20.0, (S, r))
    flux[11] = 0.0
    airy = AiryPayload(14.0, nm.nu_nodes,
                       torch.as_tensor(flux, device=cuda),
                       torch.as_tensor(np.ascontiguousarray(nm.node2coef64),
                                       device=cuda))
    if case == "north_star_chunk":
        assert plan.ndir == 384
    return plan, dev, airy


@pytest.mark.gpu
@pytest.mark.parametrize("payload", ["airy", "none"])
@pytest.mark.parametrize("case", ["slice", "north_star_chunk", "ragged",
                                  "not_unit"])
def test_banded_prep_matches_the_torch_chain(cuda, case, payload):
    """banded_prep against banded_prep_plain (the chain) on the same card:
    u_h, u_l, ok and the rotated and centred vectors bit for bit; the Airy
    payload to 1e-13 of max|P| with the same zeros (below the horizon, zero
    flux, the pads); one launch, which the enclosing span records."""
    from prisim_tpu_torch import tracing
    from prisim_tpu_torch.engine.cuda_prep import banded_prep_cuda
    plan, args, airy = _prep_case(case, cuda)
    airy = airy if payload == "airy" else None
    want = nb.banded_prep_plain(plan, *args, airy=airy, vectors=True)
    n0 = banded_prep_cuda.launches
    tracing.take()
    with tracing.on():
        with tracing.span("simulation", device=str(cuda)):
            with tracing.span("prep"):
                got = banded_prep_cuda(plan, *args, airy=airy, vectors=True)
    torch.cuda.synchronize()
    rec = next(r for r in tracing.take() if r["name"] == "prep")
    assert banded_prep_cuda.launches == n0 + 1
    assert rec["launches"] == {"banded_prep": 1}
    u_h, u_l, P_r, ok, vecs = got
    S_pad = -(-args[0].shape[0] // plan.T_s) * plan.T_s
    assert u_h.shape == (1, plan.ndir * S_pad) == want[0].shape
    assert torch.equal(u_h, want[0]) and torch.equal(u_l, want[1])
    assert bool(ok) == bool(want[3]) == (case != "not_unit")
    for g, w in zip(vecs, want[4]):
        assert torch.equal(g, w)
    if airy is None:
        assert P_r is None and want[2] is None
        return
    P = want[2]
    assert P_r.shape == P.shape == (plan.rank, S_pad)
    assert torch.equal(P_r == 0, P == 0)
    scale = float(P.abs().max())
    assert scale > 0
    assert float((P_r - P).abs().max()) <= PREP_BAR * scale
    live = (P != 0).any(dim=0)
    assert 0 < int(live.sum()) < args[0].shape[0]


@pytest.mark.gpu
def test_banded_snapshots_and_gate_with_the_kernel_match_the_chain(
        cuda, monkeypatch):
    """The banded engine's snapshots and gate with banded_prep against the
    same engine with the chain in its place, on one card: HERA-19 x 1024
    channels (rank 32, truth amps from the driver's Airy form), nside 32,
    3 source chunks of 5,000 (the tile pads each): V and the gate's
    banded and direct snapshots to 1e-7 of max|V|, ok and the model
    residual equal, and K2's worklist of every chunk (tiles, counts,
    offsets) equal."""
    from prisim_tpu_torch.config import load_parms
    from prisim_tpu_torch.driver import _banded_settings, prepare_simulation
    from prisim_tpu_torch.engine.cuda_prep import banded_prep_cuda
    from prisim_tpu_torch.engine.nufft_delay import chebyshev_projection
    from prisim_tpu_torch.engine.observe import schedule_tensors
    parms = load_parms({
        "telescope": {"id": "hera"},
        "array": {"layout": "HERA-19", "redundant": True},
        "bandpass": {"nchan": 1024, "freq_resolution": 97656.25},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "usm", "nside": 32},
        "processing": {"engine": "auto"},
        "save_formats": {"fmt": "none", "npz": False}})
    sim = prepare_simulation(parms, cuda)
    rank, node_model, truth, plan_kw = _banded_settings(parms, sim)
    assert rank == 32 and truth is not None
    plan = nb.make_banded_plan(np.asarray(sim.bls.vectors), sim.inst.nu0,
                               sim.inst.dnu, sim.freqs.size, rank=rank,
                               **plan_kw)
    pinvQ, Q = chebyshev_projection(sim.freqs, rank)

    def fns():
        return nb.make_banded_snapshot_fns(
            sim.inst, sim.sky, sim.beam_fn, plan, pinvQ, Q,
            gate_src_block=sim.src_block, node_model=node_model,
            truth=truth, src_chunk=5000)
    kern = fns()
    with monkeypatch.context() as m:
        m.setattr(nb, "banded_prep_cuda", nb.banded_prep_plain)
        chain = fns()
    assert kern.n_chunks == 3
    sched = schedule_tensors(sim.obs, sim.inst.latitude, cuda)
    n0 = banded_prep_cuda.launches
    for t in range(2):
        a = [x[t] for x in sched]
        (vk, okk), (vc, okc) = kern(*a), chain(*a)
        scale = float(vc.abs().max())
        assert bool(okk) and bool(okc)
        assert float((vk - vc).abs().max()) <= 1e-7 * scale
        for c in range(kern.n_chunks):
            wk = banded_worklist_cuda(plan, *kern.prep_chunk(c, *a)[:3])
            wc = banded_worklist_cuda(plan, *chain.prep_chunk(c, *a)[:3])
            for g, w in zip(wk[1:], wc[1:]):
                assert torch.equal(g, w)
    gk, gc = kern.gate_fn(*a), chain.gate_fn(*a)
    assert banded_prep_cuda.launches == n0 + 2 * 2 * 3 + 3
    scale = np.abs(gc[0]).max()
    for i in (0, 1):
        assert np.abs(gk[i] - gc[i]).max() <= 1e-7 * scale
    assert gk[2] and gc[2]
    assert gk[3] == pytest.approx(gc[3], rel=1e-6)
    assert gk[4] == pytest.approx(gc[4], rel=1e-12)


@pytest.mark.gpu
def test_banded_prep_rejects_bad_inputs(cuda):
    from prisim_tpu_torch.engine.cuda_prep import banded_prep_cuda
    plan, args, airy = _prep_case("ragged", cuda)
    n0 = banded_prep_cuda.launches
    with pytest.raises(TypeError):
        banded_prep_cuda(plan, args[0].double(), *args[1:], airy=airy)
    with pytest.raises(ValueError):
        banded_prep_cuda(plan, *args[:2], args[2].cpu(), *args[3:])
    with pytest.raises(ValueError):
        banded_prep_cuda(plan, *args[:5], args[5][None], airy=airy)
    with pytest.raises(ValueError):
        banded_prep_cuda(plan, *args, airy=airy._replace(
            flux_nodes=airy.flux_nodes.cpu()))
    with pytest.raises(ValueError):
        banded_prep_cuda(plan, *args, airy=airy._replace(
            node2coef64=airy.node2coef64.t()))
    with pytest.raises(ValueError):
        banded_prep_cuda(plan, *args, airy=airy._replace(diameter=1000.0))
    assert banded_prep_cuda.launches == n0


# --------------------------------------------------------------------------
# the finalize on the card: kernel phase_cubes and the card route of
# driver._finalize_simulation
# --------------------------------------------------------------------------

# off zenith, the largest difference of a real or imaginary part in float32
# ulps of |V|: the kernel against its twin and against the exact product
# of the cubes and their float32 angle's phasor (phase_cubes_exact); the
# host's float32 cos and sin are an ulp or two off that product, so the
# card and host routes agree within twice the bar
FINALIZE_ULPS = 2.0
_CENTRES = {"zenith": ([90.0, 270.0], "altaz"),
            "altaz_off": ([62.5, 131.0], "altaz"),
            "radec_off": ([17.0, -30.7224], "radec")}


def _ulps(got, want):
    got, want = np.asarray(got), np.asarray(want)
    d = np.maximum(np.abs(got.real - want.real), np.abs(got.imag - want.imag))
    return float((d / np.spacing(np.abs(want).astype(np.float32))).max())


def _phase_args(T, B, C, centre, cuda, seed=0, with_vs=False):
    """Random (T, B, C) complex64 cubes on the card and a path of
    baselines up to 876 m over a drift's LSTs for `centre`; with_vs, also
    the container (without cubes) the path is of."""
    from prisim_tpu_torch.vis import VisibilitySet, phase_path
    g = torch.Generator(device=cuda).manual_seed(seed)
    cubes = [torch.complex(torch.randn(T, B, C, generator=g, device=cuda),
                           torch.randn(T, B, C, generator=g, device=cuda))
             for _ in range(3)]
    rng = np.random.RandomState(seed)
    bl = rng.uniform(-1.0, 1.0, (B, 3)) * [1.0, 1.0, 0.02]
    bl *= 876.0 / np.linalg.norm(bl, axis=1).max()
    zen = np.tile([90.0, 270.0], (T, 1))
    freqs = 100e6 + 97656.25 * np.arange(C)
    vs = VisibilitySet(baselines=bl, labels=np.zeros((B, 2), str),
                       freqs=freqs, lst=40.0 + 0.25 * np.arange(T),
                       latitude=-30.7224, phase_center=zen)
    center, coords = _CENTRES[centre]
    path = torch.as_tensor(phase_path(vs, np.atleast_2d(center), coords),
                           device=cuda)
    out = cubes, path, torch.as_tensor(freqs, device=cuda)
    return out + (vs,) if with_vs else out


@pytest.mark.gpu
@pytest.mark.parametrize("centre", sorted(_CENTRES))
@pytest.mark.parametrize("T,B,C", [(25, 630, 1024), (10, 63, 256),
                                   (3, 7, 45), (70, 5, 40)])
def test_phase_cubes_matches_the_twin(cuda, centre, T, B, C):
    """phase_cubes against phase_cubes_plain on the card: bit for bit at
    the zenith centre; off zenith within 2 ulps of |V| of the twin and of
    the exact product; at the north star's and config #3's shapes, a
    ragged one and one of three accumulation tiles; without a path, the
    transpose bit for bit. One launch each."""
    from prisim_tpu_torch.engine.cuda_finalize import (phase_cubes_cuda,
                                                      phase_cubes_exact,
                                                      phase_cubes_plain)
    cubes, path, nu = _phase_args(T, B, C, centre, cuda, seed=T + B + C)
    n0 = phase_cubes_cuda.launches
    got = phase_cubes_cuda(*cubes, path=path, freqs=nu)
    bare = phase_cubes_cuda(*cubes)
    torch.cuda.synchronize()
    assert phase_cubes_cuda.launches == n0 + 2
    assert got.shape == (3, B, C, T) and got.dtype == torch.complex64
    want = phase_cubes_plain(*cubes, path=path, freqs=nu)
    assert torch.equal(bare, phase_cubes_plain(*cubes))
    if centre == "zenith":
        assert torch.equal(got, want)
    else:
        got = got.cpu().numpy()
        assert _ulps(got, want.cpu().numpy()) <= FINALIZE_ULPS
        exact = phase_cubes_exact(*cubes, path=path, freqs=nu).cpu().numpy()
        assert _ulps(got, exact) <= FINALIZE_ULPS


# complex128 cubes (vis after a gains file's complex128 gains): float64
# ulps of |V|; the argument of the phasor is the host's bit for bit, and
# CUDA's, torch's and numpy's float64 cos and sin are within an ulp or two
WIDE_ULPS = 4.0


@pytest.mark.gpu
@pytest.mark.parametrize("centre", sorted(_CENTRES))
@pytest.mark.parametrize("T,B,C", [(25, 630, 1024), (3, 7, 45),
                                   (70, 5, 40)])
def test_wide_phase_cubes_matches_the_twin_and_the_host(cuda, centre, T, B,
                                                       C):
    """phase_cubes's complex128 instance, vis complex128 and the other two
    cubes widened: against the twin and against the host's transpose and
    phase_centering (its np.exp branch), bit for bit at zenith and within
    WIDE_ULPS float64 ulps of |V| off zenith; without a path the widened
    transpose, bit for bit. One launch each."""
    import dataclasses
    from prisim_tpu_torch.engine.cuda_finalize import (phase_cubes_cuda,
                                                      phase_cubes_plain)
    from prisim_tpu_torch.vis import phase_centering
    cubes, path, nu, vs = _phase_args(T, B, C, centre, cuda, seed=T * B * C,
                                      with_vs=True)
    g = torch.Generator(device=cuda).manual_seed(1)
    cubes[1] = cubes[1] * torch.complex(
        torch.rand(T, B, C, generator=g, device=cuda, dtype=torch.float64),
        torch.rand(T, B, C, generator=g, device=cuda, dtype=torch.float64))
    n0 = phase_cubes_cuda.launches
    got = phase_cubes_cuda(*cubes, path=path, freqs=nu)
    bare = phase_cubes_cuda(*cubes)
    torch.cuda.synchronize()
    assert phase_cubes_cuda.launches == n0 + 2
    assert got.shape == (3, B, C, T) and got.dtype == torch.complex128
    assert torch.equal(bare, phase_cubes_plain(*cubes))
    want = phase_cubes_plain(*cubes, path=path, freqs=nu).cpu().numpy()
    bct = [np.ascontiguousarray(x.cpu().numpy().transpose(1, 2, 0))
           for x in cubes]
    center, coords = _CENTRES[centre]
    host = phase_centering(dataclasses.replace(
        vs, skyvis=bct[0], vis=bct[1], vis_noise=bct[2]),
        np.atleast_2d(center), coords)
    got = got.cpu().numpy()
    for k, name in enumerate(("skyvis", "vis", "vis_noise")):
        h = getattr(host, name)
        assert h.dtype == np.complex128, name
        if centre == "zenith":
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], h)
        else:
            assert _ulps64(got[k], want[k]) <= WIDE_ULPS, name
            assert _ulps64(got[k], h) <= WIDE_ULPS, name


def _ulps64(got, want):
    d = np.maximum(np.abs(got.real - want.real), np.abs(got.imag - want.imag))
    return float((d / np.spacing(np.abs(want))).max())


def _finalize_sim(cuda, nbl_layout="HERA-19", nchan=64, n_acc=3,
                  centre="zenith", **pp):
    from prisim_tpu_torch import driver as drv
    from prisim_tpu_torch.config import load_parms
    center, coords = _CENTRES[centre]
    parms = load_parms({
        "telescope": {"id": "hera"},
        "array": {"layout": nbl_layout, "redundant": True},
        "bandpass": {"nchan": nchan, "freq_resolution": 97656.25},
        "obsparm": {"n_acc": n_acc, "t_acc": 60.0},
        "skyparm": {"model": "usm", "nside": 4, "seed": 11},
        "phasing": {"center": center, "coords": coords},
        "processing": {"engine": "direct"}, "pp": pp,
        "save_formats": {"fmt": "none", "npz": False}})
    sim = drv.prepare_simulation(parms, cuda)
    shape = (n_acc, sim.bls.nbl, nchan)
    g = torch.Generator(device=cuda).manual_seed(3)
    vis = torch.complex(torch.randn(shape, generator=g, device=cuda),
                        torch.randn(shape, generator=g, device=cuda))
    return drv, parms, sim, vis


def _finalize(drv, parms, sim, vis):
    return drv._finalize_simulation(parms, sim, vis, None, False, False,
                                    vis.device)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("centre", sorted(_CENTRES))
def test_card_finalize_matches_the_host_finalize(cuda, monkeypatch, centre):
    """_finalize_simulation of a CUDA cube (noise and gains on the card,
    one phase_cubes launch, one copy) against the same cube on the
    host with the same noise injected: the three cubes bit for bit at
    zenith, off zenith within 2 ulps of |V| of the exact product and 4 of
    the host's; vis_rms, Tsys, bp, bp_wts, lst and
    projected_baselines byte-identical; at HERA-331 x 1024 x 25 the card's
    allocations stay under 1 GB above the finalize's entry."""
    from prisim_tpu_torch.engine.cuda_finalize import phase_cubes_cuda
    drv, parms, sim, vis = _finalize_sim(cuda, "HERA-331", 1024, 25, centre)
    shape = (sim.bls.nbl, 1024, 25)
    g = torch.Generator().manual_seed(5)
    noise = torch.complex(torch.randn(shape, generator=g),
                          torch.randn(shape, generator=g))

    def draw(gen, rms):
        if isinstance(rms, torch.Tensor):
            assert rms.is_cuda and gen.device == rms.device
            return noise.permute(2, 0, 1).contiguous().to(rms.device)
        return noise.clone()

    monkeypatch.setattr(drv, "generate_noise", draw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    entry = torch.cuda.memory_allocated(cuda)
    n0 = phase_cubes_cuda.launches
    got = _finalize(drv, parms, sim, vis)
    above = torch.cuda.max_memory_allocated(cuda) - entry
    assert phase_cubes_cuda.launches == n0 + 1
    assert above < 1e9, above
    want = _finalize(drv, parms, sim, vis.cpu())
    assert phase_cubes_cuda.launches == n0 + 1
    import dataclasses
    from prisim_tpu_torch.engine.cuda_finalize import phase_cubes_exact
    from prisim_tpu_torch.vis import phase_path
    center, coords = _CENTRES[centre]
    path = phase_path(dataclasses.replace(
        got, phase_center=got.pointing_center, phase_center_coords="altaz"),
        np.atleast_2d(center), coords)
    sky, nz = vis.cpu(), noise.permute(2, 0, 1)
    exact = phase_cubes_exact(sky, sky + nz, nz, torch.as_tensor(path),
                              torch.as_tensor(got.freqs))
    for k, name in enumerate(("skyvis", "vis", "vis_noise")):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.complex64 and a.shape == b.shape
        if centre == "zenith":
            assert a.tobytes() == b.tobytes(), name
        else:
            assert _ulps(a, exact[k].numpy()) <= FINALIZE_ULPS, name
            assert _ulps(a, b) <= 2 * FINALIZE_ULPS, name
    for name in ("vis_rms", "Tsys", "bp", "bp_wts", "lst",
                 "projected_baselines", "phase_center"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


class _Gains:
    """A gains file's reader: complex128 per-baseline gains (B, C, T)."""

    def __init__(self, shape):
        rng = np.random.RandomState(4)
        self.g = 1.0 + 0.1 * (rng.randn(*shape) + 1j * rng.randn(*shape))

    def read_hdf5(self, path):
        return self

    def eval_gains(self, labels, **kw):
        return self.g.copy()


@pytest.mark.gpu
@pytest.mark.parametrize("centre", [None, "zenith", "altaz_off"])
def test_card_finalize_with_gains_matches_the_host_finalize(
        cuda, monkeypatch, centre):
    """A gains file's complex128 gains on the card: one phase_cubes launch
    of its complex128 instance, and the three cubes as the host finalize
    makes them from the same cube and noise: complex128 where phased, bit
    for bit about zenith and within WIDE_ULPS float64 ulps of |V|
    elsewhere; unphased, each of its own dtype and bit for bit."""
    from prisim_tpu_torch.engine.cuda_finalize import phase_cubes_cuda
    drv, parms, sim, vis = _finalize_sim(cuda, centre=centre or "zenith")
    if centre is None:
        parms["phasing"] = {"center": None}
    parms["gains"] = dict(parms.get("gains") or {}, file="gains.hdf5")
    shape = (sim.bls.nbl, 64, 3)
    monkeypatch.setattr(drv, "GainInfo", _Gains(shape))
    g = torch.Generator().manual_seed(5)
    noise = torch.complex(torch.randn(shape, generator=g),
                          torch.randn(shape, generator=g))

    def draw(gen, rms):
        if isinstance(rms, torch.Tensor):
            return noise.permute(2, 0, 1).contiguous().to(rms.device)
        return noise.clone()

    monkeypatch.setattr(drv, "generate_noise", draw)
    n0 = phase_cubes_cuda.launches
    got = _finalize(drv, parms, sim, vis)
    assert phase_cubes_cuda.launches == n0 + 1
    want = _finalize(drv, parms, sim, vis.cpu())
    assert got.vis.dtype == want.vis.dtype == np.complex128
    for name in ("skyvis", "vis", "vis_noise"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if centre is not None:
            assert a.dtype == np.complex128, name
        if centre in (None, "zenith"):
            np.testing.assert_array_equal(a, b)
        else:
            assert _ulps64(a, b) <= WIDE_ULPS, name


@pytest.mark.gpu
def test_card_noise_repeats_by_seed_and_chunk(cuda):
    """The card's draw: the same seed draws the same noise, two chunk
    indices of a chunked run draw different noise, and the noise's power
    is the rms's."""
    drv, parms, sim, vis = _finalize_sim(cuda)
    a = _finalize(drv, parms, sim, vis).vis_noise
    b = _finalize(drv, parms, sim, vis).vis_noise
    assert a.tobytes() == b.tobytes()
    chunks = []
    for i in (0, 1):
        p = dict(parms, pp=dict(parms.get("pp") or {}, _chunk={"index": i}))
        chunks.append(_finalize(drv, p, sim, vis).vis_noise)
    assert not np.array_equal(chunks[0], chunks[1])
    assert not np.array_equal(chunks[0], a)
    vs = _finalize(drv, parms, sim, vis)
    m = float(np.mean(np.abs(vs.vis_noise) ** 2 / vs.vis_rms ** 2))
    assert abs(m - 1.0) < 5.0 / np.sqrt(vs.vis_noise.size)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["noise_dropped", "noise_doubled",
                                   "noise_not_added"])
def test_noise_faults_reach_the_card_finalize(cuda, fault):
    """Each noise fault of gpubench/faults.py, planted through the driver's
    generate_noise and apply_gains, changes the card route's output."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from gpubench import faults
    from prisim_tpu_torch.engine.cuda_finalize import phase_cubes_cuda
    drv, parms, sim, vis = _finalize_sim(cuda)
    clean = _finalize(drv, parms, sim, vis)
    n0 = phase_cubes_cuda.launches
    undo = faults.plant(fault)
    try:
        bad = _finalize(drv, parms, sim, vis)
    finally:
        undo()
    assert phase_cubes_cuda.launches == n0 + 1
    assert not np.array_equal(bad.vis, clean.vis)
    assert np.array_equal(bad.skyvis, clean.skyvis)
    assert np.array_equal(bad.vis_noise, clean.vis_noise) == (
        fault == "noise_not_added")


def _boundary_directions():
    """Unit directions on the boundaries of the nside-512 pixels: the
    centres of the nside-16 pixels (their corners), the rings z = +-2/3,
    the base faces' edges in the belt and in the caps, the poles and
    phi = 0 and 2 pi; with 4,000 random directions."""
    from prisim_tpu_torch import healpix as hp

    def unit(theta, phi):
        theta, phi = np.broadcast_arrays(theta, phi)
        return np.stack([np.sin(theta) * np.cos(phi), np.sin(theta)
                         * np.sin(phi), np.cos(theta)], axis=-1)

    z = np.linspace(-2.0 / 3.0, 2.0 / 3.0, 41)
    tt = (np.arange(5)[:, None] - 0.5 + 0.75 * z[None, :]).ravel()
    caps = np.concatenate([np.linspace(0.67, 0.999, 13),
                           -np.linspace(0.67, 0.999, 13)])
    ring = np.linspace(0.0, 2.0 * np.pi, 17)
    rng = np.random.RandomState(8)
    rand = rng.randn(4000, 3)
    return np.concatenate([
        hp.pix2vec(16, np.arange(12 * 16 * 16)),
        unit(np.arccos(np.repeat(z, 5)), tt * 0.5 * np.pi),
        unit(np.arccos(np.tile(caps, 5)),
             np.repeat(np.arange(5) * 0.5 * np.pi, caps.size)),
        unit(np.arccos(2.0 / 3.0), ring), unit(np.arccos(-2.0 / 3.0), ring),
        unit(np.asarray([0.0, np.pi, 0.5 * np.pi, 0.5 * np.pi]),
             np.asarray([0.0, 0.0, 2.0 * np.pi, 2.0 * np.pi - 1e-15])),
        [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, -1e-20, 0.0]],
        rand / np.linalg.norm(rand, axis=1, keepdims=True)])


@pytest.mark.gpu
def test_spatial_order_on_the_card_is_the_hosts(cuda):
    """The card's spatial order of directions on pixel boundaries, where
    its acos, cos and atan2 may round across them, is numpy's permutation:
    the rows near a boundary take the host's pixel, and only those."""
    s = _boundary_directions()
    sh, sl = tf.split_f64(s)
    perm, n_host = nb.spatial_order(torch.as_tensor(sh, device=cuda),
                                    torch.as_tensor(sl, device=cuda))
    assert perm.device.type == "cuda" and perm.dtype == torch.int64
    want = nb.spatial_permutation(tf.join_f64(sh, sl))
    differ = int((perm.cpu().numpy() != want).sum())
    print("boundary directions: %d, rows from the host: %d, positions that "
          "differ: %d" % (s.shape[0], n_host, differ))
    assert differ == 0
    assert 0 < n_host < s.shape[0] - 4000


@pytest.mark.gpu
def test_north_star_plan_on_the_card(cuda):
    """Phase t of chip_smoke.py at the north star: the card's permutation
    of the 786,432 sources is the host's at every position, with no row
    from the host; the node fluxes lie within 4 float64 ulps of
    generate_spectrum's; the card path's banded_engine is faster than the
    host path's, and its snapshot agrees (the phase fails otherwise)."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    got = chip_smoke.plan_phase(cuda, repeats=2)
    assert got["S"] == 786432
    assert got["differ"] == 0 and got["n_host"] == 0
    assert got["ulps"] <= 4.0
    assert got["wall"]["card"] < got["wall"]["host"]


@pytest.mark.gpu
def test_tile_payload_queues_without_waiting_for_the_card(cuda):
    """The banded engine's torch payload of the MWA tile (the node model
    of the beam times the flux, make_coeff_fn) and the gate's
    full-channel beam times flux queue their work with no synchronizing
    call once the payload's tables are on the card (a wait there holds
    the host's launches behind the card's queue in every source chunk),
    and give the CPU's numbers."""
    from prisim_tpu_torch import driver as drv
    from prisim_tpu_torch.config import load_parms
    from prisim_tpu_torch.engine.observe import _beam_and_flux
    parms = load_parms({
        "telescope": {"id": "mwa", "latitude": -26.7033},
        "antenna": {"shape": "dipole", "size": 0.74, "phased_array": True,
                    "ground_plane": 0.3, "orientation": [0.0, 90.0],
                    "ocoords": "altaz"},
        "bandpass": {"freq": 150e6, "freq_resolution": 160e3,
                     "nchan": 256},
        "pointing": {"drift_init": {"alt": 90.0, "az": 0.0}}})
    freqs = drv.build_frequencies(parms)
    tel = drv._telescope(parms)
    obs = drv.build_schedule(parms, -26.7033)
    beam_fn = drv._make_beam_fn(parms, tel, freqs,
                                drv._pointing_info(parms, tel, obs))
    assert beam_fn.needs_pointing and not hasattr(beam_fn, "airy")
    pinvQ, _ = drv.chebyshev_projection(freqs, 16)
    coeffs = nb.make_coeff_fn(freqs, 16, pinvQ, beam_fn)
    rng = np.random.RandomState(11)
    s = rng.randn(4096, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    host = (torch.as_tensor(s, dtype=torch.float32),
            torch.as_tensor(rng.rand(4096, 256).astype(np.float32)),
            torch.tensor([0.0, 0.0, 1.0]))
    f32 = torch.as_tensor(freqs, dtype=torch.float32)
    want = (coeffs(*host), _beam_and_flux(host[0], host[1], f32, beam_fn,
                                          pc=host[2]))
    sh, fx, pc = (x.to(cuda) for x in host)
    f32 = f32.to(cuda)
    coeffs(sh, fx, pc)                 # copies the payload's tables once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (coeffs(sh, fx, pc), _beam_and_flux(sh, fx, f32, beam_fn,
                                                  pc=pc))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        err = float((g.cpu() - w).abs().max() / w.abs().max())
        assert err < 1e-5, err
