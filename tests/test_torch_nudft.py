"""The plain PyTorch NUDFT (the CPU path of kernels K1a, K1b and K1c)
against the JAX engines: the XLA path nudft_visibilities, the Pallas
kernel in interpret mode (as tests/test_pallas_nudft.py runs it) and the
float64 golden; point sources, the gradient moments, extended sources
(a mix of finite and infinite sigma) and both at once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prisim_tpu import constants as CNST
from prisim_tpu.engine import nudft as nj
from prisim_tpu.engine.pallas_nudft import nudft_pallas

from prisim_tpu_torch import twofloat as tft
from prisim_tpu_torch.engine import nudft as nt
from prisim_tpu_torch.engine.cuda_nudft import (live_order, nudft_cuda,
                                                source_splits)

BAR = 2e-6     # max|dV| / max|V|: the bar of tests/test_pallas_nudft.py
NU0, DNU = 150e6, 97656.25

CASES = {
    # name: (S, B, C, chan0, baseline scale in m)
    "ragged": (53, 13, 24, 0, 200.0),
    "phase_wrap": (40, 8, 16, 0, 3000.0),    # ~2000 cycles at 3 km
    "chan0": (100, 37, 48, 7, 200.0),
}


def _problem(S, B, C, chan0, bl_scale, seed):
    rng = np.random.RandomState(seed)
    s = rng.randn(S, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    s[:, 2] = np.abs(s[:, 2])
    se = s - np.asarray([0.0, 0.0, 1.0])
    bl = rng.randn(B, 3) * bl_scale
    amps = rng.rand(S, C).astype(np.float32)
    freqs = NU0 + DNU * (chan0 + np.arange(C))
    return se, bl, amps, freqs


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    S, B, C, chan0, scale = CASES[request.param]
    se, bl, amps, freqs = _problem(S, B, C, chan0, scale, seed=S + B)
    seh, sel = tft.split_f64(se)
    blh, bll = tft.split_f64(bl)
    got = nt.nudft_visibilities(
        *(torch.as_tensor(x) for x in (seh, sel, blh, bll, amps)),
        nt.freq_grid_scalars(NU0, DNU), C, chan0=chan0, src_block=32).numpy()
    jx = tuple(jnp.asarray(x) for x in (seh, sel, blh, bll, amps))
    return dict(got=got, jx=jx, C=C, chan0=chan0, se=se, bl=bl, amps=amps,
                freqs=freqs, gold=nj.nudft_reference_f64(se, bl, amps, freqs))


def _rel(a, b, scale):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / scale


def test_plain_shape_and_dtype(case):
    assert case["got"].shape == case["gold"].shape
    assert case["got"].dtype == np.complex64


def test_plain_matches_f64_golden(case):
    gold = case["gold"]
    assert _rel(case["got"], gold, np.abs(gold).max()) < BAR


def test_plain_matches_xla_engine(case):
    want = np.asarray(nj.nudft_visibilities(
        *case["jx"], nj.freq_grid_scalars(NU0, DNU), case["C"],
        chan0=case["chan0"], src_block=32))
    assert _rel(case["got"], want, np.abs(want).max()) < BAR


def test_plain_matches_pallas_interpret(case):
    want = np.asarray(nudft_pallas(
        *case["jx"], nj.freq_grid_scalars(NU0, DNU), case["C"],
        chan0=case["chan0"], src_tile=16, bl_tile=8, interpret=True))
    assert _rel(case["got"], want, np.abs(want).max()) < BAR


@pytest.mark.parametrize("anchor", [None, 1, 4, 16, 32])
def test_plain_anchor_periods_match_golden_and_pallas(case, anchor):
    """K1a's plain version at every chain length, against the f64 golden
    and the Pallas kernel in interpret mode, within the 2e-6 bar (the
    default, ANCHOR, is the fixture's own run)."""
    got = nt.nudft_visibilities(
        *(torch.as_tensor(np.asarray(x)) for x in case["jx"]),
        nt.freq_grid_scalars(NU0, DNU), case["C"], chan0=case["chan0"],
        src_block=32, anchor=anchor).numpy()
    gold = case["gold"]
    assert _rel(got, gold, np.abs(gold).max()) < BAR
    want = np.asarray(nudft_pallas(
        *case["jx"], nj.freq_grid_scalars(NU0, DNU), case["C"],
        chan0=case["chan0"], src_tile=16, bl_tile=8, interpret=True))
    assert _rel(got, want, np.abs(want).max()) < BAR


@pytest.mark.parametrize("anchor", [4, 8, 32])
def test_anchored_rotations_drift_in_float64(anchor):
    """The float64 phasor chains of K1a against the float64 phase of the
    same two-float cycle counts, over 32 steps at ~2000 cycles (3 km
    baselines): no further from it than every phasor evaluated (whose
    two-float products round at ~1e-11 there), and both under 2e-11,
    three orders below the complex64 output's rounding."""
    se, bl, _, _ = _problem(40, 8, 16, 0, 3000.0, seed=5)
    kh, kl = tft.df_dot3(*(torch.as_tensor(x)[:, None, :] for x in
                           tft.split_f64(se)),
                         *(torch.as_tensor(x)[None, :, :] for x in
                           tft.split_f64(bl)))
    g0h, g0l, gdh, gdl = (torch.tensor(v, dtype=torch.float32)
                          for v in nt.freq_grid_scalars(NU0, DNU))
    p0h, p0l = tft.df_frac(*tft.df_mul(kh, kl, g0h, g0l))
    dh, dl = tft.df_frac(*tft.df_mul(kh, kl, gdh, gdl))
    steps = torch.arange(32, dtype=torch.float32) * 32.0 + 7.0
    exact = nt._phasors(p0h, p0l, dh, dl, steps)
    rot = nt._phasors_rot(p0h, p0l, dh, dl, 32, 32, 7, anchor)
    ang = 2.0 * np.pi * ((p0h.double() + p0l.double())[..., None]
                         + (dh.double() + dl.double())[..., None]
                         * steps.double())
    for x, y, t in zip(exact, rot, (torch.cos(ang), -torch.sin(ang))):
        assert x.shape == y.shape == (40, 8, 32)
        e_rot, e_all = (float((v - t).abs().max()) for v in (y, x))
        assert e_rot <= e_all + 1e-15 and e_all < 2e-11


def test_torch_golden_matches_numpy_golden(case):
    got = nt.nudft_reference_f64(case["se"], case["bl"], case["amps"],
                                 case["freqs"], src_chunk=16).numpy()
    gold = case["gold"]
    assert _rel(got, gold, np.abs(gold).max()) < 1e-12


def test_grid_scalars_and_ql_match_jax():
    assert nt.freq_grid_scalars(NU0, DNU) == tuple(
        float(v) for v in nj.freq_grid_scalars(NU0, DNU))
    for c in (1, 5, 24, 48, 1000, 1024, 4097):
        assert nt.choose_ql(c) == nj.choose_ql(c)


def _cpu_inputs(S=8, B=3, C=16):
    se, bl, amps, _ = _problem(S, B, C, 0, 100.0, seed=1)
    seh, sel = (torch.as_tensor(x) for x in tft.split_f64(se))
    blh, bll = (torch.as_tensor(x) for x in tft.split_f64(bl))
    return seh, sel, blh, bll, torch.as_tensor(amps)


def test_wrapper_on_cpu_runs_plain_and_does_not_count():
    seh, sel, blh, bll, amps = _cpu_inputs()
    gs = nt.freq_grid_scalars(NU0, DNU)
    n0 = nudft_cuda.launches
    got = nudft_cuda(seh, sel, blh, bll, amps, gs, 16)
    want = nt.nudft_visibilities(seh, sel, blh, bll, amps, gs, 16)
    assert torch.equal(got, want)
    assert nudft_cuda.launches == n0 == 0


@pytest.mark.parametrize("bad", ["dtype", "amps_shape", "bl_shape",
                                 "device_mix", "not_tensor"])
def test_wrapper_rejects_bad_inputs(bad):
    seh, sel, blh, bll, amps = _cpu_inputs()
    gs = nt.freq_grid_scalars(NU0, DNU)
    args = dict(seh=seh, sel=sel, blh=blh, bll=bll, amps=amps)
    err = ValueError
    if bad == "dtype":
        args["sel"], err = sel.double(), TypeError
    elif bad == "amps_shape":
        args["amps"] = amps[:, :8]
    elif bad == "bl_shape":
        args["bll"] = bll[:2]
    elif bad == "device_mix":
        args["blh"] = blh.to("meta")
    else:
        args["amps"], err = amps.numpy(), TypeError
    with pytest.raises(err):
        nudft_cuda(args["seh"], args["sel"], args["blh"], args["bll"],
                   args["amps"], gs, 16)
    assert nudft_cuda.launches == 0


# --------------------------------------------------------------------------
# gradient moments (K1b) and extended sources (K1c)
# --------------------------------------------------------------------------

GRAD_BAR = 5e-6     # max|dG| / max|G| (tests/test_pallas_nudft.py:144)
EXT_BAR = 3e-6      # max|dV| / max|V| with gaussian weights (:179)
MODES = {"grad": (True, False), "ext": (False, True), "both": (True, True)}


@pytest.fixture(scope="module", params=sorted(MODES))
def mode_case(request):
    """S=60, B=11, C=32, chan0=3, 150 m baselines; sigma in [20, 200] with
    every third source a point source (inf)."""
    grad, ext = MODES[request.param]
    S, B, C, chan0 = 60, 11, 32, 3
    se, bl, amps, freqs = _problem(S, B, C, chan0, 150.0, seed=5)
    s_sky = (se + np.asarray([0.0, 0.0, 1.0])).astype(np.float32)
    rng = np.random.RandomState(6)
    sigma = rng.uniform(20.0, 200.0, S).astype(np.float32)
    sigma[::3] = np.inf
    sigma = sigma if ext else None
    seh, sel = tft.split_f64(se)
    blh, bll = tft.split_f64(bl)
    got = nt.nudft_visibilities(
        *(torch.as_tensor(x) for x in (seh, sel, blh, bll, amps)),
        nt.freq_grid_scalars(NU0, DNU), C, chan0=chan0,
        s_sky=torch.as_tensor(s_sky), gradient=grad, src_block=16,
        src_shape_sigma=None if sigma is None else torch.as_tensor(sigma))
    gold = nj.nudft_reference_f64(se, bl, amps, freqs, s_sky=s_sky,
                                  src_shape_sigma=sigma, gradient=grad)
    if not grad:
        got, gold = (got, None), (gold, None)
    jx = tuple(jnp.asarray(x) for x in (seh, sel, blh, bll, amps))
    return dict(got=tuple(None if x is None else x.numpy() for x in got),
                gold=gold, grad=grad, ext=ext, jx=jx, C=C, chan0=chan0,
                se=se, bl=bl, amps=amps, freqs=freqs, s_sky=s_sky,
                sigma=sigma)


def _check_modes(case, want):
    """The port's (vis, moments) against `want` at the bars of
    tests/test_pallas_nudft.py, both scaled by the f64 golden."""
    if not case["grad"]:
        want = (want, None)
    vbar = EXT_BAR if case["ext"] else BAR
    vg, gg = case["gold"]
    assert _rel(case["got"][0], want[0], np.abs(vg).max()) < vbar
    if case["grad"]:
        assert case["got"][1].shape == (3,) + vg.shape
        assert case["got"][1].dtype == np.complex64
        assert _rel(case["got"][1], want[1], np.abs(gg).max()) < GRAD_BAR


def test_modes_match_f64_golden(mode_case):
    _check_modes(mode_case, mode_case["gold"] if mode_case["grad"]
                 else mode_case["gold"][0])


def _xla_modes(c):
    """JAX's XLA engine on the mode case (computed once per case)."""
    if "xla" not in c:
        kw = dict(s_sky=jnp.asarray(c["s_sky"]), gradient=c["grad"])
        if c["ext"]:
            kw.update(src_shape_sigma=jnp.asarray(c["sigma"]),
                      inv_wl=jnp.asarray(c["freqs"] / CNST.c, jnp.float32))
        want = nj.nudft_visibilities(*c["jx"], nj.freq_grid_scalars(NU0, DNU),
                                     c["C"], chan0=c["chan0"], src_block=16,
                                     **kw)
        c["xla"] = (tuple(np.asarray(x) for x in want) if c["grad"]
                    else np.asarray(want))
    return c["xla"]


def _pallas_modes(c):
    """The Pallas kernel in interpret mode on the mode case (once)."""
    if "pallas" not in c:
        want = nudft_pallas(
            *c["jx"], nj.freq_grid_scalars(NU0, DNU), c["C"],
            chan0=c["chan0"], src_tile=16, bl_tile=8, interpret=True,
            s_sky=jnp.asarray(c["s_sky"]), gradient=c["grad"],
            src_shape_sigma=None if c["sigma"] is None
            else jnp.asarray(c["sigma"]))
        c["pallas"] = (tuple(np.asarray(x) for x in want) if c["grad"]
                       else np.asarray(want))
    return c["pallas"]


def test_modes_match_xla_engine(mode_case):
    _check_modes(mode_case, _xla_modes(mode_case))


def test_modes_match_pallas_interpret(mode_case):
    _check_modes(mode_case, _pallas_modes(mode_case))


@pytest.mark.parametrize("anchor", [None, 4, 16])
def test_modes_anchor_periods_match_golden_xla_and_pallas(mode_case,
                                                          anchor):
    """The plain K1b, K1c and both at once at every chain length of the
    anchored rotations that the kernels take (None: every phasor
    evaluated), against the f64 golden, JAX's XLA engine and the Pallas
    kernel in interpret mode, at the bars of tests/test_pallas_nudft.py."""
    c = mode_case
    sigma = None if c["sigma"] is None else torch.as_tensor(c["sigma"])
    got = nt.nudft_visibilities(
        *(torch.as_tensor(np.array(x)) for x in c["jx"]),
        nt.freq_grid_scalars(NU0, DNU), c["C"], chan0=c["chan0"],
        s_sky=torch.as_tensor(c["s_sky"]), gradient=c["grad"],
        src_block=16, src_shape_sigma=sigma, anchor=anchor)
    got = tuple(x.numpy() for x in got) if c["grad"] else (got.numpy(),
                                                           None)
    gold = c["gold"] if c["grad"] else c["gold"][0]
    for want in (gold, _xla_modes(c), _pallas_modes(c)):
        _check_modes(dict(c, got=got), want)


@pytest.mark.parametrize("mode", ["point"] + sorted(MODES))
def test_live_order_sums_equal_full_sums(mode):
    """The kernels' source order (live_order): the plain float64 sums over
    the live sources only, with directions, amplitudes, s_sky and sigma
    all taken through that order, equal the sums over every source within
    float64 rounding; the rows left out are all zero, and the live ones
    keep their order."""
    grad, ext = MODES.get(mode, (False, False))
    S, B, C = 90, 7, 32
    se, bl, amps, _ = _problem(S, B, C, 0, 150.0, seed=9)
    rng = np.random.RandomState(10)
    amps[rng.rand(S) < 0.33] = 0.0
    sigma = rng.uniform(20.0, 200.0, S).astype(np.float32)
    sigma[::4] = np.inf
    seh, sel = (torch.as_tensor(x) for x in tft.split_f64(se))
    blh, bll = (torch.as_tensor(x) for x in tft.split_f64(bl))
    a = torch.as_tensor(amps)
    s_sky = torch.as_tensor((se + [0.0, 0.0, 1.0]).astype(np.float32))
    sig = torch.as_tensor(sigma) if ext else None
    perm, n_live = live_order(a)
    n = int(n_live)
    assert perm.dtype == n_live.dtype == torch.int32
    live = np.flatnonzero((amps != 0).any(axis=1))
    assert n == live.size and np.array_equal(perm[:n].numpy(), live)
    assert not bool((a[perm[n:].long()] != 0).any())
    idx = perm[:n].long()
    gs = nt.freq_grid_scalars(NU0, DNU)
    full = nt._nudft_sums(seh, sel, blh, bll, a, gs, C, 0, sig,
                          s_sky, 16, grad, nt.ANCHOR)
    part = nt._nudft_sums(seh[idx], sel[idx], blh, bll, a[idx], gs, C, 0,
                          None if sig is None else sig[idx], s_sky[idx], 16,
                          grad, nt.ANCHOR)
    for f, p in zip(full, part):
        assert f.dtype == torch.float64 and f.shape == p.shape
        assert float((f - p).abs().max()) <= 1e-13 * float(f.abs().max())


def test_source_splits_fill_the_card():
    """The source splits of the NUDFT kernels: the north star's K1c grid of
    158 blocks on 132 SMs x 2 fills its last wave best at 5 splits; a
    grid that fills whole waves keeps 1; a handful of blocks takes the
    most, 8; every choice fills the waves at least as well as 1 split."""
    assert source_splits(158, 264) == 5
    assert source_splits(264, 264) == 1
    assert source_splits(2, 132) == 8
    for blocks in range(1, 600, 7):
        n = source_splits(blocks, 264)
        assert 1 <= n <= 8

        def fill(k):
            return blocks * k / (-(-blocks * k // 264) * 264)
        assert fill(n) >= fill(1)


def test_modes_torch_golden_matches_numpy_golden(mode_case):
    c = mode_case
    got = nt.nudft_reference_f64(c["se"], c["bl"], c["amps"], c["freqs"],
                                 s_sky=c["s_sky"], src_shape_sigma=c["sigma"],
                                 gradient=c["grad"], src_chunk=16)
    want = c["gold"] if c["grad"] else (c["gold"][0],)
    got = got if c["grad"] else (got,)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w, np.abs(w).max()) < 1e-12


def test_point_sigma_is_unweighted():
    """sigma = inf everywhere (a catalog of point sources with shapes
    given) is the point-source sum, and alpha is 0."""
    seh, sel, blh, bll, amps = _cpu_inputs()
    s_sky = torch.randn(8, 3)
    gs = nt.freq_grid_scalars(NU0, DNU)
    inf = torch.full((8,), float("inf"))
    assert torch.equal(nt.ext_alpha(s_sky, inf, blh, bll),
                       torch.zeros((8, 3)))
    got = nt.nudft_visibilities(seh, sel, blh, bll, amps, gs, 16,
                                s_sky=s_sky, src_shape_sigma=inf)
    assert torch.equal(got, nt.nudft_visibilities(seh, sel, blh, bll, amps,
                                                  gs, 16))


def test_ext_terms_match_pallas_formula():
    """alpha and (nu_c/c)^2 against the f32 formulas of the Pallas kernel
    (pallas_nudft.py:149-157, :290-291): the port takes them in float64
    and rounds once, so they agree to a few float32 ulps."""
    rng = np.random.RandomState(2)
    s = rng.randn(50, 3).astype(np.float32)
    blh, bll = (torch.as_tensor(x)
                for x in tft.split_f64(rng.randn(7, 3) * 300.0))
    sigma = rng.uniform(20.0, 200.0, 50).astype(np.float32)
    got = nt.ext_alpha(torch.as_tensor(s), torch.as_tensor(sigma), blh,
                       bll).numpy()
    blf = (blh + bll).numpy()
    ksky = s @ blf.T
    proj2 = np.maximum((blf * blf).sum(1)[None, :] - ksky * ksky, 0.0)
    want = 0.5 * proj2 / (sigma * sigma)[:, None]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * want.max())
    gs = nt.freq_grid_scalars(NU0, DNU)
    k2 = nt.ext_chan_scale(gs, 40, chan0=5).numpy()
    x = (np.float32(gs[0]) + np.float32(gs[1])) + (
        np.float32(gs[2]) + np.float32(gs[3])) * (5 + np.arange(40,
                                                                dtype=np.float32))
    np.testing.assert_allclose(k2, x * x, rtol=1e-6)


def test_wrapper_on_cpu_runs_plain_modes_and_does_not_count():
    seh, sel, blh, bll, amps = _cpu_inputs()
    gs = nt.freq_grid_scalars(NU0, DNU)
    s_sky = torch.rand(8, 3)
    sigma = torch.full((8,), 40.0)
    counts = (nudft_cuda.launches, nudft_cuda.launches_grad,
              nudft_cuda.launches_ext)
    kw = dict(s_sky=s_sky, src_shape_sigma=sigma, gradient=True)
    got = nudft_cuda(seh, sel, blh, bll, amps, gs, 16, **kw)
    want = nt.nudft_visibilities(seh, sel, blh, bll, amps, gs, 16, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (nudft_cuda.launches, nudft_cuda.launches_grad,
            nudft_cuda.launches_ext) == counts == (0, 0, 0)


@pytest.mark.parametrize("bad", ["no_s_sky", "s_sky_shape", "sigma_dtype",
                                 "sigma_shape"])
def test_wrapper_rejects_bad_mode_inputs(bad):
    seh, sel, blh, bll, amps = _cpu_inputs()
    kw = dict(s_sky=torch.rand(8, 3), src_shape_sigma=torch.full((8,), 40.0))
    err = ValueError
    if bad == "no_s_sky":
        kw["s_sky"] = None
    elif bad == "s_sky_shape":
        kw["s_sky"] = kw["s_sky"][:5]
    elif bad == "sigma_dtype":
        kw["src_shape_sigma"], err = kw["src_shape_sigma"].double(), TypeError
    else:
        kw["src_shape_sigma"] = kw["src_shape_sigma"][:, None]
    with pytest.raises(err):
        nudft_cuda(seh, sel, blh, bll, amps, nt.freq_grid_scalars(NU0, DNU),
                   16, gradient=True, **kw)


@pytest.mark.parametrize("kw", [dict(gradient=True),
                                dict(src_shape_sigma=torch.ones(8))])
def test_plain_modes_need_s_sky(kw):
    seh, sel, blh, bll, amps = _cpu_inputs()
    with pytest.raises(ValueError, match="s_sky"):
        nt.nudft_visibilities(seh, sel, blh, bll, amps,
                              nt.freq_grid_scalars(NU0, DNU), 16, **kw)
