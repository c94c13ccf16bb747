"""The port's banded NUFFT engine against prisim_tpu on the same
numpy-seeded inputs: the nufft_delay pieces, the truth Airy beam, the
plan, the prep, the rows of the plain version of kernel K2, the post, the
snapshot functions and their gate.

JAX runs its Pallas spread in interpret mode, as tests/test_nufft_banded.py
does; the port runs banded_spread_plain (CPU tensors). The port sums the
rows in float64 where JAX's kernel sums in float32 with Kahan carries, so
the tolerances below are JAX's float32 error, stated case by case."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prisim_tpu import baselines as bls_jax
from prisim_tpu import constants as CNST
from prisim_tpu import layouts as lay
from prisim_tpu import twofloat as tf_jax
from prisim_tpu.beams import analytic as ab_jax
from prisim_tpu.engine import Instrument as InstJ, SkySources as SkyJ
from prisim_tpu.engine import enu_rotation_from_eq
from prisim_tpu.engine import nufft_banded as nb_jax
from prisim_tpu.engine import nufft_delay as nd_jax
from prisim_tpu.skymodel import SkyModel

from prisim_tpu_torch.beams import analytic as ab_t
from prisim_tpu_torch.engine import nufft_banded as nb_t
from prisim_tpu_torch.engine import nufft_delay as nd_t
from prisim_tpu_torch.engine.cuda_banded import (banded_spread_cuda,
                                                banded_worklist_cuda)
from prisim_tpu_torch.engine.observe import Instrument as InstT, \
    SkySources as SkyT

NU0, DNU = 150e6, 97656.25


def _sources(S, seed):
    """Unit upper-hemisphere vectors minus a zenith phase centre, as
    two-float numpy pairs."""
    rng = np.random.RandomState(seed)
    v = rng.randn(S, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 2] = np.abs(v[:, 2])
    return tf_jax.split_f64(v - np.asarray([0.0, 0.0, 1.0])), rng


def _hera7_pairs():
    return bls_jax.build_baselines(lay.preset_layout("HERA-7"),
                                   redundant=False).vectors


# (baselines, nchan, rank, T_s, S): a ragged last tile; a multi-block sweep
# of long baselines; the HERA-7 all-pairs set, which collapses 21 -> 9
SPREAD_CASES = {
    "ragged": (np.random.RandomState(0).uniform(-60, 60, (12, 3))
               * [1.0, 1.0, 0.05], 64, 6, 128, 300),
    "multiblock": (np.asarray([[14.6, 0, 0], [58.4, 0, 0], [131.4, 0, 0],
                               [292.0, 0, 0], [7.3, 12.64, 0],
                               [109.5, 189.6, 0], [-200.0, 35.0, 1.0]]),
                   512, 4, 256, 1024),
    "collapse": (_hera7_pairs(), 64, 8, 128, 256),
}


def _plans(case, **kw):
    bl, C, r, T_s, _ = SPREAD_CASES[case]
    return (nb_jax.make_banded_plan(bl, NU0, DNU, C, rank=r, T_s=T_s, **kw),
            nb_t.make_banded_plan(bl, NU0, DNU, C, rank=r, T_s=T_s, **kw))


def test_nufft_delay_pieces_match_jax():
    """Host numpy pieces equal exactly; the f32 blocked-Kahan projection
    agrees to 1e-6 of max|P| (f32 matmul rounding, ~sqrt(128) eps)."""
    z = np.linspace(-6, 6, 97)
    alpha = np.pi * 9 * 0.75 - 0.01
    np.testing.assert_array_equal(nd_t.kb_kernel(z, 9, alpha),
                                  nd_jax.kb_kernel(z, 9, alpha))
    xi = np.linspace(-0.5, 0.5, 65)
    np.testing.assert_array_equal(nd_t.kb_fourier(xi, 9, alpha),
                                  nd_jax.kb_fourier(xi, 9, alpha))
    np.testing.assert_array_equal(nd_t.kb_tap_coeffs(9, alpha, degree=10),
                                  nd_jax.kb_tap_coeffs(9, alpha, degree=10))
    freqs = 120e6 + 1e6 * np.arange(200)
    for a, b in zip(nd_t.chebyshev_projection(freqs, 12),
                    nd_jax.chebyshev_projection(freqs, 12)):
        np.testing.assert_array_equal(a, b)
    nm_t, nm_j = (m.chebyshev_node_model(freqs, 12) for m in (nd_t, nd_jax))
    for f in dataclasses.fields(nm_j):
        np.testing.assert_array_equal(getattr(nm_t, f.name),
                                      getattr(nm_j, f.name), err_msg=f.name)
    rng = np.random.RandomState(4)
    amps = rng.rand(300, 200).astype(np.float32)
    pinvQ, _ = nd_jax.chebyshev_projection(freqs, 12)
    want = np.asarray(nd_jax.spectral_project(jnp.asarray(amps), pinvQ))
    got = nd_t.spectral_project(torch.as_tensor(amps), pinvQ).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_airy_beam_df_matches_jax_and_true_j1():
    """The float64 truth Airy against JAX's two-float airy_beam_df (hi+lo)
    and against 2 J1(x)/x from the f64 integral J1: 2e-9 absolute, the
    accuracy JAX claims for its two-float form."""
    (sh, sl), rng = _sources(1500, seed=2)
    s = tf_jax.join_f64(sh, sl) + np.asarray([0.0, 0.0, 1.0])
    sh, sl = tf_jax.split_f64(s)
    sh[:50, 2] *= -1.0                       # some below the horizon
    sl[:50, 2] *= -1.0
    freqs = np.linspace(100e6, 205e6, 24)    # x up to ~30 at 14 m
    assert ab_t.airy_df_available(freqs, 14.0)
    assert not ab_t.airy_df_available(freqs * 1.2, 14.0)
    got = ab_t.airy_beam_df(torch.as_tensor(sh), torch.as_tensor(sl),
                            freqs, 14.0).numpy()
    hi, lo = ab_jax.airy_beam_df(jnp.asarray(sh), jnp.asarray(sl), freqs,
                                 14.0)
    want = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    assert np.abs(got - want).max() <= 2e-9
    s64 = tf_jax.join_f64(sh, sl)
    x = (np.sqrt(np.minimum(s64[:, 0] ** 2 + s64[:, 1] ** 2, 1.0))[:, None]
         * np.pi * freqs[None, :] * 14.0 / CNST.c)
    j1 = ab_t._j1_true(x.ravel()).reshape(x.shape)
    true = np.where(x > 0, 2.0 * j1 / np.where(x > 0, x, 1.0), 1.0) ** 2
    true = np.where(s64[:, 2:3] > 0, true, 0.0)
    assert np.abs(got - true).max() <= 2e-9
    assert np.all(got[:50] == 0.0)


@pytest.mark.parametrize("case", sorted(SPREAD_CASES))
def test_plan_fields_match_jax(case):
    """Every plan field equals JAX's: the same arrays with the same dtypes,
    the same scalars and consts."""
    pj, pt = _plans(case)
    for f in dataclasses.fields(pj):
        a, b = getattr(pj, f.name), getattr(pt, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name
    if case == "collapse":
        assert pt.nbl == 9 and pt.nbl_full == 21
    if case == "multiblock":
        assert pt.n_blk_max >= 4
    np.testing.assert_array_equal(pt.ramp64.astype(np.complex64), pj.ramp)
    np.testing.assert_allclose(pt.deconv64, pj.deconv, rtol=1e-7)


def test_plan_guards():
    bl = np.asarray([[300.0, 0.0, 0.0]])
    with pytest.raises(ValueError, match="K must be odd"):
        nb_t.make_banded_plan(bl, NU0, DNU, 64, rank=1, K=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        nb_t.make_banded_plan(bl, NU0, DNU, 64, rank=1, G_blk=20)
    with pytest.raises(ValueError, match="K2's grid"):
        # ~300 km: more delay rows than K2's grid holds
        nb_t.make_banded_plan(np.asarray([[3e5, 0.0, 0.0]]), NU0, 100e3,
                              4096, rank=24)


def test_spatial_permutation_matches_jax():
    (sh, sl), _ = _sources(2000, seed=5)
    s = tf_jax.join_f64(sh, sl) + np.asarray([0.0, 0.0, 1.0])
    np.testing.assert_array_equal(nb_t.spatial_permutation(s),
                                  nb_jax.spatial_permutation(s))


def _unit(theta, phi):
    theta, phi = np.broadcast_arrays(theta, phi)
    return np.stack([np.sin(theta) * np.cos(phi), np.sin(theta)
                     * np.sin(phi), np.cos(theta)], axis=-1)


def _order_case(name):
    """Unit directions (S, 3) float64 of a spatial-order case."""
    from prisim_tpu_torch import ephemeris as eph
    from prisim_tpu_torch import healpix as hp_t
    if name == "random":
        (sh, sl), _ = _sources(2000, seed=5)
        return tf_jax.join_f64(sh, sl) + np.asarray([0.0, 0.0, 1.0])
    if name == "precessed_nside64":
        theta, phi = hp_t.pix2ang(64, np.arange(12 * 64 * 64))
        ra, dec = eph.precess_radec(np.degrees(phi), 90.0 - np.degrees(theta),
                                    eph.JD_J2000, eph.jyear_to_jd(2015.9))
        return _unit(np.radians(90.0 - dec), np.radians(ra))
    # on boundaries of the nside-512 pixels: the centres of a coarser grid
    # (their corners), the rings z = +-2/3, the base faces' edges in the
    # belt (0.5 + tt - 0.75 z an integer, tt = 2 phi / pi) and in the caps
    # (phi = k pi / 2), the poles and phi = 0 and 2 pi
    z = np.linspace(-2.0 / 3.0, 2.0 / 3.0, 41)
    tt = (np.arange(5)[:, None] - 0.5 + 0.75 * z[None, :]).ravel()
    zc = np.linspace(0.67, 0.999, 13)
    caps = np.concatenate([zc, -zc])
    phis = np.arange(5)[:, None] * 0.5 * np.pi + 0.0 * caps[None, :]
    ring = np.linspace(0.0, 2.0 * np.pi, 17)
    v = np.concatenate([
        hp_t.pix2vec(16, np.arange(12 * 16 * 16)),
        _unit(np.arccos(np.repeat(z, 5)), tt * 0.5 * np.pi),
        _unit(np.arccos(np.tile(caps, 5)), phis.ravel()),
        _unit(np.arccos(2.0 / 3.0), ring), _unit(np.arccos(-2.0 / 3.0), ring),
        _unit(np.asarray([0.0, np.pi, 1e-9, np.pi - 1e-9, 0.5 * np.pi,
                          0.5 * np.pi, 0.5 * np.pi]),
              np.asarray([0.0, 0.0, 0.3, 4.0, 0.0, 2.0 * np.pi,
                          2.0 * np.pi - 1e-15])),
        [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0],
         [1.0, -1e-20, 0.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]])
    return v


@pytest.mark.parametrize("case", ["random", "precessed_nside64",
                                  "boundaries"])
def test_spatial_order_is_the_host_permutation(case):
    """spatial_order, made from the two-float directions by torch, is the
    numpy spatial_permutation and JAX's, position for position: random
    directions, a HEALPix nside-64 sky precessed from J2000 (no direction
    near a boundary: no row takes the host), and directions on the
    boundaries of the nside-512 pixels, where torch's acos, cos or atan2
    may round across them and the host's pixel is taken for those rows."""
    s = _order_case(case)
    sh, sl = tf_jax.split_f64(s)
    s = tf_jax.join_f64(sh, sl)
    perm, n_host = nb_t.spatial_order(torch.as_tensor(sh),
                                      torch.as_tensor(sl))
    assert perm.dtype == torch.int64
    want = nb_t.spatial_permutation(s)
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(want, nb_jax.spatial_permutation(s))
    if case == "boundaries":
        assert 0 < n_host < s.shape[0]
    else:
        assert n_host == 0


def test_spatial_order_pixels_outside_the_margin_are_the_hosts():
    """The torch pixels equal the host's at every nside wherever no row is
    flagged near a boundary, on the boundary case, whose flagged rows are
    the only ones that may differ."""
    s = _order_case("boundaries")
    t = torch.as_tensor(s)
    x, y, z = t.unbind(1)
    r = torch.sqrt(x * x + y * y + z * z)
    zz = torch.cos(torch.acos(torch.clamp(z / r, -1.0, 1.0)))
    phi = torch.remainder(torch.atan2(y, x), 2.0 * np.pi)
    for nside in (1, 16, 512, 1024):
        pix, near = nb_t._ang2pix_nest(nside, zz, phi)
        host = nb_t._nest_pixels(s, nside)
        ok = ~near.numpy()
        np.testing.assert_array_equal(pix.numpy()[ok], host[ok])


@pytest.mark.parametrize("offset", ["array", "scalar"])
def test_powerlaw_node_fluxes_match_generate_spectrum(offset):
    """The node fluxes of a power-law sky made by torch in a given order
    equal SkyModel.generate_spectrum at the nodes in that order within 2
    float64 ulps (the two pow functions may round apart), ulps of the
    power-law term where an offset cancels part of it."""
    from prisim_tpu_torch.skymodel import SkyModel as SkyModelT
    rng = np.random.default_rng(11)
    S = 5000
    parms = {"flux-scale": rng.uniform(0.1, 50.0, S),
             "freq-ref": rng.uniform(100e6, 200e6, S),
             "power-law-index": rng.uniform(-3.0, 1.0, S),
             "flux-offset": (rng.uniform(-1.0, 1.0, S) if offset == "array"
                             else 0.25)}
    model = SkyModelT(location=np.zeros((S, 2)), spec_kind="power-law",
                      spec_parms=parms)
    nodes = nd_t.chebyshev_node_model(NU0 + DNU * np.arange(1024),
                                      32).nu_nodes
    perm = rng.permutation(S)
    got = nb_t.powerlaw_node_fluxes(parms, nodes)(torch.as_tensor(perm))
    want = model.generate_spectrum(nodes)[perm]
    assert got.dtype == torch.float64 and got.shape == (S, 32)
    term = np.abs(want - np.asarray(parms["flux-offset"])[perm][:, None]
                  if offset == "array" else want - 0.25)
    ulp = np.spacing(np.maximum(np.abs(want), term))
    assert np.all(np.abs(got.numpy() - want) <= 2 * ulp)


def _prep_both(case, seed=7, scale=1.0):
    pj, pt = _plans(case)
    S, r = SPREAD_CASES[case][4], pt.rank
    (sh, sl), rng = _sources(S, seed)
    sh, sl = tf_jax.split_f64(tf_jax.join_f64(sh, sl) * scale)
    P = rng.uniform(0.1, 1.0, (S, r)).astype(np.float32)
    out_j = nb_jax._prep(pj, jnp.asarray(sh), jnp.asarray(sl),
                         jnp.asarray(P))
    out_t = nb_t._prep(pt, torch.as_tensor(sh), torch.as_tensor(sl),
                       torch.as_tensor(P))
    return pj, pt, out_j, out_t


def test_prep_matches_jax():
    """Two-float u streams, their pads and the transposed payload: the
    same float32 operations in the same order, so bit-equal."""
    pj, pt, out_j, out_t = _prep_both("ragged")
    assert out_t[0].shape == (1, pt.ndir * 384)       # 300 -> 384 padded
    for a, b in zip(out_j[:3], out_t[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert bool(out_t[3]) and bool(out_j[3])
    assert np.all(out_t[0].reshape(pt.ndir, -1)[:, 300:].numpy() == 3.0)
    _, _, out_j, out_t = _prep_both("ragged", scale=3.0)   # non-unit
    assert not bool(out_t[3]) and not bool(out_j[3])


@pytest.fixture(scope="module", params=sorted(SPREAD_CASES))
def rows(request):
    pj, pt, out_j, out_t = _prep_both(request.param)
    rj = np.asarray(nb_jax._banded_spread(pj, *out_j[:3], interpret=True))
    rt = nb_t.banded_spread_plain(pt, *out_t[:3])
    return dict(case=request.param, pj=pj, pt=pt, rj=rj, rt=rt,
                out_t=out_t)


def test_spread_rows_match_jax(rows):
    """The plain K2 rows against JAX's interpret-mode Pallas sweep: 1e-6
    of max|rows| (JAX's f32 weights, carrier and MXU dot; the port's
    float64 rows are exact to ~1e-15)."""
    rj, rt = rows["rj"], rows["rt"]
    assert rt.dtype == torch.float64 and rt.shape == rj.shape
    scale = np.abs(rj).max()
    assert scale > 0
    assert np.abs(rt.numpy() - rj).max() / scale <= 1e-6


def test_post_matches_jax(rows):
    """_post on the same (JAX) rows: the port's complex128 torch.fft post
    against JAX's complex64 XLA post, 1e-6 of max|V| (f32 FFT rounding)."""
    pj, pt = rows["pj"], rows["pt"]
    Q = np.random.RandomState(1).rand(pt.nchan, pt.rank).astype(np.float32)
    vj = np.asarray(nb_jax._post(pj, jnp.asarray(rows["rj"]), Q))
    vt = nb_t._post(pt, torch.as_tensor(rows["rj"].astype(np.float64)),
                    Q).numpy()
    assert vt.shape == (pt.nbl_full, pt.nchan) and vt.dtype == np.complex128
    assert np.abs(vt - vj).max() / np.abs(vj).max() <= 1e-6


def test_wrapper_runs_plain_on_cpu(rows):
    """banded_spread_cuda on CPU tensors is the plain version, with no
    kernel launch counted; it checks its inputs."""
    pt, (u_h, u_l, P_r, _) = rows["pt"], rows["out_t"]
    n0 = banded_spread_cuda.launches
    got = banded_spread_cuda(pt, u_h, u_l, P_r)
    assert banded_spread_cuda.launches == n0
    assert torch.equal(got, rows["rt"])
    with pytest.raises(TypeError):
        banded_spread_cuda(pt, u_h.double(), u_l, P_r)
    with pytest.raises(ValueError):
        banded_spread_cuda(pt, u_h, u_l, P_r[:, :-1])


def _tap_items(pt, u_h, u_l, live):
    """Brute force: the (item, tile) pairs whose live sources put a tap in
    the item's rows, from each (baseline, source)'s first-tap row as
    banded_spread_plain bins it; and the number of such valid pairs."""
    from prisim_tpu_torch import twofloat as tft
    D, S = pt.ndir, live.numel()
    uh, ul = u_h.reshape(D, S), u_l.reshape(D, S)
    n_rb = -(-pt.R_max // nb_t.K2_ROWS)
    ivh, ivl = (torch.tensor(float(v)) for v in nb_t._split(
        pt.consts["inv_ch"]))
    need = set()
    n_pairs = 0
    for b in range(pt.nbl):
        d = int(pt.d_of_b[b])
        th, tl = tft.df_mul(torch.tensor(pt.blen_hi[b]),
                            torch.tensor(pt.blen_lo[b]), uh[d], ul[d])
        first = (torch.round(tft.df_mul(th, tl, ivh, ivl)[0]).long()
                 - pt.K // 2 - int(pt.blk_lo[b]) * pt.G_blk)
        ok = (live.bool() & (uh[d] < 2.5) & (first >= 0)
              & (first < int(pt.n_blk[b]) * pt.G_blk))
        n_pairs += int(ok.sum())
        for s in torch.nonzero(ok)[:, 0].tolist():
            for row in range(int(first[s]), int(first[s]) + pt.K):
                if row < pt.R_max:
                    need.add((b * n_rb + row // nb_t.K2_ROWS,
                              s // nb_t.K2_TILE))
    return need, n_pairs


def test_worklist_lists_every_tile_that_reaches(rows):
    """K2's worklist (plain version, what the CPU runs): every tile whose
    live sources put a tap in an item's rows is on the item's list, the
    lists are in tile order at their offsets, and a source with an all-zero
    payload (a third of them here) makes no tile live."""
    pt, (u_h, u_l, P_r, _) = rows["pt"], rows["out_t"]
    P = P_r.clone()
    P[:, np.random.RandomState(3).rand(P.shape[1]) < 0.33] = 0.0
    urange, counts, offsets, tiles = banded_worklist_cuda(pt, u_h, u_l, P)
    n_rb = -(-pt.R_max // nb_t.K2_ROWS)
    assert counts.shape == offsets.shape == (pt.nbl * n_rb,)
    assert int(counts.sum()) == tiles.numel()
    assert torch.equal(offsets, torch.cumsum(counts, 0) - counts)
    listed = set()
    for item in range(pt.nbl * n_rb):
        mine = tiles[offsets[item]:offsets[item] + counts[item]].tolist()
        assert mine == sorted(set(mine))
        listed.update((item, t) for t in mine)
    live = (P != 0).any(dim=0)
    need, n_pairs = _tap_items(pt, u_h, u_l, live)
    assert need and need <= listed
    assert nb_t.banded_pair_count(pt, u_h, u_l, P) == n_pairs > 0
    # the span of every listed tile holds a live source
    tile_live = live.reshape(-1, nb_t.K2_TILE).any(dim=1)
    assert all(bool(tile_live[t]) for _, t in listed)
    assert urange.shape == (pt.ndir, P.shape[1] // nb_t.K2_TILE, 2)


def test_spread_splits_fill_the_card():
    """K2 splits the item lists only where the live items leave the card
    idle: the HERA-37 slice's 156 live items (longest list ~150 tiles) on
    132 SMs x 2 blocks go 3 ways; a north-star chunk's 2,275 items fill
    the card and stay whole."""
    from prisim_tpu_torch.engine.cuda_banded import spread_splits
    assert spread_splits(156, 150, 264) == 3
    assert spread_splits(2275, 900, 264) == 1
    assert spread_splits(1, 1, 264) == 1
    for n_live in (1, 7, 64, 300, 5000):
        for longest in (1, 10, 1000):
            assert 1 <= spread_splits(n_live, longest, 264) <= 8


def test_banded_matches_f64_nufft_reference():
    """Flat spectra, rank 1: the port's banded visibilities against JAX's
    float64 numpy NUFFT (nufft_delay_visibilities, K=13): 1e-7 of max|V|,
    the K=9 kernel's own truncation error (JAX's f32 banded engine is
    held to 5e-6 there)."""
    (sh, sl), rng = _sources(512, seed=0)
    bl = SPREAD_CASES["ragged"][0][:7]
    amps = rng.uniform(0.1, 1.0, 512)
    tau = (tf_jax.join_f64(sh, sl) @ bl.T) / CNST.c
    gold = nd_jax.nufft_delay_visibilities(tau, amps, NU0, DNU, 64)
    plan = nb_t.make_banded_plan(bl, NU0, DNU, 64, rank=1, T_s=128)
    u_h, u_l, P_r, ok = nb_t._prep(plan, torch.as_tensor(sh),
                                   torch.as_tensor(sl),
                                   torch.as_tensor(amps[:, None]))
    vis = nb_t._post(plan, nb_t.banded_spread_plain(plan, u_h, u_l, P_r),
                     np.ones((64, 1)))
    assert bool(ok)
    assert np.abs(vis.numpy() - gold).max() / np.abs(gold).max() < 1e-7


# --------------------------------------------------------------------------
# snapshot functions and their gate
# --------------------------------------------------------------------------

C_SNAP, RANK_SNAP = 32, 8


def test_wrapper_adds_into_rows_on_cpu(rows):
    """banded_spread_cuda(..., rows=R) on CPU tensors adds the plain rows
    into R and returns R itself: R plus banded_spread_plain bit for bit;
    rows=None is banded_spread_plain. Rows of another shape, dtype or
    layout are refused before anything is added."""
    pt, (u_h, u_l, P_r, _) = rows["pt"], rows["out_t"]
    R = torch.as_tensor(np.random.RandomState(5).standard_normal(
        tuple(rows["rt"].shape)))
    want = R + rows["rt"]
    got = banded_spread_cuda(pt, u_h, u_l, P_r, rows=R)
    assert got is R and torch.equal(got, want)
    assert torch.equal(banded_spread_cuda(pt, u_h, u_l, P_r, rows=None),
                       nb_t.banded_spread_plain(pt, u_h, u_l, P_r))
    before = R.clone()
    with pytest.raises(TypeError):
        banded_spread_cuda(pt, u_h, u_l, P_r, rows=R.float())
    with pytest.raises(ValueError):
        banded_spread_cuda(pt, u_h, u_l, P_r, rows=R[:-1])
    with pytest.raises(ValueError):
        banded_spread_cuda(pt, u_h, u_l, P_r,
                           rows=R.transpose(0, 1).contiguous().transpose(0, 1))
    assert torch.equal(R, before)


@pytest.fixture(scope="module")
def snapshot_inputs():
    freqs = NU0 + 1e6 * np.arange(C_SNAP)
    vec = _hera7_pairs()
    rng = np.random.default_rng(7)
    S = 300
    model = SkyModel(
        location=np.stack([rng.uniform(0, 360, S), rng.uniform(-75, 15, S)],
                          axis=-1),
        spec_kind="power-law", spec_parms={
            "flux-scale": rng.uniform(0.5, 2.0, S),
            "freq-ref": np.full(S, 150e6),
            "power-law-index": rng.uniform(-1.0, -0.6, S)})
    Mh, Ml = tf_jax.split_f64(enu_rotation_from_eq(30.0, -30.72))
    pch, pcl = tf_jax.split_f64(np.asarray([0.0, 0.0, 1.0]))
    nm = nd_jax.chebyshev_node_model(freqs, RANK_SNAP)
    return dict(
        freqs=freqs, model=model, flux_nodes=model.generate_spectrum(
            nm.nu_nodes),
        inst_j=InstJ.build(vec, freqs, latitude=-30.72),
        inst_t=InstT.build(vec, freqs, "cpu", latitude=-30.72),
        sched=(Mh, Ml, pch, pcl),
        proj=nd_jax.chebyshev_projection(freqs, RANK_SNAP))


@pytest.mark.parametrize("mode", ["f32", "truth", "chunked", "projection"])
def test_snapshot_fns_and_gate_match_jax(snapshot_inputs, mode):
    """make_banded_snapshot_fns in both packages on HERA-7 (21 bl -> 9
    rows), 32 x 1 MHz channels, 300 power-law sources, Airy 14 m: the f32
    node model, the truth-amps path, 3 source chunks of 128, and the
    full-channel projection form (node_model=False). run()
    and the gate's banded and direct snapshots agree with JAX's to 2e-6
    of the coherent scale max_c sum_s |A| (JAX's f32 engines sit at
    ~7e-7 there); ok, the model residual and the coherent scale agree."""
    d = snapshot_inputs
    pinvQ, Q = d["proj"]
    kw = dict(src_chunk=128) if mode == "chunked" else {}
    if mode == "projection":
        kw["node_model"] = False
    kw_j, kw_t = dict(kw), dict(kw)
    if mode == "truth":
        kw_j["truth"] = {"beam_df": lambda h, l, f: ab_jax.airy_beam_df(
            h, l, f, 14.0), "flux_nodes": d["flux_nodes"]}
        kw_t["truth"] = {"beam_df": lambda h, l, f: ab_t.airy_beam_df(
            h, l, f, 14.0), "flux_nodes": d["flux_nodes"]}
    ij, it = d["inst_j"], d["inst_t"]
    pj = nb_jax.make_banded_plan(_hera7_pairs(), ij.nu0, ij.dnu, C_SNAP,
                                 rank=RANK_SNAP, T_s=128)
    pt = nb_t.make_banded_plan(_hera7_pairs(), it.nu0, it.dnu, C_SNAP,
                               rank=RANK_SNAP, T_s=128)
    run_j = nb_jax.make_banded_snapshot_fns(
        ij, SkyJ.from_skymodel(d["model"], d["freqs"]),
        lambda s, f: ab_jax.airy_beam(s, f, 14.0), pj, pinvQ, Q,
        interpret=True, **kw_j)
    run_t = nb_t.make_banded_snapshot_fns(
        it, SkyT.from_skymodel(d["model"], d["freqs"], "cpu"),
        lambda s, f: ab_t.airy_beam(s, f, 14.0), pt, pinvQ, Q, **kw_t)
    args_j = tuple(jnp.asarray(a) for a in d["sched"])
    args_t = tuple(torch.as_tensor(a) for a in d["sched"])
    vj, okj = run_j(*args_j)
    vt, okt = run_t(*args_t)
    gj, gt = run_j.gate_fn(*args_j), run_t.gate_fn(*args_t)
    assert run_t.n_chunks == (3 if mode == "chunked" else 1)
    assert (run_t.node_model is None) == (mode == "projection")
    assert run_t.truth == (mode == "truth")
    assert vt.shape == (21, C_SNAP) and vt.dtype == torch.complex64
    coherent = gt[4]
    np.testing.assert_allclose(coherent, gj[4], rtol=1e-6)
    assert bool(okt) and bool(okj) and gt[2] and gj[2]
    assert np.abs(vt.numpy() - np.asarray(vj)).max() / coherent <= 2e-6
    assert np.abs(gt[0] - gj[0]).max() / coherent <= 2e-6
    assert np.abs(gt[1] - gj[1]).max() / coherent <= 2e-6
    # run() and the gate's banded side are the same pipeline
    assert np.abs(vt.numpy() - gt[1]).max() / np.abs(gt[1]).max() <= 1e-6
    if mode == "truth":
        assert gt[3] > 0
        np.testing.assert_allclose(gt[3], gj[3], rtol=1e-3)
        # the transform alone: the port's f64 pipeline against its direct
        # engine on the same model amps, 1e-7 of the coherent scale
        assert np.abs(gt[1] - gt[0]).max() / coherent <= 1e-7
    else:
        assert gt[3] == 0.0 == gj[3]




def test_snapshot_fns_take_the_device_node_fluxes(snapshot_inputs):
    """The truth path with the node fluxes made in the spatial order by
    powerlaw_node_fluxes gives run() and the gate's readings of the host
    flux_nodes: bit for bit where the two node fluxes are bit-equal, else
    run() and the gate's banded side within 1e-15 of max|V|, and its
    direct side, two float32 sums over the model's hi/lo split, within
    1e-14 (a 1-ulp change of the lo part rounds anew in float32)."""
    d = snapshot_inputs
    pinvQ, Q = d["proj"]
    it = d["inst_t"]
    plan = nb_t.make_banded_plan(_hera7_pairs(), it.nu0, it.dnu, C_SNAP,
                                 rank=RANK_SNAP, T_s=128)
    sky = SkyT.from_skymodel(d["model"], d["freqs"], "cpu")
    args = tuple(torch.as_tensor(a) for a in d["sched"])
    nodes = nd_t.chebyshev_node_model(d["freqs"], RANK_SNAP).nu_nodes
    device_form = nb_t.powerlaw_node_fluxes(d["model"].spec_parms, nodes)
    outs = []
    for fl in (d["flux_nodes"], device_form):
        run = nb_t.make_banded_snapshot_fns(
            it, sky, lambda s, f: ab_t.airy_beam(s, f, 14.0), plan, pinvQ,
            Q, truth={"beam_df": lambda h, l, f: ab_t.airy_beam_df(
                h, l, f, 14.0), "flux_nodes": fl})
        assert run.truth
        outs.append((run(*args)[0].numpy(), run.gate_fn(*args)))
    (v0, g0), (v1, g1) = outs
    perm = torch.arange(sky.flux.shape[0])
    same = np.array_equal(device_form(perm).numpy(), d["flux_nodes"])
    scale = np.abs(v0).max()
    for a, b, bound in [(v0, v1, 1e-15), (g0[0], g1[0], 1e-14),
                        (g0[1], g1[1], 1e-15)]:
        if same:
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= bound * scale
    assert g0[2] and g1[2]
    if same:
        assert (g0[3], g0[4]) == (g1[3], g1[4])
    else:
        assert abs(g1[3] - g0[3]) <= 1e-15
        assert g1[4] == pytest.approx(g0[4], rel=1e-15)


@pytest.mark.parametrize("kind", ["power-law", "tanh", "spectrum"])
def test_driver_node_fluxes_follow_the_spectrum_kind(kind):
    """The driver's truth dict holds the device form of the node fluxes
    for a power-law sky, and the host generate_spectrum at the nodes for a
    tanh or a tabulated sky; each runs the banded engine, whose counters
    say that the CPU ordered every source and the card none."""
    from prisim_tpu_torch import config, driver, tracing
    from prisim_tpu_torch.engine.observe import schedule_tensors
    from prisim_tpu_torch.skymodel import SkyModel as SkyModelT
    parms = config.load_parms({
        "telescope": {"id": "hera", "latitude": -30.7},
        "array": {"layout": "HERA-7"},
        "bandpass": {"nchan": 32, "freq": 150e6, "freq_resolution": 1e6},
        "obsparm": {"n_acc": 1, "t_acc": 60.0},
        "processing": {"engine": "nufft"},
        "save_formats": {"fmt": "none", "npz": False}})
    rng = np.random.default_rng(4)
    S = 200
    loc = np.stack([rng.uniform(0, 360, S), rng.uniform(-75, 15, S)], -1)
    if kind == "power-law":
        sky = SkyModelT(location=loc, spec_kind=kind, spec_parms={
            "flux-scale": rng.uniform(1, 5, S), "freq-ref": np.full(S, 150e6),
            "power-law-index": rng.uniform(-1, 0, S)})
    elif kind == "tanh":
        sky = SkyModelT(location=loc, spec_kind=kind, spec_parms={
            "flux-scale": rng.uniform(1, 5, S), "freq-ref": np.full(S, 150e6),
            "z-width": np.full(S, 1.0), "flux-offset": np.zeros(S)})
    else:
        fm = np.linspace(140e6, 190e6, 6)
        sky = SkyModelT(location=loc, spec_kind=kind,
                        spectrum=rng.uniform(1, 5, (S, fm.size)),
                        freqs_model=fm)
    sim = driver.prepare_simulation(parms, torch.device("cpu"), sky=sky)
    rank, _, truth, _ = driver._banded_settings(parms, sim)
    nodes = nd_t.chebyshev_node_model(sim.freqs, rank).nu_nodes
    fl = truth["flux_nodes"]
    if kind == "power-law":
        assert callable(fl)
        got = fl(torch.arange(S)).numpy()
        want = sky.generate_spectrum(nodes)
        assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))
    else:
        assert isinstance(fl, np.ndarray)
        np.testing.assert_array_equal(fl, sky.generate_spectrum(nodes))
    with tracing.on():
        with tracing.span("simulation"):
            plan, snap = driver.banded_engine(parms, sim)
            v, ok = snap(*(a[0] for a in schedule_tensors(
                sim.obs, sim.inst.latitude, sim.inst.device)))
    recs = tracing.take()
    assert snap.truth and bool(ok) and bool(torch.isfinite(v).all())
    counts = {}
    for r in recs:
        for k, n in r["counts"].items():
            counts[k] = counts.get(k, 0) + n
    assert counts["plan.src"] == S and counts["plan.src_card"] == 0


@pytest.mark.parametrize("mode", ["f32", "truth"])
def test_snapshot_fns_invariant_to_source_order(snapshot_inputs, mode):
    """The spatial sort is unconditional, so the order in which the sky
    lists its sources does not reach the sums: a shuffled sky gives the
    same run() and gate to 1e-12 of the coherent scale (the sorted order
    is the same; only per-source float32 rounding may differ)."""
    d = snapshot_inputs
    pinvQ, Q = d["proj"]
    it = d["inst_t"]
    plan = nb_t.make_banded_plan(_hera7_pairs(), it.nu0, it.dnu, C_SNAP,
                                 rank=RANK_SNAP, T_s=128)
    sky = SkyT.from_skymodel(d["model"], d["freqs"], "cpu")
    shuffle = np.random.RandomState(3).permutation(sky.flux.shape[0])
    args = tuple(torch.as_tensor(a) for a in d["sched"])
    outs = []
    for perm in (np.arange(sky.flux.shape[0]), shuffle):
        kw = {}
        if mode == "truth":
            kw["truth"] = {"beam_df": lambda h, l, f: ab_t.airy_beam_df(
                h, l, f, 14.0), "flux_nodes": d["flux_nodes"][perm]}
        run = nb_t.make_banded_snapshot_fns(
            it, nb_t.reorder_sources(sky, perm),
            lambda s, f: ab_t.airy_beam(s, f, 14.0), plan, pinvQ, Q, **kw)
        outs.append((run(*args)[0].numpy(), run.gate_fn(*args)))
    (v0, g0), (v1, g1) = outs
    coherent = g0[4]
    assert np.abs(v1 - v0).max() / coherent <= 1e-12
    for a, b in zip(g0[:2], g1[:2]):
        assert np.abs(b - a).max() / coherent <= 1e-12
    assert g0[2] and g1[2] and abs(g1[3] - g0[3]) <= 1e-12


@pytest.mark.parametrize("mode", ["f32", "truth"])
def test_snapshot_fns_accumulate_the_chunks_rows(snapshot_inputs, mode):
    """run() and the gate's banded side add every chunk's spread into one
    rows array: their visibilities equal, bit for bit, the _post of the
    chunks' banded_spread_plain rows summed in chunk order (the first
    chunk's rows, then each next added), on 3 source chunks of 128."""
    d = snapshot_inputs
    pinvQ, Q = d["proj"]
    it = d["inst_t"]
    plan = nb_t.make_banded_plan(_hera7_pairs(), it.nu0, it.dnu, C_SNAP,
                                 rank=RANK_SNAP, T_s=128)
    kw = {}
    if mode == "truth":
        kw["truth"] = {"beam_df": lambda h, l, f: ab_t.airy_beam_df(
            h, l, f, 14.0), "flux_nodes": d["flux_nodes"]}
    run = nb_t.make_banded_snapshot_fns(
        it, SkyT.from_skymodel(d["model"], d["freqs"], "cpu"),
        lambda s, f: ab_t.airy_beam(s, f, 14.0), plan, pinvQ, Q,
        src_chunk=128, **kw)
    args = tuple(torch.as_tensor(a) for a in d["sched"])
    assert run.n_chunks == 3
    total = None
    for c in range(run.n_chunks):
        part = nb_t.banded_spread_plain(plan, *run.prep_chunk(c, *args)[:3])
        total = part if total is None else total.add_(part)
    nm = run.node_model
    Qc = torch.as_tensor(nm.Q64 if nm is not None else Q,
                         dtype=torch.float64)
    want = nb_t._post(plan, total, Qc)
    assert float(total.abs().max()) > 0
    assert torch.equal(run(*args)[0], want.to(torch.complex64))
    np.testing.assert_array_equal(run.gate_fn(*args)[1], want.numpy())
