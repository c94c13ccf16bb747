"""The banded engine's prep on the CPU: make_banded_snapshot_fns takes the
plain version banded_prep_plain (the torch chain) for CPU tensors, and its
outputs are those of the chain as the engine ran it before kernel
banded_prep (the rotation, the payload, then _prep), bit for bit; the
truth payload is computed inside the prep only for the driver's Airy
float64 form; the wrapper of the kernel checks its inputs before it asks
for a card. The kernel itself is held against the chain on the card, in
tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest
import torch

from prisim_tpu_torch import baselines, layouts
from prisim_tpu_torch import twofloat as tf
from prisim_tpu_torch.beams.analytic import airy_beam, airy_beam_df
from prisim_tpu_torch.engine import cuda_prep
from prisim_tpu_torch.engine import nufft_banded as nb
from prisim_tpu_torch.engine.nufft_delay import (chebyshev_node_model,
                                                 chebyshev_projection)
from prisim_tpu_torch.engine.observe import (Instrument, SkySources,
                                             df_rotate3,
                                             enu_rotation_from_eq)
from prisim_tpu_torch.skymodel import SkyModel

C, RANK, NU0 = 32, 8, 150e6


@pytest.fixture(scope="module")
def hera7():
    """HERA-7 (21 baselines), 32 x 1 MHz channels, 300 power-law sources,
    a 14 m Airy dish, the rotation at LST 30 deg and a zenith centre."""
    freqs = NU0 + 1e6 * np.arange(C)
    vec = baselines.build_baselines(layouts.preset_layout("HERA-7"),
                                    redundant=False).vectors
    rng = np.random.default_rng(7)
    S = 300
    model = SkyModel(
        location=np.stack([rng.uniform(0, 360, S), rng.uniform(-75, 15, S)],
                          axis=-1),
        spec_kind="power-law", spec_parms={
            "flux-scale": rng.uniform(0.5, 2.0, S),
            "freq-ref": np.full(S, 150e6),
            "power-law-index": rng.uniform(-1.0, -0.6, S)})
    Mh, Ml = tf.split_f64(enu_rotation_from_eq(30.0, -30.72))
    pch, pcl = tf.split_f64(np.asarray([0.0, 0.0, 1.0]))
    return dict(freqs=freqs, vec=vec, model=model,
                inst=Instrument.build(vec, freqs, "cpu", latitude=-30.72),
                sched=tuple(torch.as_tensor(a) for a in (Mh, Ml, pch, pcl)))


def _beam(s, f, pc=None):
    return airy_beam(s, f, 14.0)


def _truth(d, rank, form):
    """The truth-amps dict of `form`: the driver's Airy form, marked with
    its diameter ("airy"), the same pattern unmarked ("unmarked"), another
    callable ("other")."""
    nm = chebyshev_node_model(d["freqs"], rank)
    fn = {"airy": functools.partial(airy_beam_df, diameter=14.0),
          "unmarked": functools.partial(airy_beam_df, diameter=14.0),
          "other": lambda h, l, f: airy_beam_df(h, l, f, 14.0)}[form]
    truth = {"beam_df": fn,
             "flux_nodes": d["model"].generate_spectrum(nm.nu_nodes)}
    if form == "airy":
        truth["airy_diameter"] = 14.0
    return truth


def _snapshot_fns(d, mode, rank=RANK, T_s=128, src_chunk=None):
    kw = dict(src_chunk=src_chunk)
    if mode.startswith("truth"):
        kw["truth"] = _truth(d, rank, mode.split("_")[1])
    if mode == "projection":
        kw["node_model"] = False
    plan = nb.make_banded_plan(d["vec"], NU0, 1e6, C, rank=rank, T_s=T_s)
    pinvQ, Q = chebyshev_projection(d["freqs"], rank)
    sky = SkySources.from_skymodel(d["model"], d["freqs"], "cpu")
    return plan, nb.make_banded_snapshot_fns(d["inst"], sky, _beam, plan,
                                             pinvQ, Q, **kw), kw, sky


def _chain(plan, run, kw, sky, d, c):
    """Chunk c's prep as the engine computed it before the kernel: the
    rotation and centring, the payload from the rotated vectors, _prep."""
    Mh, Ml, pch, pcl = d["sched"]
    perm = nb.spatial_permutation(tf.join_f64(sky.s_eq_hi, sky.s_eq_lo))
    sky = nb.reorder_sources(sky, perm)
    # the sky padded to whole chunks: zenith rows of zero flux
    pad = run.n_chunks * run.src_chunk - sky.flux.shape[0]
    zen = torch.zeros((pad, 3))
    zen[:, 2] = 1.0
    seqh = torch.cat([sky.s_eq_hi, zen])
    seql = torch.cat([sky.s_eq_lo, torch.zeros((pad, 3))])
    sl = slice(c * run.src_chunk, (c + 1) * run.src_chunk)
    sh, slo = df_rotate3(Mh, Ml, seqh[sl], seql[sl])
    seh, sel = tf.df_add(sh, slo, -pch[None, :], -pcl[None, :])
    if "truth" in kw:
        coeffs_df = nb.make_coeff_fn_truth(d["freqs"], plan.rank,
                                           kw["truth"]["beam_df"])
        fn64 = np.asarray(kw["truth"]["flux_nodes"], np.float64)[perm]
        fn64 = torch.as_tensor(np.concatenate(
            [fn64, np.zeros((pad, plan.rank))]))
        P = coeffs_df(sh, slo, fn64[sl])
    else:
        pinvQ, _ = chebyshev_projection(d["freqs"], plan.rank)
        flux = torch.cat([sky.flux, torch.zeros((pad, C))])
        P = nb.make_coeff_fn(d["freqs"], plan.rank, pinvQ, _beam,
                             node_model=kw.get("node_model", True))(
            sh, flux[sl], pch)
    seh, sel = seh.contiguous(), sel.contiguous()
    return nb._prep(plan, seh, sel, P), P, seh, sel


@pytest.mark.parametrize("mode,rank,src_chunk", [
    ("truth_airy", RANK, None), ("truth_airy", RANK, 100),
    ("truth_other", RANK, None), ("f32", RANK, None),
    ("projection", RANK, 100), ("truth_airy", 40, None)])
def test_cpu_prep_is_the_chain_bit_for_bit(hera7, monkeypatch, mode, rank,
                                           src_chunk):
    """CPU tensors never reach the kernel's wrapper; each chunk's u
    streams, payload rows and ok are the chain's bit for bit, whichever
    payload (the Airy truth form inside the prep, another truth beam, the
    f32 node model, the projection form), with 100-source chunks that the
    tile pads, and at rank 40, past the kernel's 32, where the payload
    follows the prep."""
    def no_card(*a, **k):
        raise AssertionError("the CUDA wrapper was called for CPU tensors")
    monkeypatch.setattr(nb, "banded_prep_cuda", no_card)
    plan, run, kw, sky = _snapshot_fns(hera7, mode, rank=rank,
                                       src_chunk=src_chunk)
    assert run.n_chunks == (3 if src_chunk else 1)
    for c in range(run.n_chunks):
        got = run.prep_chunk(c, *hera7["sched"])
        want = _chain(plan, run, kw, sky, hera7, c)[0]
        assert bool(got[3]) and bool(want[3])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("mode", ["truth_airy", "f32"])
def test_cpu_gate_takes_the_chains_vectors_and_payload(hera7, monkeypatch,
                                                       mode):
    """The gate's direct side gets the chain's rotated and centred vectors
    and payload (S, r), contiguous, bit for bit."""
    plan, run, kw, sky = _snapshot_fns(hera7, mode)
    seen = []
    orig = nb.direct_visibilities

    def spy(seh, sel, inst, amps, block):
        seen.append((seh, sel, amps))
        return orig(seh, sel, inst, amps, block)
    monkeypatch.setattr(nb, "direct_visibilities", spy)
    direct0, banded0, ok, resid, scale = run.gate_fn(*hera7["sched"])
    _, P_want, seh_want, sel_want = _chain(plan, run, kw, sky, hera7, 0)
    assert ok and np.isfinite(banded0).all() and scale > 0
    seh, sel, amps = seen[0]
    assert torch.equal(seh, seh_want) and torch.equal(sel, sel_want)
    if mode.startswith("truth"):
        model = P_want @ torch.as_tensor(run.node_model.Q64).t()
        assert torch.equal(amps, nb._split64(model)[0])
    assert len(seen) == (2 if mode.startswith("truth") else 1)


def test_plain_prep_payload_is_the_truth_chain(hera7):
    """banded_prep_plain's Airy payload: (airy_beam_df at the nodes x the
    node fluxes) @ node2coef64, padded with zeros past S, and zero for
    every source below the horizon; without a payload P_r is None and the
    u streams and ok are the same."""
    plan = nb.make_banded_plan(hera7["vec"], NU0, 1e6, C, rank=RANK,
                               T_s=128)
    nm = chebyshev_node_model(hera7["freqs"], RANK)
    sky = SkySources.from_skymodel(hera7["model"], hera7["freqs"], "cpu")
    flux = torch.as_tensor(hera7["model"].generate_spectrum(nm.nu_nodes))
    n2c = torch.as_tensor(np.ascontiguousarray(nm.node2coef64))
    airy = cuda_prep.AiryPayload(14.0, nm.nu_nodes, flux, n2c)
    args = (plan, sky.s_eq_hi, sky.s_eq_lo) + hera7["sched"]
    u_h, u_l, P_r, ok, vecs = nb.banded_prep_plain(*args, airy=airy,
                                                   vectors=True)
    sh, slo, seh, sel = vecs
    P = nb.make_coeff_fn_truth(hera7["freqs"], RANK, functools.partial(
        airy_beam_df, diameter=14.0))(sh, slo, flux)
    assert torch.equal(P, (airy_beam_df(sh, slo, nm.nu_nodes, 14.0) * flux)
                       @ n2c)
    assert P_r.shape == (RANK, 384) and P_r.dtype == torch.float64
    assert torch.equal(P_r[:, :300], P.t()) and not P_r[:, 300:].any()
    below = (sh.double() + slo.double())[:, 2] <= 0
    assert 0 < int(below.sum()) < 300
    assert not P_r[:, :300][:, below].any()
    assert P_r[:, :300][:, ~below].abs().sum(dim=0).min() > 0
    u2 = nb.banded_prep_plain(*args)
    assert u2[2] is None and u2[4] is None
    assert torch.equal(u2[0], u_h) and torch.equal(u2[1], u_l)
    assert bool(u2[3]) and bool(ok)
    assert torch.equal(u_h.reshape(-1, 384)[:, 300:],
                       torch.full((plan.ndir, 84), 3.0))


@pytest.mark.parametrize("form,rank,airy", [
    ("airy", RANK, True), ("other", RANK, False),
    ("unmarked", RANK, False), ("airy", 40, False)])
def test_the_prep_computes_the_payload_for_the_airy_form_alone(
        hera7, monkeypatch, form, rank, airy):
    """The prep is handed an AiryPayload only where the truth dict gives
    the Airy dish's diameter and the rank fits the kernel; every other
    payload, the same Airy pattern unmarked included, is computed after
    it, from its rotated vectors."""
    calls = []
    orig = nb.banded_prep_plain

    def spy(*a, **k):
        calls.append(k)
        return orig(*a, **k)
    monkeypatch.setattr(nb, "banded_prep_plain", spy)
    _, run, _, _ = _snapshot_fns(hera7, "truth_" + form, rank=rank)
    run.prep_chunk(0, *hera7["sched"])
    (k,) = calls
    assert (k["airy"] is not None) == airy and k["vectors"] == (not airy)
    if airy:
        assert k["airy"].diameter == 14.0
        assert k["airy"].flux_nodes.shape == (run.src_chunk, rank)


@pytest.mark.parametrize("telescope,diameter", [
    ("hera", 14.0), ("hirax", 6.0), ("vla", None)])
def test_driver_truth_form_carries_the_dish_diameter(telescope, diameter):
    """The driver's truth dict gives the Airy dish's diameter beside its
    truth pattern (HERA 14 m, HIRAX 6 m); a beam with no truth form (the
    VLA's) gives no truth dict at all."""
    from prisim_tpu_torch import config, driver
    parms = config.load_parms({
        "telescope": {"id": telescope, "latitude": -30.7},
        "array": {"layout": "HERA-7"},
        "bandpass": {"nchan": 16, "freq": 150e6,
                     "freq_resolution": 390625.0},
        "obsparm": {"n_acc": 1, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 32, "seed": 2},
        "processing": {"engine": "nufft"},
        "save_formats": {"fmt": "none", "npz": False}})
    sim = driver.prepare_simulation(parms, torch.device("cpu"))
    truth = driver._banded_settings(parms, sim)[2]
    if diameter is None:
        assert truth is None and not hasattr(sim.beam_fn, "df_airy")
        return
    assert truth["airy_diameter"] == sim.beam_fn.df_airy == diameter
    assert truth["beam_df"] is sim.beam_fn.df_eval


def _wrapper_args(S=10, r=RANK):
    plan = nb.make_banded_plan([[14.6, 0.0, 0.0], [0.0, 29.2, 0.0]], NU0,
                               1e6, C, rank=r, T_s=128)
    nm = chebyshev_node_model(NU0 + 1e6 * np.arange(C), r)
    s = torch.zeros((S, 3))
    s[:, 2] = 1.0
    M = torch.eye(3)
    pc = torch.tensor([0.0, 0.0, 1.0])
    airy = cuda_prep.AiryPayload(
        14.0, nm.nu_nodes, torch.ones((S, r), dtype=torch.float64),
        torch.as_tensor(np.ascontiguousarray(nm.node2coef64)))
    return plan, [s, torch.zeros_like(s), M, torch.zeros_like(M), pc,
                  torch.zeros_like(pc)], airy


def _bad_cases():
    """(exception, how the arguments are spoiled) for each check that needs
    no card."""
    def arg(i, fn):
        return lambda plan, a, airy: (plan, a[:i] + [fn(a[i])] + a[i + 1:],
                                      airy)

    def pay(**k):
        return lambda plan, a, airy: (plan, a, airy._replace(**k))
    return {
        "s_float64": (TypeError, arg(0, lambda t: t.double())),
        "s_lo_rows": (ValueError, arg(1, lambda t: t[:5])),
        "s_not_contiguous": (ValueError, arg(0, lambda t: t.t().contiguous()
                                             .t())),
        "s_list": (TypeError, arg(0, lambda t: t.tolist())),
        "s_empty": (ValueError, arg(0, lambda t: t[:0])),
        "rotation_shape": (ValueError, arg(2, lambda t: t[:2])),
        "rotation_lo_float64": (TypeError, arg(3, lambda t: t.double())),
        "centre_shape": (ValueError, arg(4, lambda t: t[:, None])),
        "centre_on_meta": (ValueError, arg(5, lambda t: t.to("meta"))),
        "flux_rows": (ValueError, pay(flux_nodes=torch.ones(
            (9, RANK), dtype=torch.float64))),
        "flux_float32": (TypeError, pay(flux_nodes=torch.ones((10, RANK)))),
        "node2coef_shape": (ValueError, pay(node2coef64=torch.ones(
            (RANK, RANK - 1), dtype=torch.float64))),
        "nodes_shape": (ValueError, pay(nu_nodes=np.ones(RANK - 1))),
        "past_the_tail_fit": (ValueError, pay(diameter=1000.0)),
        "cpu_tensors": (ValueError, lambda plan, a, airy: (plan, a, airy)),
        "cpu_tensors_no_payload": (ValueError,
                                   lambda plan, a, airy: (plan, a, None)),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_banded_prep_cuda_rejects_bad_inputs(case):
    """Each bad input raises before any launch: types, dtypes, shapes,
    contiguity and devices of the vectors and the frame, the payload's
    shapes and dtypes and its dish past airy_beam_df's tail fit, and CPU
    tensors (the wrapper runs on CUDA tensors only)."""
    exc, spoil = _bad_cases()[case]
    plan, args, airy = spoil(*_wrapper_args())
    n0 = cuda_prep.banded_prep_cuda.launches
    with pytest.raises(exc):
        cuda_prep.banded_prep_cuda(plan, *args, airy=airy)
    assert cuda_prep.banded_prep_cuda.launches == n0


def test_banded_prep_cuda_rejects_a_rank_past_the_kernel():
    plan, args, airy = _wrapper_args(r=40)
    with pytest.raises(ValueError, match="rank"):
        cuda_prep.banded_prep_cuda(plan, *args, airy=airy)
