"""The port's public API against the JAX package's, and the functions whose
signatures were brought back to JAX's, called the JAX way through both.

The first half parses both packages with `ast` (it imports neither): for
every public function, public class and public-class method of prisim_tpu
outside ROADMAP's "Not to be ported", the port has the same name in the
same module, and its parameters begin with JAX's, in JAX's order; the
port's own parameters come after them. The only exceptions are the tables
below, each entry resting on a line of ROADMAP.md that the test finds.

The second half calls the repaired functions with JAX's keywords and in
JAX's positional order through both packages on seeded numpy inputs, at
the bars of tests/test_pallas_nudft.py (2e-6 of max|V|, 5e-6 of max|G|,
3e-6 for extended sources), and checks the raising cases."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prisim_tpu import constants as CNST
from prisim_tpu import healpix as hp_j
from prisim_tpu import twofloat as tf_j
from prisim_tpu import windows as win_j
from prisim_tpu.baselines import build_baselines
from prisim_tpu.beams.analytic import airy_beam as airy_j
from prisim_tpu.engine import noise as noise_j
from prisim_tpu.engine import nudft as nudft_j
from prisim_tpu.engine import observe as obs_j
from prisim_tpu.layouts import preset_layout
from prisim_tpu.skymodel import healpix_diffuse_model

from prisim_tpu_torch import twofloat as tf_t
from prisim_tpu_torch import windows as win_t
from prisim_tpu_torch.beams.analytic import airy_beam as airy_t
from prisim_tpu_torch.convert import instrument_from_numpy, sky_from_numpy
from prisim_tpu_torch.engine import noise as noise_t
from prisim_tpu_torch.engine import nudft as nudft_t
from prisim_tpu_torch.engine import nufft_banded as nb_t
from prisim_tpu_torch.engine import observe as obs_t
from prisim_tpu_torch.engine.nufft_delay import chebyshev_projection

ROOT = pathlib.Path(__file__).resolve().parents[1]

# JAX names with no counterpart in the port, each with the text of its
# ROADMAP.md "Not to be ported" line
NOT_PORTED = {
    ("engine/pallas_nudft.py", "pallas_available"):
        "`engine/pallas_nudft.py`: its kernel is ported",
    ("engine/pallas_nudft.py", "nudft_pallas"):
        "`engine/pallas_nudft.py`: its kernel is ported",
    ("engine/pallas_nudft.py", "nudft_auto"):
        "`engine/pallas_nudft.py`: its kernel is ported",
    ("twofloat.py", "df_add_f"):
        "`twofloat.df_add_f`, `df_mul_f`, `df_neg` and `df_sqrt`",
    ("twofloat.py", "df_mul_f"):
        "`twofloat.df_add_f`, `df_mul_f`, `df_neg` and `df_sqrt`",
    ("twofloat.py", "df_neg"):
        "`twofloat.df_add_f`, `df_mul_f`, `df_neg` and `df_sqrt`",
    ("twofloat.py", "df_sqrt"):
        "`twofloat.df_add_f`, `df_mul_f`, `df_neg` and `df_sqrt`",
    ("utils.py", "put_complex"): "`utils.put_complex` / `get_complex`",
    ("utils.py", "get_complex"): "`utils.put_complex` / `get_complex`",
}

# JAX parameters the port renames (to a name) or drops (None): (module
# prefix, JAX name, port name, the text of its ROADMAP.md "Settled
# deviations" line)
PARAM_DEVIATIONS = [
    ("engine/noise.py", "key", "generator",
     "**Noise is drawn with `torch.Generator`** (R4)"),
    ("beams/", "key", "generator",
     "**Beamformer errors are drawn with `torch.Generator`**"),
    ("", "xp", None, "**No `xp` argument**"),
]


def _roadmap_section(start, end):
    text = (ROOT / "ROADMAP.md").read_text()
    i = text.index(start)
    return text[i:text.index(end, i)]


def _defs(pkg):
    """{(module path, qualified name): ast node} of a package's top-level
    functions and classes and the classes' methods."""
    out = {}
    base = ROOT / pkg
    for path in sorted(base.rglob("*.py")):
        mod = path.relative_to(base).as_posix()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out[(mod, node.name)] = node
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out[(mod, node.name + "." + m.name)] = m
    return out


def _public(mod, name):
    private = [p for p in mod[:-3].split("/") + name.split(".")
               if p.startswith("_") and not p.endswith("__")]
    return not private


JAX_DEFS = _defs("prisim_tpu")
PORT_DEFS = _defs("prisim_tpu_torch")
PUBLIC = sorted(k for k in JAX_DEFS if _public(*k) and k not in NOT_PORTED)


def _expected(mod, names):
    """JAX's parameter names as the port should carry them."""
    out = []
    for n in names:
        for prefix, jax_name, port_name, _ in PARAM_DEVIATIONS:
            if n == jax_name and mod.startswith(prefix):
                n = port_name
                break
        if n is not None:
            out.append(n)
    return out


def _params(fn):
    a = fn.args
    return ([p.arg for p in a.posonlyargs + a.args],
            [p.arg for p in a.kwonlyargs], a.vararg is not None,
            a.kwarg is not None)


@pytest.mark.parametrize("key", PUBLIC, ids=["%s::%s" % k for k in PUBLIC])
def test_public_name_has_jax_signature(key):
    mod, name = key
    jax_node = JAX_DEFS[key]
    assert key in PORT_DEFS, "%s::%s has no counterpart in the port" % key
    port_node = PORT_DEFS[key]
    assert isinstance(port_node, ast.ClassDef) == isinstance(
        jax_node, ast.ClassDef)
    if isinstance(jax_node, ast.ClassDef):
        return
    j_pos, j_kw, j_var, j_varkw = _params(jax_node)
    p_pos, p_kw, p_var, p_varkw = _params(port_node)
    want = _expected(mod, j_pos)
    assert p_pos[:len(want)] == want, (
        "positional parameters %s, JAX's %s" % (p_pos, want))
    missing = set(_expected(mod, j_kw)) - set(p_pos) - set(p_kw)
    assert not missing, "keyword-only parameters %s missing" % missing
    assert p_var >= j_var and p_varkw >= j_varkw, "*args or **kwargs lost"


@pytest.mark.parametrize("key", sorted(NOT_PORTED),
                         ids=["%s::%s" % k for k in sorted(NOT_PORTED)])
def test_not_ported_rests_on_roadmap(key):
    assert key in JAX_DEFS and key not in PORT_DEFS
    assert NOT_PORTED[key] in _roadmap_section("**Not to be ported**",
                                               "### Queue 2")


@pytest.mark.parametrize("entry", PARAM_DEVIATIONS,
                         ids=[e[1] + "@" + (e[0] or "*")
                              for e in PARAM_DEVIATIONS])
def test_param_deviation_rests_on_roadmap(entry):
    prefix, jax_name, _, line = entry
    assert line in _roadmap_section(
        "**Settled deviations of the port", "**Not to be ported**")
    used = [k for k in PUBLIC if k[0].startswith(prefix)
            and not isinstance(JAX_DEFS[k], ast.ClassDef)
            and jax_name in sum(_params(JAX_DEFS[k])[:2], [])]
    assert used, "no JAX function has the parameter %r" % jax_name


# --------------------------------------------------------------------------
# windows: float64 round-off on every axis
# --------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1, -1])
def test_windows_match_jax(axis):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 24, 10)) + 1j * rng.standard_normal(
        (6, 24, 10))
    df = 97656.25
    want = win_j.ifft_delay_transform(x, df, 0.5, axis, np)
    tx = torch.as_tensor(x)
    got_pos = win_t.ifft_delay_transform(tx, df, 0.5, axis).numpy()
    got_kw = win_t.ifft_delay_transform(tx, df, pad=0.5, axis=axis).numpy()
    assert np.array_equal(got_pos, got_kw)
    assert np.abs(got_pos - want).max() <= 1e-12 * np.abs(want).max()
    n_out = x.shape[axis] // 2 + 1
    want = win_j.downsample_fourier(x, n_out, axis, xp=np)
    got = win_t.downsample_fourier(tx, n_out, axis).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert np.array_equal(
        win_t.downsample_fourier(tx, n_out, axis=axis).numpy(), got)


# --------------------------------------------------------------------------
# nudft_visibilities in JAX's positional order
# --------------------------------------------------------------------------

NU0, DNU = 150e6, 97656.25


@pytest.fixture(scope="module")
def nudft_case():
    S, B, C, chan0 = 60, 9, 24, 5
    rng = np.random.RandomState(5)
    s = rng.randn(S, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    s[:, 2] = np.abs(s[:, 2])
    seh, sel = tf_j.split_f64(s - np.asarray([0.0, 0.0, 1.0]))
    blh, bll = tf_j.split_f64(rng.randn(B, 3) * 300.0)
    amps = rng.rand(S, C).astype(np.float32)
    sigma = np.where(np.arange(S) % 3 == 0, np.inf,
                     rng.uniform(5.0, 40.0, S)).astype(np.float32)
    freqs_f32 = (NU0 + DNU * (chan0 + np.arange(C))).astype(np.float32)
    inv_wl = (jnp.asarray(freqs_f32) / CNST.c)
    return dict(np=(seh, sel, blh, bll, amps), C=C, chan0=chan0,
                s_sky=s.astype(np.float32), sigma=sigma, inv_wl=inv_wl,
                gs_j=nudft_j.freq_grid_scalars(NU0, DNU),
                gs_t=nudft_t.freq_grid_scalars(NU0, DNU))


@pytest.mark.parametrize("mode", ["point", "gradient", "extended"])
def test_nudft_visibilities_jax_order(nudft_case, mode):
    """Both packages called positionally in JAX's order (..., chan0,
    src_shape_sigma, s_sky, inv_wl, src_block, gradient, ql), the port also
    by keyword: equal to each other bit for bit, and to JAX at its bars."""
    c = nudft_case
    grad = mode == "gradient"
    ext = mode == "extended"
    sig = c["sigma"] if ext else None
    ssky = c["s_sky"] if (ext or grad) else None
    iwl = c["inv_wl"] if ext else None
    ql = (2, 16)
    jx = [jnp.asarray(a) for a in c["np"]]
    want = nudft_j.nudft_visibilities(
        *jx, c["gs_j"], c["C"], c["chan0"],
        None if sig is None else jnp.asarray(sig),
        None if ssky is None else jnp.asarray(ssky), iwl, 16, grad, ql)
    tx = [torch.as_tensor(a) for a in c["np"]]
    t_sig = None if sig is None else torch.as_tensor(sig)
    t_ssky = None if ssky is None else torch.as_tensor(ssky)
    t_iwl = None if iwl is None else np.asarray(iwl)
    got = nudft_t.nudft_visibilities(
        *tx, c["gs_t"], c["C"], c["chan0"], t_sig, t_ssky, t_iwl, 16, grad,
        ql)
    got_kw = nudft_t.nudft_visibilities(
        *tx, c["gs_t"], c["C"], chan0=c["chan0"], src_shape_sigma=t_sig,
        s_sky=t_ssky, src_block=16, gradient=grad)
    if not grad:
        want, got, got_kw = (want,), (got,), (got_kw,)
    for g, k in zip(got, got_kw):
        assert torch.equal(g, k)
    bars = (3e-6 if ext else 2e-6, 5e-6)
    for g, w, bar in zip(got, want, bars):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.complex64
        assert np.abs(g.numpy() - w).max() / np.abs(w).max() < bar


def test_nudft_visibilities_checks_inv_wl_and_ql(nudft_case):
    c = nudft_case
    tx = [torch.as_tensor(a) for a in c["np"]]
    args = (*tx, c["gs_t"], c["C"], c["chan0"])
    ssky = torch.as_tensor(c["s_sky"])
    sig = torch.as_tensor(c["sigma"])
    iwl = np.array(c["inv_wl"])
    ref = nudft_t.nudft_visibilities(*args, sig, ssky)
    # a longer inv_wl (JAX pads to its tiling) and a tensor pass unchanged
    longer = np.concatenate([iwl, np.ones(8, np.float32)])
    for ok in (longer, torch.as_tensor(iwl)):
        assert torch.equal(nudft_t.nudft_visibilities(*args, sig, ssky, ok),
                           ref)
    for bad in (iwl[:-1],                                 # too short
                iwl * np.float32(1.0 + 1e-6),             # another band
                np.roll(iwl, 1)):                          # shifted channels
        with pytest.raises(ValueError, match="inv_wl"):
            nudft_t.nudft_visibilities(*args, sig, ssky, bad)
    point = nudft_t.nudft_visibilities(*args)
    assert torch.equal(nudft_t.nudft_visibilities(*args, ql=(3, 8)), point)
    with pytest.raises(ValueError, match="ql"):
        nudft_t.nudft_visibilities(*args, ql=(2, 8))
    with pytest.raises(ValueError, match="ql"):
        nudft_j.nudft_visibilities(*(jnp.asarray(a) for a in c["np"]),
                                   c["gs_j"], c["C"], ql=(2, 8))


# --------------------------------------------------------------------------
# simulate_drift and its siblings with use_pallas / interpret
# --------------------------------------------------------------------------

LAT = -30.7224


@pytest.fixture(scope="module")
def drift_case():
    """HERA-7, 16 channels, nside-4 sky with a ramp, 2 accumulations."""
    bls = build_baselines(preset_layout("HERA-7"), redundant=False)
    freqs = 150e6 + 97656.25 * (np.arange(16) - 8)
    npix = hp_j.nside2npix(4)
    sky = healpix_diffuse_model(1.0 + np.arange(npix) / npix,
                                freqs_model=np.asarray([150e6]))
    inst_j = obs_j.Instrument.build(bls.vectors, freqs, latitude=LAT)
    sky_j = obs_j.SkySources.from_skymodel(sky, freqs)
    lst = np.asarray([30.0, 30.5])
    obs = obs_j.Observation(
        lst_deg=lst, jd=2457000.0 + lst / 360.0, t_acc=np.full(2, 60.0),
        pointing_altaz=np.tile([[90.0, 270.0]], (2, 1)))
    inst_t = instrument_from_numpy(np.asarray(inst_j.bl_hi),
                                   np.asarray(inst_j.bl_lo), freqs,
                                   device="cpu", latitude=LAT)
    sky_t = sky_from_numpy(np.asarray(sky_j.s_eq_hi),
                           np.asarray(sky_j.s_eq_lo), np.asarray(sky_j.flux),
                           device="cpu")
    return dict(inst_j=inst_j, sky_j=sky_j, obs_j=obs, inst_t=inst_t,
                sky_t=sky_t, freqs=freqs,
                obs_t=obs_t.Observation(obs.lst_deg, obs.jd, obs.t_acc,
                                        obs.pointing_altaz),
                beam_j=lambda s, f: airy_j(s, f, 14.0),
                beam_t=lambda s, f: airy_t(s, f, 14.0))


def test_simulate_drift_jax_order(drift_case):
    """simulate_drift(inst, sky, obs, beam, src_block, gradient, use_pallas,
    interpret) positionally in both packages (use_pallas False, interpret
    False: JAX's XLA path, the port's plain version on the CPU), within
    2e-6 of max|V|; every knob value gives the same visibilities on the
    CPU, and simulate_drift_rotations and simulate_snapshot take them in
    JAX's places too."""
    d = drift_case
    want = np.asarray(obs_j.simulate_drift(
        d["inst_j"], d["sky_j"], d["obs_j"], d["beam_j"], 32, False, False,
        False))
    got = obs_t.simulate_drift(d["inst_t"], d["sky_t"], d["obs_t"],
                               d["beam_t"], 32, False, False, False)
    assert got.shape == want.shape == (2, 21, 16)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 2e-6
    for knobs in ((None, False), (True, True), (False, True)):
        assert torch.equal(obs_t.simulate_drift(
            d["inst_t"], d["sky_t"], d["obs_t"], d["beam_t"], src_block=32,
            use_pallas=knobs[0], interpret=knobs[1]), got)
    sched = obs_t.schedule_tensors(d["obs_t"], d["inst_t"].latitude, "cpu")
    rot = obs_t.simulate_drift_rotations(d["inst_t"], d["sky_t"], *sched,
                                         d["beam_t"], 32, False, False,
                                         False)
    assert torch.equal(rot, got)
    snap = obs_t.simulate_snapshot(d["inst_t"], d["sky_t"],
                                   *(x[1] for x in sched), d["beam_t"], 32,
                                   False, False, False)
    assert torch.equal(snap, got[1])


def test_kernel_knobs_raise_on_cuda():
    """On a CUDA device the kernels always run: use_pallas=False and
    interpret=True raise there (no card is needed to ask), None and True
    pass; on the CPU every value passes."""
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="use_pallas=False"):
        obs_t.check_kernel_knobs(cuda, use_pallas=False)
    with pytest.raises(ValueError, match="interpret=True"):
        obs_t.check_kernel_knobs(cuda, interpret=True)
    with pytest.raises(ValueError, match="interpret=True"):
        obs_t.check_kernel_knobs("cuda:0", True, True)
    obs_t.check_kernel_knobs(cuda)
    obs_t.check_kernel_knobs(cuda, use_pallas=True)
    for up in (None, False, True):
        for it in (False, True):
            obs_t.check_kernel_knobs(torch.device("cpu"), up, it)


# --------------------------------------------------------------------------
# make_banded_snapshot_fns in JAX's positional order
# --------------------------------------------------------------------------

def test_banded_snapshot_fns_jax_order(drift_case):
    """make_banded_snapshot_fns(instrument, sky, beam_fn, plan, pinvQ, Q,
    interpret, spatial_sort, src_chunk, ...) called positionally equals the
    keyword call bit for bit (run and gate); spatial_sort=False raises."""
    d = drift_case
    inst, sky = d["inst_t"], d["sky_t"]
    plan = nb_t.make_banded_plan(np.asarray(
        build_baselines(preset_layout("HERA-7"), redundant=False).vectors),
        inst.nu0, inst.dnu, inst.nchan, rank=8, T_s=128)
    pinvQ, Q = chebyshev_projection(d["freqs"], 8)
    sched = tuple(x[0] for x in obs_t.schedule_tensors(
        d["obs_t"], inst.latitude, "cpu"))
    pos = nb_t.make_banded_snapshot_fns(inst, sky, d["beam_t"], plan, pinvQ,
                                        Q, False, True, 128, 64)
    kw = nb_t.make_banded_snapshot_fns(inst, sky, d["beam_t"], plan, pinvQ,
                                       Q, src_chunk=128, gate_src_block=64)
    assert pos.n_chunks == kw.n_chunks == 2
    v_pos, ok_pos = pos(*sched)
    v_kw, ok_kw = kw(*sched)
    assert torch.equal(v_pos, v_kw) and bool(ok_pos) and bool(ok_kw)
    for a, b in zip(pos.gate_fn(*sched), kw.gate_fn(*sched)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(a, b))
    with pytest.raises(ValueError, match="spatial_sort"):
        nb_t.make_banded_snapshot_fns(inst, sky, d["beam_t"], plan, pinvQ,
                                      Q, False, False)
    # interpret=True on CPU tensors runs the plain version all the same
    v_int, _ = nb_t.make_banded_snapshot_fns(
        inst, sky, d["beam_t"], plan, pinvQ, Q, True, src_chunk=128)(*sched)
    assert torch.equal(v_int, v_kw)


# --------------------------------------------------------------------------
# df_sincos_cycles with two_pi
# --------------------------------------------------------------------------

def test_df_sincos_cycles_two_pi():
    """JAX's two_pi argument: the port's result with the default pair,
    with it given as floats or as float32 tensors, and with another pair,
    against JAX's with the same pair within 4 float32 eps (each sincos
    intrinsic is within ~1 ulp); another pair moves the result."""
    rng = np.random.default_rng(3)
    ch, cl = tf_j.split_f64(rng.uniform(-0.5, 0.5, 4096))
    other = tuple(float(v) for v in tf_j.split_f64(2.0 * np.pi * 1.01))
    tol = 4 * np.finfo(np.float32).eps
    th, tl = torch.as_tensor(ch), torch.as_tensor(cl)
    default = [x.numpy() for x in tf_t.df_sincos_cycles(th, tl)]
    for pair in ((tf_t.TWO_PI_HI, tf_t.TWO_PI_LO), other):
        want = [np.asarray(x) for x in tf_j.df_sincos_cycles(
            jnp.asarray(ch), jnp.asarray(cl), jnp,
            tuple(jnp.float32(v) for v in pair))]
        for given in (pair, tuple(torch.tensor(v, dtype=torch.float32)
                                  for v in pair)):
            got = [x.numpy() for x in tf_t.df_sincos_cycles(th, tl, given)]
            for g, w in zip(got, want):
                assert g.dtype == np.float32
                assert np.abs(g - w).max() <= tol
        if pair == other:
            assert np.abs(got[0] - default[0]).max() > 100 * tol
        else:
            assert all(np.array_equal(g, x) for g, x in zip(got, default))


# --------------------------------------------------------------------------
# generate_noise with shape
# --------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("rms_shape", [(), (1, 16, 1), (7, 16, 5)])
def test_generate_noise_shape(rms_shape):
    """noise_rms broadcast to `shape` (a scalar, a per-channel column, the
    full cube with shape left out), complex64 of that shape in both
    packages; the port's per-sample power within 3 sigma of rms^2 (its
    sample mean of |n|^2, an exponential variable), same-seed repeats and
    a tensor rms bit for bit equal to the array's."""
    shape = (7, 16, 5)
    rng = np.random.default_rng(1)
    rms = (rng.uniform(0.5, 2.0, rms_shape) if rms_shape else 1.3)
    arg = (None,) if rms_shape == shape else (shape,)
    got = noise_t.generate_noise(_gen(4), rms, *arg)
    want = noise_j.generate_noise(jax.random.PRNGKey(4), jnp.asarray(rms),
                                  *arg)
    assert tuple(got.shape) == tuple(want.shape) == shape
    assert got.dtype == torch.complex64 and want.dtype == jnp.complex64
    assert torch.equal(noise_t.generate_noise(_gen(4), rms, *arg), got)
    assert torch.equal(noise_t.generate_noise(
        _gen(4), torch.as_tensor(np.asarray(rms, np.float32)), *arg), got)
    assert not torch.equal(noise_t.generate_noise(_gen(5), rms, *arg), got)
    power = (got.abs() ** 2).double().numpy() / np.broadcast_to(
        np.asarray(rms, np.float32), shape) ** 2
    assert abs(power.mean() - 1.0) < 3.0 / np.sqrt(power.size)


def test_generate_noise_shape_checks():
    with pytest.raises(RuntimeError):
        noise_t.generate_noise(_gen(0), np.ones((3, 4)), (4, 3))
