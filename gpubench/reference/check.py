"""The comparison that decides `correct`.

For each completed simulation it judges (all of them, or as many as the
cell's sample names, drawn from the seed: `pick_simulations`), the
benchmark keeps a sample of what run_simulation returned (or, for a cell
that writes its product, of the file read back: products.py): the sky
visibilities (VisibilitySet.skyvis), the visibilities a user receives
(VisibilitySet.vis) and the thermal noise (VisibilitySet.vis_noise) on
baselines that span the lengths and on channels that span the band, at
the first, the last and some other accumulations; the projected
baselines, the noise rms on the same sample, the LST of every
accumulation, and the noise power of every channel over the whole cube.
The reference works the deterministic ones out again from the parameter
sections, and six numbers are compared, each against a limit of the
cell:

    vis_err  max |V - V_ref| / max |V_ref| over the sample
    uvw_err  max |uvw - uvw_ref| / max |uvw_ref|
    rms_err  max |rms / rms_ref - 1|
    lst_err  max |lst - lst_ref| in degrees, across the 360 wrap
    sum_err  max |vis - (skyvis + vis_noise)| / max |vis| over the sample:
             the noise is what was added (the configurations apply no
             gains and phase to the pointing centre, a factor of 1)
    noise_z  |m - 1| sqrt(N), m the mean of |n|^2 / rms_ref^2 over all N
             noise samples of the cube: the noise's power against the
             reference's rms in standard errors (|n|^2 / rms^2 of complex
             gaussian noise is exponential with mean 1 and variance 1)
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("vis_err", "uvw_err", "rms_err", "lst_err", "sum_err",
           "noise_z")


def sample_indices(ref, rng, spec):
    """Baselines, channels and accumulations of the sample: spans from the
    shortest to the longest baseline, from the first to the last channel,
    the first and the last accumulation, and draws from `rng` beside."""
    lens = np.sqrt((ref.bl ** 2).sum(axis=1))
    order = np.argsort(lens, kind="stable")

    def pick(n_all, n_span, n_rand, ranked=None):
        span = np.unique(np.linspace(0, n_all - 1, min(n_span, n_all))
                         .round().astype(int))
        if ranked is not None:
            span = ranked[span]
        rest = np.setdiff1d(np.arange(n_all), span)
        extra = rng.choice(rest, size=min(n_rand, rest.size), replace=False)
        return np.sort(np.concatenate([span, extra]).astype(int))

    bl = pick(ref.nbl, spec["baselines_span"], spec["baselines_random"],
              order)
    ch = pick(ref.nchan, spec["channels_span"], spec["channels_random"])
    t = pick(ref.n_acc, 2, max(0, spec["snapshots"] - 2))
    return dict(bl=bl, ch=ch, t=t)


def pick_simulations(n, rng, most):
    """Which of n completed simulations are judged: all where n <= most,
    else the first, the last and most - 2 drawn from `rng` between."""
    if n <= most:
        return list(range(n))
    mid = rng.choice(np.arange(1, n - 1), size=most - 2, replace=False)
    return [0] + sorted(int(i) for i in mid) + [n - 1]


def keep_sample(vs, idx):
    """What the comparison reads of one returned VisibilitySet."""
    bl, ch, t = idx["bl"], idx["ch"], idx["t"]
    cut = np.ix_(bl, ch, t)
    noise = np.asarray(vs.vis_noise)
    power = (noise.real ** 2 + noise.imag ** 2).mean(axis=(0, 2),
                                                     dtype=np.float64)
    return dict(
        skyvis=np.asarray(vs.skyvis)[cut].copy(),
        vis=np.asarray(vs.vis)[cut].copy(),
        noise=noise[cut].copy(),
        noise_power=power, noise_count=noise.size,
        uvw=np.asarray(vs.projected_baselines, np.float64).copy(),
        rms=np.asarray(vs.vis_rms)[cut].astype(np.float64),
        lst=np.asarray(vs.lst, np.float64).copy())


def readings(got, ref, lst_init, idx, precision="float64"):
    """The six numbers for one simulation's sample `got` against the
    reference. With precision "control" (or "phase32") the reference at
    that precision (reference/model.py) takes the place of the program's
    sky visibilities, and with "control" of its projected baselines, rms
    and LST too; the noise is a draw the reference does not make, so a
    control adds the program's draw to its own sky visibilities."""
    v_ref = np.transpose(ref.visibilities(lst_init, idx["t"], idx["bl"],
                                          idx["ch"]), (1, 2, 0))
    uvw_ref = ref.uvw(lst_init)
    rms_ch = ref.vis_rms()
    rms_ref = rms_ch[idx["ch"]][None, :, None]
    lst_ref, _ = ref.schedule(lst_init)
    if precision != "float64":
        sky = np.transpose(ref.visibilities(
            lst_init, idx["t"], idx["bl"], idx["ch"], precision), (1, 2, 0))
        got = dict(got, skyvis=sky, vis=sky + got["noise"])
    if precision == "control":
        got = dict(
            got, uvw=ref.uvw(lst_init, "control").astype(np.float64),
            rms=np.broadcast_to(ref.vis_rms("control")[idx["ch"]]
                                [None, :, None], got["rms"].shape)
            .astype(np.float64),
            lst=ref.schedule(lst_init)[0].astype(np.float32)
            .astype(np.float64))
    dlst = (got["lst"] - lst_ref + 180.0) % 360.0 - 180.0
    shape_ok = (got["skyvis"].shape == v_ref.shape
                and got["vis"].shape == v_ref.shape
                and got["noise"].shape == v_ref.shape
                and got["noise_power"].shape == rms_ch.shape
                and got["uvw"].shape == uvw_ref.shape
                and got["lst"].shape == lst_ref.shape)
    if not shape_ok:
        return dict.fromkeys(NUMBERS, float("inf"))
    m = float(np.mean(got["noise_power"] / rms_ch ** 2))
    added = got["vis"] - (got["skyvis"] + got["noise"])
    return dict(
        vis_err=float(np.abs(got["skyvis"] - v_ref).max()
                      / np.abs(v_ref).max()),
        uvw_err=float(np.abs(got["uvw"] - uvw_ref).max()
                      / np.abs(uvw_ref).max()),
        rms_err=float(np.abs(got["rms"] / rms_ref - 1.0).max()),
        lst_err=float(np.abs(dlst).max()),
        sum_err=float(np.abs(added).max() / np.abs(got["vis"]).max()),
        noise_z=float(abs(m - 1.0) * np.sqrt(got["noise_count"])))


def worst(list_of_readings):
    """Each number's largest reading over simulations (inf where a reading
    is not finite)."""
    out = {}
    for k in NUMBERS:
        vals = [r[k] for r in list_of_readings]
        out[k] = (float(max(vals)) if vals and all(np.isfinite(vals))
                  else float("inf"))
    return out


def judge(numbers, limits):
    """True when every number is at or under its limit."""
    return all(k in limits and numbers[k] <= float(limits[k])
               for k in NUMBERS)
