"""Closure phases: triad enumeration and phase extraction from vis cubes.

Rebuild of ``InterferometerArray.getThreePointCombinations`` /
``getClosurePhase`` (PRISim's prisim/interferometry.py:6989-7654)
as vectorized host numpy functions over a VisibilitySet (a copy of
prisim_tpu/analysis/closure.py, code unchanged).

Conventions (identical to the reference): for an antenna triad
(a1, a2, a3) the three baselines are (a2,a1), (a3,a2), (a1,a3) — each
visibility cube is indexed at the simulated baseline matching that label
pair, conjugating when only the reversed pair was simulated — and the
closure phase is angle(V12 * V23 * V31)."""

from __future__ import annotations

import numpy as np


__all__ = ["unique_triads", "unique_triads_fast", "all_triads",
           "triad_baseline_indices", "closure_phases",
           "closure_phases_vs", "delay_filter"]


def all_triads(labels):
    """All antenna triads (i<j<k) from a list of antenna labels."""
    labels = np.asarray(labels, dtype=str)
    n = labels.size
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            for k in range(j + 1, n):
                out.append((labels[i], labels[j], labels[k]))
    return out


def unique_triads(labels, positions, decimals=2):
    """Triads unique up to baseline-vector redundancy: keep one triad per
    unordered set of three (rounded) baseline vectors
    (getThreePointCombinations(unique=True),
    PRISim's prisim/interferometry.py:6989-7086)."""
    labels = np.asarray(labels, dtype=str)
    positions = np.asarray(positions, dtype=np.float64)
    lut = {str(l): p for l, p in zip(labels, positions)}
    seen = set()
    out = []
    for tri in all_triads(labels):
        a1, a2, a3 = tri
        b12 = lut[a2] - lut[a1]
        b23 = lut[a3] - lut[a2]
        b31 = lut[a1] - lut[a3]
        key = frozenset(
            tuple(np.round(np.where(np.abs(b) < 1e-10, 0.0, b), decimals))
            for b in (b12, b23, b31))
        if key not in seen:
            seen.add(key)
            out.append(tri)
    return out


def unique_triads_fast(labels, positions, decimals=2, max_classes=None):
    """Vectorized unique-triad enumeration for LARGE arrays.

    One witness triad per GEOMETRIC congruence class of baseline-vector
    triples (a triad and its orientation reversal — conjugate
    bispectrum — count as ONE class). unique_triads follows the
    reference literally (O(N^3) Python loop over label-ordered triads,
    frozenset of oriented vectors, PRISim's prisim/
    interferometry.py:6989-7086), which takes hours at 512 antennas;
    use that for reference-exact lists, this for scale.

    Implementation detail: all class algebra runs on integer pair-class
    IDs (np.unique of rounded pair vectors) — deriving third-side /
    negated vectors arithmetically and re-rounding is unstable at
    round-half boundaries and splits classes.

    max_classes: keep only the smallest-perimeter classes (triad class
    counts explode combinatorially at SKA scale)."""
    labels = np.asarray(labels, dtype=str)
    pos = np.asarray(positions, dtype=np.float64)
    n = labels.size
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mask = ii != jj
    ii, jj = ii[mask], jj[mask]
    vec = np.round(pos[jj] - pos[ii], decimals)
    vec[np.abs(vec) < 1e-10] = 0.0
    uvec, inv = np.unique(vec, axis=0, return_inverse=True)
    Du = uvec.shape[0]
    # pair-class table, adjacency, and the negation map — all in IDs
    PC = np.full((n, n), -1, dtype=np.int64)
    PC[ii, jj] = inv
    adj = np.full((Du, n), -1, dtype=np.int64)
    adj[inv, ii] = jj
    neg = np.full(Du, -1, dtype=np.int64)
    neg[inv] = PC[jj, ii]
    plen = np.linalg.norm(uvec, axis=1)

    found = {}
    for g1 in range(Du):
        b = adj[g1]                                  # (n,) a2 per a1
        a1s = np.nonzero(b >= 0)[0]
        if a1s.size == 0:
            continue
        a2s = b[a1s]
        c = adj[:, a2s]                              # (Du, nv) a3 ids
        ok = c >= 0
        ok[neg[g1], :] = False                       # u2 = -u1: a3 == a1
        has = ok.any(axis=1)
        w = np.argmax(ok, axis=1)
        for g2 in np.nonzero(has)[0]:
            a1 = int(a1s[w[g2]])
            a2 = int(a2s[w[g2]])
            a3 = int(c[g2, w[g2]])
            g3 = int(PC[a3, a1])                     # b31 = a1 - a3
            key = min(tuple(sorted((g1, int(g2), g3))),
                      tuple(sorted((int(neg[g1]), int(neg[g2]),
                                    int(neg[g3])))))
            if key not in found:
                found[key] = (labels[a1], labels[a2], labels[a3])
    items = list(found.items())
    if max_classes is not None:
        items.sort(key=lambda kv: float(plen[list(kv[0])].sum()))
        items = items[:max_classes]
    return [tri for _, tri in items]


def triad_baseline_indices(vs_labels, ant_triplets, baselines=None,
                           ant_positions=None, ant_labels=None, tol=1e-4):
    """For each triad (a1,a2,a3) find (ind12, ind23, ind31) into the
    simulated baseline list and conjugation flags.

    vs_labels: (nbl, 2) array of (A2, A1) label pairs. For sims that
    keep only unique redundant baselines, pass `baselines` (nbl, 3) and
    the antenna `ant_positions`/`ant_labels` layout: pairs absent from
    the label table are resolved by matching the pair's baseline VECTOR
    (or its negation -> conjugate) against the simulated set — the
    reference's bl_reversemap path
    (PRISim's prisim/interferometry.py:7420-7460).
    Returns (indices (ntri, 3) int, conj (ntri, 3) bool)."""
    labels = np.asarray(vs_labels, dtype=str)
    lut = {(labels[i, 0], labels[i, 1]): i for i in range(labels.shape[0])}
    pos_lut = None
    if ant_positions is not None and ant_labels is not None:
        pos_lut = {str(l): np.asarray(p, dtype=np.float64)
                   for l, p in zip(np.asarray(ant_labels, dtype=str),
                                   ant_positions)}
        bvecs = np.asarray(baselines, dtype=np.float64)
    idx = np.empty((len(ant_triplets), 3), dtype=np.int64)
    conj = np.zeros((len(ant_triplets), 3), dtype=bool)
    for t, (a1, a2, a3) in enumerate(ant_triplets):
        for m, (p, q) in enumerate(((a2, a1), (a3, a2), (a1, a3))):
            p, q = str(p), str(q)
            if (p, q) in lut:
                idx[t, m] = lut[(p, q)]
            elif (q, p) in lut:
                idx[t, m] = lut[(q, p)]
                conj[t, m] = True
            elif pos_lut is not None and p in pos_lut and q in pos_lut:
                v = pos_lut[p] - pos_lut[q]
                d = np.linalg.norm(bvecs - v, axis=1)
                j = int(d.argmin())
                if d[j] <= tol:
                    idx[t, m] = j
                else:
                    d2 = np.linalg.norm(bvecs + v, axis=1)
                    j2 = int(d2.argmin())
                    if d2[j2] > tol:
                        raise ValueError(
                            "no simulated baseline (redundant or not) "
                            "matches pair (%s, %s)" % (p, q))
                    idx[t, m] = j2
                    conj[t, m] = True
            else:
                raise ValueError(
                    "baseline (%s, %s) not found in simulated baselines"
                    % (p, q))
    return idx, conj


def closure_phases(cube, idx, conj):
    """Closure phases (ntri, nchan, nacc) from a (nbl, nchan, nacc) cube
    (vectorized gather form of the loop at
    PRISim's prisim/interferometry.py:7420-7654)."""
    cube = np.asarray(cube)
    v = cube[idx]                                # (ntri, 3, nchan, nacc)
    v = np.where(conj[:, :, None, None], np.conj(v), v)
    prod = v[:, 0] * v[:, 1] * v[:, 2]
    return np.angle(prod), prod


def closure_phases_vs(vs, ant_triplets=None, unique=True):
    """Closure phases for all visibility cubes of a VisibilitySet.

    Returns dict with 'triads', 'closure_phase_skyvis' /
    '..._vis' / '..._noise' of shape (ntri, nchan, nacc), and the complex
    triple products under 'bispectrum_*'."""
    if ant_triplets is None:
        if vs.layout is None:
            raise ValueError("need a layout (or explicit ant_triplets) "
                             "to enumerate triads")
        if unique:
            ant_triplets = unique_triads(vs.layout["labels"],
                                         vs.layout["positions"])
        else:
            ant_triplets = all_triads(vs.layout["labels"])
    kw = {}
    if vs.layout is not None:
        kw = dict(baselines=np.asarray(vs.baselines),
                  ant_positions=np.asarray(vs.layout["positions"]),
                  ant_labels=np.asarray(vs.layout["labels"], dtype=str))
    idx, conj = triad_baseline_indices(vs.labels, ant_triplets, **kw)
    out = {"triads": ant_triplets, "indices": idx, "conj": conj}
    for name, cube in vs._vis_cubes():
        key = {"skyvis": "skyvis", "vis": "vis",
               "vis_noise": "noise"}[name]
        cp, bsp = closure_phases(cube, idx, conj)
        out["closure_phase_" + key] = cp
        out["bispectrum_" + key] = bsp
    return out


def delay_filter(cube, df, delay_max, mode="discard", freq_wts=None):
    """FFT-mask delay filter along the frequency axis (axis 1 of a
    (nbl/ntri, nchan, nacc) cube): zero delays |tau| <= delay_max
    ('discard') or |tau| >= delay_max ('retain') — the delay_filter_info
    machinery at PRISim's prisim/interferometry.py:7560-7587.
    delay_max may be scalar or (n0,) per-row."""
    cube = np.asarray(cube)
    nchan = cube.shape[1]
    if freq_wts is not None:
        cube = cube * np.asarray(freq_wts).reshape(1, -1, 1)
    delays = np.fft.fftfreq(nchan, d=df)
    dmax = np.broadcast_to(np.asarray(delay_max, dtype=np.float64),
                           (cube.shape[0],))
    mask = np.abs(delays)[None, :] <= dmax[:, None]
    if mode == "retain":
        mask = ~mask
    keep = (~mask).astype(np.float64)
    spec = np.fft.fft(cube, axis=1)
    return np.fft.ifft(spec * keep[:, :, None], axis=1)


def spectral_smooth(cube, window_size=5, mode="median", flag_chans=None,
                    freqs=None):
    """Spectral smoothing / flagged-channel repair of a visibility cube
    (the specsmooth_info machinery of getClosurePhase,
    PRISim's prisim/interferometry.py:7485-7559 — op_type
    'median' running median filter, 'interp' cubic interpolation across
    flagged channels). cube: (n0, nchan, nacc) complex; axis 1 is
    frequency."""
    cube = np.asarray(cube)
    if mode == "median":
        from scipy.ndimage import median_filter
        size = (1, int(window_size), 1)
        return (median_filter(cube.real, size=size)
                + 1j * median_filter(cube.imag, size=size))
    if mode == "interp":
        if flag_chans is None or np.size(flag_chans) == 0:
            return cube.copy()
        nchan = cube.shape[1]
        x = np.arange(nchan) if freqs is None else np.asarray(freqs)
        bad = np.zeros(nchan, dtype=bool)
        bad[np.asarray(flag_chans, dtype=int)] = True
        good = ~bad
        from scipy.interpolate import interp1d
        out = cube.copy()
        fr = interp1d(x[good], cube[:, good, :].real, axis=1,
                      kind="cubic", bounds_error=False,
                      fill_value="extrapolate")
        fi = interp1d(x[good], cube[:, good, :].imag, axis=1,
                      kind="cubic", bounds_error=False,
                      fill_value="extrapolate")
        out[:, bad, :] = fr(x[bad]) + 1j * fi(x[bad])
        return out
    raise ValueError("mode must be 'median' or 'interp'")
