"""Instrument gain tables: storage, interpolation, baseline extraction.

The port's own copy of prisim_tpu/gains.py (numpy and scipy only): the
port imports nothing of the JAX package.

Rebuild of the reference's gain machinery — ``read_gaintable`` /
``extract_gains`` (PRISim's prisim/interferometry.py:333-858) and
``class GainInfo`` (:2412-3800, with ``interpolate_gains`` :3169,
``spline_gains`` :3382, ``nearest_gains`` :3599, ``eval_gains`` :3725,
``write_gaintable`` :3767) — as a small host-side component.

Design: gain tables are tiny (nant x nchan x nt complex) compared to the
visibility tensor, and interpolation happens once per run, so this is a
host numpy/scipy precompute producing a dense per-baseline gain cube
(nbl, nchan, nacc) that is then applied on device as a single elementwise
multiply (``apply_gains``). No reason to drag scipy splines into jit.

Conventions (identical to the reference):
* canonical axes ordering is ('label', 'frequency', 'time'); any
  permutation may be stored and is normalized on read via 'ordering'.
* any axis may have size 1 -> broadcast across that axis.
* antenna-based: per-baseline gain = g[A2] * conj(g[A1]) where the
  baseline vector is pos(A2) - pos(A1)
  (PRISim's prisim/interferometry.py:829).
* baseline-based: a table row labeled (A1, A2) applies conjugated to
  baseline (A2, A1) (:832-838).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

try:
    import h5py
except ImportError:                                   # pragma: no cover
    h5py = None

__all__ = ["GainTable", "GainInfo", "apply_gains"]

_CANON = ("label", "frequency", "time")


def _normalize(gains, ordering):
    """Transpose stored gains into canonical (label, freq, time) order."""
    ordering = [str(o) for o in ordering]
    if sorted(ordering) != sorted(_CANON):
        raise ValueError("ordering must be a permutation of %s" % (_CANON,))
    perm = [ordering.index(ax) for ax in _CANON]
    return np.transpose(np.asarray(gains), axes=perm)


def _interp_complex_axis(values, x, xq, axis, kind):
    """Interpolate complex values along one axis at query points xq.

    kind: 'linear' | 'cubic' (spline, cf. GainInfo.splinator
    PRISim's prisim/interferometry.py:3107) | 'nearest'.
    Size-1 axes broadcast (no interpolation). Extrapolation: clamped to
    the end values (the reference raises IndexError and falls back —
    see add_noise at interferometry.py:6707-6722; clamping subsumes the
    fallback chain)."""
    values = np.asarray(values)
    n = values.shape[axis]
    xq = np.atleast_1d(np.asarray(xq, dtype=np.float64))
    if n == 1:
        reps = [1] * values.ndim
        reps[axis] = xq.size
        return np.tile(values, reps)
    if x is None:
        raise ValueError("axis coordinates required for interpolation")
    x = np.asarray(x, dtype=np.float64)
    if x.size != n:
        raise ValueError("axis coordinate length mismatch")
    mv = np.moveaxis(values, axis, -1)
    if kind == "nearest":
        idx = np.abs(x[None, :] - xq[:, None]).argmin(axis=1)
        out = mv[..., idx]
    elif kind == "linear":
        from scipy.interpolate import interp1d
        f = interp1d(x, mv, axis=-1, kind="linear", bounds_error=False,
                     fill_value=(mv[..., 0], mv[..., -1]))
        out = f(xq)
    elif kind == "cubic":
        from scipy.interpolate import CubicSpline
        out = CubicSpline(x, mv, axis=-1)(np.clip(xq, x[0], x[-1]))
    else:
        raise ValueError("unknown interpolation kind '%s'" % kind)
    return np.moveaxis(out, -1, axis)


def _spline_complex(values, f, t, freqs, times, smoothness=None):
    """Smoothing-spline resampling of (nlab, nf, nt) complex gains onto
    (freqs, times) — the reference's splinator/spline_gains semantics
    (PRISim's prisim/interferometry.py:3107-3169, 3382-3599):
    real and imaginary parts are splined separately per label; when only
    one of (frequency, time) varies, scipy UnivariateSpline with
    smoothing factor s=smoothness (default: the number of samples); when
    both vary, RectBivariateSpline over (time, frequency) (s default
    nf*nt). Size-1 axes broadcast. Queries are clamped to the table
    range (the reference raises and falls back; clamping subsumes the
    fallback chain, cf. interferometry.py:6707-6722)."""
    from scipy.interpolate import UnivariateSpline, RectBivariateSpline
    values = np.asarray(values, dtype=np.complex128)
    nlab, nf, nt = values.shape
    fq = None if freqs is None else \
        np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    tq = None if times is None else \
        np.atleast_1d(np.asarray(times, dtype=np.float64))
    nf_out = nf if fq is None else fq.size
    nt_out = nt if tq is None else tq.size
    f_varies = nf > 1 and fq is not None
    t_varies = nt > 1 and tq is not None
    if not f_varies and not t_varies:
        reps = [1, nf_out // nf if nf == 1 else 1,
                nt_out // nt if nt == 1 else 1]
        out = np.tile(values, reps)
        if out.shape[1] != nf_out or out.shape[2] != nt_out:
            out = np.broadcast_to(out, (nlab, nf_out, nt_out)).copy()
        return out
    out = np.empty((nlab, nf_out, nt_out), dtype=np.complex128)
    if f_varies and t_varies:
        if f is None or t is None:
            raise ValueError("frequency and time coordinates required "
                             "for 2-D spline gains")
        s = float(smoothness) if smoothness is not None else \
            float(nf * nt)
        kx = min(3, nt - 1)
        ky = min(3, nf - 1)
        tqc = np.clip(tq, t.min(), t.max())
        fqc = np.clip(fq, f.min(), f.max())
        for ll in range(nlab):
            re = RectBivariateSpline(t, f, values[ll].real.T,
                                     kx=kx, ky=ky, s=s)
            im = RectBivariateSpline(t, f, values[ll].imag.T,
                                     kx=kx, ky=ky, s=s)
            out[ll] = (re(tqc, fqc) + 1j * im(tqc, fqc)).T
        return out
    # exactly one axis varies: UnivariateSpline along it
    if f_varies:
        coord, query, n = f, fq, nf
    else:
        coord, query, n = t, tq, nt
    if coord is None:
        raise ValueError("axis coordinates required for spline gains")
    s = float(smoothness) if smoothness is not None else float(n)
    k = min(3, n - 1)
    qc = np.clip(query, coord.min(), coord.max())
    for ll in range(nlab):
        flat = values[ll].ravel()
        re = UnivariateSpline(coord, flat.real, s=s, k=k)
        im = UnivariateSpline(coord, flat.imag, s=s, k=k)
        vals = re(qc) + 1j * im(qc)
        if f_varies:
            out[ll] = np.broadcast_to(vals[:, None], (nf_out, nt_out))
        else:
            out[ll] = np.broadcast_to(vals[None, :], (nf_out, nt_out))
    return out


@dataclass
class GainTable:
    """One gain table (antenna- or baseline-based), canonical axis order
    (label, frequency, time)."""
    gains: np.ndarray                       # (nlab, nchan, nt) complex
    label: Optional[np.ndarray] = None      # (nlab,) str, or (nlab,2) for bl
    frequency: Optional[np.ndarray] = None  # (nchan,) Hz
    time: Optional[np.ndarray] = None       # (nt,)

    def __post_init__(self):
        self.gains = np.atleast_3d(np.asarray(self.gains,
                                              dtype=np.complex128))
        if self.label is not None:
            self.label = np.asarray(self.label)
        if self.frequency is not None:
            self.frequency = np.asarray(self.frequency, dtype=np.float64)
        if self.time is not None:
            self.time = np.asarray(self.time, dtype=np.float64)

    def interpolated(self, freqs=None, times=None, kind="cubic",
                     smoothness=None):
        """New GainTable resampled onto the given freq/time grids.
        kind: 'linear' | 'cubic' | 'nearest' (per-axis interp1d) or
        'spline' (smoothing splines, the reference's splinator path,
        interferometry.py:3107/3382)."""
        g = self.gains
        f, t = self.frequency, self.time
        if kind == "spline":
            g = _spline_complex(g, f, t, freqs, times,
                                smoothness=smoothness)
            if freqs is not None:
                f = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
            if times is not None:
                t = np.atleast_1d(np.asarray(times, dtype=np.float64))
            return GainTable(g, self.label, f, t)
        if freqs is not None:
            g = _interp_complex_axis(g, f, freqs, axis=1, kind=kind)
            f = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
        if times is not None:
            g = _interp_complex_axis(g, t, times, axis=2, kind=kind)
            t = np.atleast_1d(np.asarray(times, dtype=np.float64))
        return GainTable(g, self.label, f, t)


def _match_labels(table_labels, wanted):
    """Index of each wanted label in table_labels; -1 if absent."""
    lut = {str(l): i for i, l in enumerate(table_labels)}
    return np.asarray([lut.get(str(w), -1) for w in wanted])


@dataclass
class GainInfo:
    """Container of antenna- and/or baseline-based gain tables
    (GainInfo equivalent, PRISim's prisim/interferometry.py:2412)."""
    antenna_based: Optional[GainTable] = None
    baseline_based: Optional[GainTable] = None
    interp_kind: str = "cubic"

    # -- IO ---------------------------------------------------------------
    @classmethod
    def read_hdf5(cls, path):
        """Read the reference HDF5 gain-table schema
        (read_gaintable, PRISim's prisim/interferometry.py:333)."""
        if h5py is None:
            raise ImportError("h5py required for gain tables")
        tables = {}
        with h5py.File(path, "r") as f:
            for key in ("antenna-based", "baseline-based"):
                if key not in f:
                    continue
                grp = f[key]
                ordering = [s.decode() if isinstance(s, bytes) else str(s)
                            for s in grp["ordering"][()]]
                gains = _normalize(grp["gains"][()], ordering)
                kw = {}
                for ax in ("label", "frequency", "time"):
                    if ax in grp:
                        v = grp[ax][()]
                        if v.dtype.kind in "SO":
                            v = np.asarray([s.decode() if isinstance(s, bytes)
                                            else str(s) for s in v.ravel()]
                                           ).reshape(v.shape)
                        kw[ax] = v
                tables[key.replace("-", "_")] = GainTable(gains, **kw)
        return cls(**tables)

    def write_hdf5(self, path):
        """Write in the reference schema (write_gaintable,
        PRISim's prisim/interferometry.py:3767)."""
        if h5py is None:
            raise ImportError("h5py required for gain tables")
        with h5py.File(path, "w") as f:
            for key, tab in (("antenna-based", self.antenna_based),
                             ("baseline-based", self.baseline_based)):
                if tab is None:
                    continue
                grp = f.create_group(key)
                grp["ordering"] = np.asarray([s.encode() for s in _CANON])
                grp["gains"] = tab.gains
                if tab.label is not None:
                    lab = tab.label
                    if lab.dtype.kind in "UO":
                        lab = np.char.encode(lab.astype(str))
                    grp["label"] = lab
                if tab.frequency is not None:
                    grp["frequency"] = tab.frequency
                if tab.time is not None:
                    grp["time"] = tab.time

    # -- evaluation -------------------------------------------------------
    def eval_gains(self, bl_labels, freqs=None, times=None, kind=None,
                   smoothness=None):
        """Per-baseline complex gains (nbl, nchan, nt).

        bl_labels: (nbl, 2) array of (A2, A1) antenna-label pairs, with
        baseline vector = pos(A2) - pos(A1). Combines
        g_ant[A2]*conj(g_ant[A1]) with baseline-based entries (conjugating
        reversed-label rows), after resampling each table onto the target
        freq/time grids (eval_gains + extract_gains,
        PRISim's prisim/interferometry.py:3725,:790-858)."""
        kind = kind or self.interp_kind
        bl_labels = np.asarray(bl_labels)
        a2, a1 = bl_labels[:, 0], bl_labels[:, 1]
        nbl = bl_labels.shape[0]
        out = np.ones((nbl, 1, 1), dtype=np.complex128)

        if self.antenna_based is not None:
            tab = self.antenna_based.interpolated(freqs, times, kind,
                                                  smoothness=smoothness)
            g = tab.gains
            if tab.label is None:
                # no label variation -> broadcast (reference does this for
                # any shape[0]==1 table, extract_gains :819-821)
                out = out * g * np.conj(g)
            else:
                i2 = _match_labels(tab.label, a2)
                i1 = _match_labels(tab.label, a1)
                if np.any(i2 < 0) or np.any(i1 < 0):
                    raise IndexError("some antenna gains could not be found")
                out = out * g[i2] * np.conj(g[i1])

        if self.baseline_based is not None:
            tab = self.baseline_based.interpolated(freqs, times, kind,
                                                   smoothness=smoothness)
            g = tab.gains
            if tab.label is None:
                out = out * g
            else:
                lab = np.asarray(tab.label)
                fwd = {(str(p[0]), str(p[1])): i for i, p in enumerate(lab)}
                bg = np.ones((nbl,) + g.shape[1:], dtype=np.complex128)
                for b in range(nbl):
                    pair = (str(a2[b]), str(a1[b]))
                    if pair in fwd:
                        bg[b] = g[fwd[pair]]
                    elif pair[::-1] in fwd:
                        bg[b] = np.conj(g[fwd[pair[::-1]]])
                    # absent -> unity (reference leaves blgains untouched)
                out = out * bg
        nchan = 1 if freqs is None else np.atleast_1d(freqs).size
        nt = 1 if times is None else np.atleast_1d(times).size
        return np.broadcast_to(out, (nbl, max(nchan, out.shape[1]),
                                     max(nt, out.shape[2]))).copy()


def apply_gains(skyvis, gains, noise=None):
    """vis = gains * skyvis (+ noise) — the reference's add_noise
    (PRISim's prisim/interferometry.py:6697-6722). Works on torch or
    numpy arrays; gains broadcastable to skyvis."""
    vis = gains * skyvis
    if noise is not None:
        vis = vis + noise
    return vis
