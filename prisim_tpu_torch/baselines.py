"""Baseline generation, selection cuts, and redundancy grouping.

The port's own copy of prisim_tpu/baselines.py (numpy and scipy only): the
port imports nothing of the JAX package.

Rebuild of the reference's baseline machinery
(baseline_generator at PRISim's prisim/interferometry.py:1184,
uniq_baselines at :1373, getBaselineInfo cuts/groups at :1465-1658,
duplicate_measurements expansion at :6823). Host-side numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["BaselineSet", "baseline_generator", "uniq_baselines",
           "build_baselines"]


@dataclass
class BaselineSet:
    """Baselines with labels and (optional) redundancy bookkeeping.

    vectors     (nbl, 3) ENU baseline vectors (meters)
    labels      (nbl, 2) antenna-label pairs (a2, a1) with vector = pos2-pos1
    unique_ind  indices into the *pre-cut* all-pairs set for each kept row
    group_of    (nbl_total,) index of the unique group each all-pairs
                baseline belongs to (only when redundancy applied)
    group_counts (nbl,) multiplicity of each kept unique baseline
    all_vectors / all_labels: the full pre-redundancy set (for expansion)
    """
    vectors: np.ndarray
    labels: np.ndarray
    group_counts: np.ndarray = None
    group_of: np.ndarray = None
    all_vectors: np.ndarray = None
    all_labels: np.ndarray = None

    @property
    def nbl(self):
        return self.vectors.shape[0]

    @property
    def lengths(self):
        return np.sqrt(np.sum(self.vectors ** 2, axis=1))

    def groups(self):
        """dict: unique-row index -> array of all-pairs indices in group."""
        if self.group_of is None:
            return {i: np.array([i]) for i in range(self.nbl)}
        return {u: np.where(self.group_of == u)[0]
                for u in range(self.nbl)}

    def expand_redundant(self, vis):
        """Copy unique-baseline visibilities onto all redundant members
        (duplicate_measurements equivalent,
        PRISim's prisim/interferometry.py:6823). vis has leading axis
        nbl (unique); returns leading axis nbl_total in all-pairs order."""
        if self.group_of is None:
            return vis
        return vis[self.group_of]


def baseline_generator(positions, labels=None, auto=False):
    """All-pairs baselines pos[j] - pos[i] for j > i (j >= i with auto).

    Returns (vectors (M,3), label_pairs (M,2))."""
    positions = np.atleast_2d(np.asarray(positions, dtype=np.float64))
    n = positions.shape[0]
    if labels is None:
        labels = np.asarray([str(i) for i in range(n)])
    labels = np.asarray(labels, dtype=str)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = (jj >= ii) if auto else (jj > ii)
    i_idx, j_idx = ii[keep], jj[keep]
    vectors = positions[j_idx] - positions[i_idx]
    label_pairs = np.stack([labels[j_idx], labels[i_idx]], axis=-1)
    return vectors, label_pairs


def _redundancy_keys(vectors):
    """Quantized (length, zenith-angle, orientation mod 180deg) keys at the
    reference's 0.01 m / 3.6 arcsec resolution
    (PRISim's prisim/interferometry.py:1404-1410)."""
    v = np.asarray(vectors, dtype=np.float64)
    bll = np.sqrt(np.sum(v ** 2, axis=1))
    blo = np.degrees(np.arctan2(v[:, 1], v[:, 0]))
    blo = np.where(blo >= 180.0, blo - 180.0, blo)
    blo = np.where(blo < 0.0, blo + 180.0, blo)
    with np.errstate(invalid="ignore"):
        blza = np.degrees(np.arccos(np.clip(v[:, 2] / np.where(bll > 0, bll, 1.0),
                                            -1, 1)))
    return ["{0:.2f}_{1:.3f}_{2:.3f}".format(l, 3.6e3 * za, 3.6e3 * o)
            for l, za, o in zip(bll, blza, blo)]


def uniq_baselines(vectors):
    """Identify redundant baseline groups.

    Returns (unique_vectors, first_index, counts, group_of) where group_of
    maps each input row to its unique-group row."""
    keys = _redundancy_keys(vectors)
    _, ind, inv, counts = np.unique(keys, return_index=True,
                                    return_inverse=True, return_counts=True)
    # Re-order groups by first occurrence so output is deterministic in the
    # input ordering rather than the string sort order.
    order = np.argsort(ind)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    ind = ind[order]
    counts = counts[order]
    group_of = rank[inv]
    return np.asarray(vectors)[ind], ind, counts, group_of


def build_baselines(layout, redundant=True, min_length=None, max_length=None,
                    direction_deg=None, direction_tol_deg=1.0):
    """Full baseline pipeline: all-pairs -> cuts -> (optional) redundancy.

    Mirrors getBaselineInfo's baseline-related behavior
    (PRISim's prisim/interferometry.py:1564-1658): length min/max
    cuts, orientation cuts, and redundancy compression keeping one
    exemplar per group with counts.
    """
    vectors, label_pairs = baseline_generator(layout.positions,
                                              layout.labels)
    keep = np.ones(vectors.shape[0], dtype=bool)
    lengths = np.sqrt(np.sum(vectors ** 2, axis=1))
    if min_length is not None:
        keep &= lengths >= min_length
    if max_length is not None:
        keep &= lengths <= max_length
    if direction_deg is not None:
        ang = np.degrees(np.arctan2(vectors[:, 1], vectors[:, 0])) % 180.0
        want = np.atleast_1d(np.asarray(direction_deg)) % 180.0
        dmat = np.abs((ang[:, None] - want[None, :] + 90.0) % 180.0 - 90.0)
        keep &= np.any(dmat <= direction_tol_deg, axis=1)
    vectors = vectors[keep]
    label_pairs = label_pairs[keep]

    if not redundant:
        return BaselineSet(vectors, label_pairs)
    uvec, ind, counts, group_of = uniq_baselines(vectors)
    return BaselineSet(uvec, label_pairs[ind], group_counts=counts,
                       group_of=group_of, all_vectors=vectors,
                       all_labels=label_pairs)


def baseline_group_keys(bset, vectors, tol=1e-6):
    """For query baseline vectors, the index of (and label pair of) the
    unique redundant group each belongs to, with a conjugation flag for
    flipped vectors (getBaselineGroupKeys,
    PRISim's prisim/interferometry.py:2017-2099)."""
    vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float64))
    uvec = np.asarray(bset.vectors, dtype=np.float64)
    idx = np.full(vectors.shape[0], -1, dtype=np.int64)
    conj = np.zeros(vectors.shape[0], dtype=bool)
    for i, v in enumerate(vectors):
        d = np.linalg.norm(uvec - v, axis=1)
        j = int(d.argmin())
        if d[j] <= tol:
            idx[i] = j
            continue
        d2 = np.linalg.norm(uvec + v, axis=1)
        j2 = int(d2.argmin())
        if d2[j2] <= tol:
            idx[i] = j2
            conj[i] = True
    return idx, conj


def baselines_in_group(bset, group_index):
    """All-pairs member labels and vectors of one unique-baseline group
    (getBaselinesInGroups, PRISim's prisim/interferometry.py:
    2100-2168)."""
    if bset.group_of is None:
        return (np.asarray([bset.labels[group_index]]),
                np.asarray([bset.vectors[group_index]]))
    members = np.where(bset.group_of == group_index)[0]
    return bset.all_labels[members], bset.all_vectors[members]
