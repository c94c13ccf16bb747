"""Part files of chunked runs: a lossless NPZ dump of a VisibilitySet.

The reference's chunked runs write per-chunk ``simdata/_part_N`` files and
merge them (run_prisim.py:1995, 2224-2287); prisim_tpu writes them as
HDF5. The port writes NPZ (no h5py needed): every field of the
VisibilitySet, arrays bit for bit, the dict fields (telescope, layout,
gradients, blgroups) flattened, and a JSON table that records each entry's
path and Python kind, so load_part_npz gives back equal fields of the same
types. Nothing is pickled (allow_pickle=False)."""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..vis import VisibilitySet

__all__ = ["save_part_npz", "load_part_npz", "is_part_npz"]

_TABLE = "__part_table__"
_SCALARS = {bool: "bool", int: "int", float: "float", str: "str"}


def _flatten(path, obj, table, arrays):
    if obj is None:
        table.append([path, "none", None])
    elif isinstance(obj, dict):
        table.append([path, "dict", None])
        for key, val in obj.items():
            if not isinstance(key, str):
                raise TypeError("part files take str dict keys, got %r"
                                % (key,))
            _flatten(path + [key], val, table, arrays)
    elif isinstance(obj, tuple):
        # element by element, so numpy scalars come back as such
        table.append([path, "tuple", None])
        for i, val in enumerate(obj):
            _flatten(path + [i], val, table, arrays)
    else:
        kind = _SCALARS.get(type(obj))
        if kind is None:
            kind = ("scalar" if isinstance(obj, np.generic) else
                    "list" if isinstance(obj, list) else "array")
        arr = np.asarray(obj)
        if arr.dtype.kind == "O":
            raise TypeError("part files take no object arrays (%s)"
                            % "/".join(path))
        key = "a%d" % len(arrays)
        arrays[key] = arr
        table.append([path, kind, key])


def save_part_npz(vs, path):
    """Write every field of `vs` to the NPZ file `path`."""
    table, arrays = [], {}
    for f in dataclasses.fields(vs):
        _flatten([f.name], getattr(vs, f.name), table, arrays)
    arrays[_TABLE] = np.asarray(json.dumps(table))
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def is_part_npz(path):
    with np.load(path, allow_pickle=False) as d:
        return _TABLE in d.files


def _restore(kind, arr):
    if kind == "array":
        return arr
    if kind == "list":
        return arr.tolist()
    if kind == "scalar":
        return arr[()]
    return {"bool": bool, "int": int, "float": float, "str": str}[kind](arr)


def load_part_npz(path):
    """Read a save_part_npz file back into a VisibilitySet."""
    fields = {}
    with np.load(path, allow_pickle=False) as d:
        for p, kind, key in json.loads(str(d[_TABLE])):
            parent = fields
            for k in p[:-1]:
                parent = parent[k]
            if kind == "none":
                val = None
            elif kind == "dict":
                val = {}
            elif kind == "tuple":
                val = _Tuple()
            else:
                val = _restore(kind, d[key])
            parent[p[-1]] = val
    return VisibilitySet(**_tuples(fields))


class _Tuple(dict):
    """A tuple being read back: its elements by index."""


def _tuples(node):
    """The containers read back, those written from tuples made tuples."""
    if not isinstance(node, dict):
        return node
    vals = {k: _tuples(v) for k, v in node.items()}
    if isinstance(node, _Tuple):
        return tuple(vals[i] for i in range(len(vals)))
    return vals
