"""Generic nested-dict <-> HDF5 persistence for analysis products.

Counterpart of prisim_tpu/io/dicth5.py: delay-spectrum, power-spectrum
and closure-phase cross-power products (the reference's per-class
save()/read() pairs, e.g. DelaySpectrum.save at PRISim's
prisim/delay_spectrum.py:3048). h5py is imported when a function is
called, so the module imports without it."""

from __future__ import annotations

import numpy as np

__all__ = ["save_dict_hdf5", "load_dict_hdf5"]


def _write(group, d):
    for k, v in d.items():
        key = str(k)
        if isinstance(v, dict):
            _write(group.create_group(key), v)
        elif v is None:
            group.attrs[key] = "__none__"
        elif np.isscalar(v) or isinstance(v, str):
            group.attrs[key] = v
        else:
            arr = np.asarray(v)
            if arr.dtype.kind in "UO":
                arr = np.char.encode(arr.astype(str))
            group[key] = arr


def _read(group):
    out = {}
    for k, v in group.attrs.items():
        out[k] = None if (isinstance(v, str) and v == "__none__") else v
    for k in group:
        node = group[k]
        if hasattr(node, "keys"):
            out[k] = _read(node)
        else:
            arr = node[()]
            if getattr(arr, "dtype", None) is not None and \
                    arr.dtype.kind == "S":
                arr = np.char.decode(arr)
            out[k] = arr
    return out


def save_dict_hdf5(d, path):
    import h5py
    with h5py.File(path, "w") as f:
        _write(f, d)


def load_dict_hdf5(path):
    import h5py
    with h5py.File(path, "r") as f:
        return _read(f)
