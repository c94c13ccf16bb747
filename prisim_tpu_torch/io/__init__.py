"""Product IO: HDF5/NPZ native persistence, the native FITS product, and
the UVFITS/UVH5 exports (io.uvfits, io.uvh5)."""

from .fitsnative import load_fits, save_fits
from .hdf5 import load_hdf5, load_npz, save_hdf5, save_npz

__all__ = ["save_hdf5", "load_hdf5", "save_npz", "load_npz", "save_fits",
           "load_fits"]
