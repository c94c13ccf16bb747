"""Product IO: HDF5/NPZ native persistence, the native FITS product, the
part files of chunked runs (io.parts), and the UVFITS/UVH5 exports
(io.uvfits, io.uvh5)."""

from .fitsnative import load_fits, save_fits
from .hdf5 import load_hdf5, load_npz, save_hdf5, save_npz
from .parts import load_part_npz, save_part_npz

__all__ = ["save_hdf5", "load_hdf5", "save_npz", "load_npz", "save_fits",
           "load_fits", "save_part_npz", "load_part_npz"]
