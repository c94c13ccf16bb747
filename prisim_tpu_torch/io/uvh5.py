"""UVH5 export and import (the HDF5-based UVData format).

Counterpart of prisim_tpu/io/uvh5.py, writing the same datasets with the
same values apart from `history`, which names this package: the public
UVH5 v1.0 layout, a /Header group of metadata datasets and a /Data group
with visdata/flags/nsamples. The conventions (conjugated vis, time-major
blts, AIPS polarization codes) are those of io/uvfits.py. h5py is
optional: the module imports without it, and its functions raise
ImportError."""

from __future__ import annotations

import numpy as np

try:
    import h5py
except ImportError:                                   # pragma: no cover
    h5py = None

from .uvfits import _antennas, ecef_to_enu_rotation, pol_cubes

__all__ = ["save_uvh5", "read_uvh5_arrays", "load_uvh5"]


def _need_h5py():
    if h5py is None:
        raise ImportError("h5py required")


def save_uvh5(vs, path, datatype="noiseless", vs_second=None,
              pols=None, four_pol=False, vs_cross=None):
    """Write a VisibilitySet as a UVH5 file.

    vs_second: optional second-polarization VisibilitySet with the same
    layout/axes (Npols=2 output, e.g. XX + YY from a beam.pol='XY'
    run). pols: AIPS polarization codes (default (-5,) = XX, or
    (-5, -6) with vs_second). four_pol: with vs_second, write the
    standard 4-pol linear axis (-5..-8 = XX, YY, XY, YX) with explicit
    zero cross-pols flagged and nsample=0. vs_cross: the simulated XY
    product (a VisibilitySet, or an (XY, YX) pair) from a
    beam.pol='full' Mueller run: cross-pols are then real data,
    unflagged, nsample=1."""
    _need_h5py()
    a, cubes, pols, cross_simulated = pol_cubes(
        vs, datatype, vs_second, pols, four_pol, vs_cross)
    nblts, nchan = a["nblts"], a["nchan"]
    npol = len(cubes)
    ant_names, ant_nums, ant_pos, _ = _antennas(vs)
    nants_data = np.unique(
        np.concatenate([a["ant_1_array"], a["ant_2_array"]])).size
    with h5py.File(path, "w") as f:
        h = f.create_group("Header")
        h["version"] = np.bytes_("1.0")
        h["latitude"] = vs.latitude
        h["longitude"] = vs.longitude
        h["altitude"] = vs.altitude
        h["telescope_name"] = np.bytes_(
            str(vs.telescope.get("id", "custom")))
        h["instrument"] = h["telescope_name"][()]
        h["object_name"] = np.bytes_("zenith" if not a["is_phased"]
                                     else "phase_center")
        h["history"] = np.bytes_("prisim_tpu_torch")
        h["phase_type"] = np.bytes_(
            "phased" if a["is_phased"] else "drift")
        if a["is_phased"]:
            ra, dec = a["phase_center_radec_deg"]
            h["phase_center_ra"] = np.radians(ra)
            h["phase_center_dec"] = np.radians(dec)
            h["phase_center_epoch"] = 2000.0
        h["Nants_data"] = nants_data
        h["Nants_telescope"] = int(ant_names.size)
        h["antenna_names"] = np.char.encode(ant_names)
        h["antenna_numbers"] = ant_nums.astype(np.int64)
        h["antenna_positions"] = ant_pos
        h["Nbls"] = a["nbl"]
        h["Nblts"] = nblts
        h["Nfreqs"] = nchan
        h["Npols"] = npol
        h["Ntimes"] = a["nacc"]
        h["Nspws"] = 1
        h["spw_array"] = np.asarray([0], dtype=np.int64)
        # UVH5 memo v1.0 layout: freq_array is (Nfreqs,), channel_width
        # is per-channel (Nfreqs,), and flex_spw_id_array maps channels
        # to spw_array entries
        h["freq_array"] = a["freqs"]
        df = float(a["freqs"][1] - a["freqs"][0]) if nchan > 1 else 1.0
        h["channel_width"] = np.full(nchan, df)
        h["flex_spw_id_array"] = np.zeros(nchan, dtype=np.int64)
        h["polarization_array"] = np.asarray(pols, dtype=np.int64)
        h["ant_1_array"] = a["ant_1_array"].astype(np.int64)
        h["ant_2_array"] = a["ant_2_array"].astype(np.int64)
        h["time_array"] = a["time_array"]
        h["lst_array"] = a["lst_array"]
        h["integration_time"] = np.full(nblts, a["integration_time"])
        h["uvw_array"] = a["uvw"]
        h["vis_units"] = np.bytes_("Jy")
        d = f.create_group("Data")
        d.create_dataset("visdata",
                         data=np.stack(cubes, axis=-1)
                         .astype(np.complex64))
        if vs.bp is not None or vs.bp_wts is not None:
            bp, wts = vs.default_bp()
            bad = (np.asarray(bp) * np.asarray(wts)) == 0
            flags = np.broadcast_to(
                np.transpose(bad, (2, 0, 1)).reshape(nblts, nchan, 1),
                (nblts, nchan, npol)).copy()
        else:
            flags = np.zeros((nblts, nchan, npol), dtype=bool)
        nsamples = np.ones((nblts, nchan, npol), dtype=np.float32)
        if four_pol and not cross_simulated:
            flags[..., 2:] = True          # unsimulated cross-pols
            nsamples[..., 2:] = 0.0
        d.create_dataset("flags", data=flags)
        d.create_dataset("nsamples", data=nsamples)


def read_uvh5_arrays(path):
    """Read back the key arrays of a UVH5 file."""
    _need_h5py()
    with h5py.File(path, "r") as f:
        h = f["Header"]
        out = dict(
            visdata=f["Data/visdata"][()],
            freq_array=h["freq_array"][()].ravel(),
            time_array=h["time_array"][()],
            lst_array=h["lst_array"][()],
            uvw_array=h["uvw_array"][()],
            ant_1_array=h["ant_1_array"][()],
            ant_2_array=h["ant_2_array"][()],
            antenna_positions=h["antenna_positions"][()],
            antenna_names=np.char.decode(
                h["antenna_names"][()].astype("S")),
            latitude=float(h["latitude"][()]),
            phase_type=h["phase_type"][()].decode(),
            Nbls=int(h["Nbls"][()]), Ntimes=int(h["Ntimes"][()]),
        )
    return out


def load_uvh5(path):
    """Read a UVH5 file back into a VisibilitySet (the inverse of
    save_uvh5; skyvis holds the first polarization).

    Assumes time-major blt ordering with a constant baseline set per
    time (what save_uvh5 writes and pyuvdata's standard ordering)."""
    from ..vis import VisibilitySet
    a = read_uvh5_arrays(path)
    with h5py.File(path, "r") as f:
        h = f["Header"]
        lat = float(h["latitude"][()])
        lon = float(h["longitude"][()]) if "longitude" in h else 0.0
        alt = float(h["altitude"][()]) if "altitude" in h else 0.0
        ant_nums = h["antenna_numbers"][()]
        tel = (h["telescope_name"][()].decode()
               if "telescope_name" in h else "custom")
        integ = h["integration_time"][()]
        flags = f["Data/flags"][()] if "Data/flags" in f else None
    nbl, ntimes = a["Nbls"], a["Ntimes"]
    nchan = a["freq_array"].size

    def chan_pol0(x):
        # v1.0 data is (Nblts, Nfreqs, Npols); v0.1 files carry an extra
        # Nspws axis (Nblts, 1, Nfreqs, Npols): accept both
        return x[:, 0, :, 0] if x.ndim == 4 else x[:, :, 0]

    # time-major blts -> (nbl, nchan, ntimes), un-conjugated
    vis = np.conj(chan_pol0(a["visdata"]).reshape(ntimes, nbl, nchan)
                  .transpose(1, 2, 0))
    bp_wts = None
    if flags is not None:
        fl = chan_pol0(flags)
        if fl.any():
            bp_wts = np.where(
                fl.reshape(ntimes, nbl, nchan).transpose(1, 2, 0),
                0.0, 1.0)
    ant1 = a["ant_1_array"][:nbl]
    ant2 = a["ant_2_array"][:nbl]
    labels = np.stack([ant2.astype(str), ant1.astype(str)], axis=-1)
    # ENU baselines are not stored in UVH5: recover them from the
    # (ECEF-relative) antenna positions
    num2idx = {int(n): i for i, n in enumerate(ant_nums)}
    enu = a["antenna_positions"] @ ecef_to_enu_rotation(lat, lon).T
    bl = np.stack([enu[num2idx[int(a2)]] - enu[num2idx[int(a1)]]
                   for a1, a2 in zip(ant1, ant2)])
    jd = a["time_array"].reshape(ntimes, nbl)[:, 0]
    lst = np.degrees(a["lst_array"].reshape(ntimes, nbl)[:, 0])
    t_acc = np.broadcast_to(np.atleast_1d(integ)[:1], (ntimes,)).copy()
    return VisibilitySet(
        baselines=bl, labels=labels, freqs=a["freq_array"], lst=lst,
        skyvis=vis, bp_wts=bp_wts, timestamps=jd, t_acc=t_acc,
        latitude=lat, longitude=lon, altitude=alt,
        telescope={"id": tel},
        layout=dict(positions=enu,
                    labels=a["antenna_names"].astype(str),
                    ids=ant_nums, coords="ENU"))
