"""Telescope-dict primary beam dispatcher.

Counterpart of prisim_tpu/beams/dispatch.py: known telescope ids
(vla/gmrt/ugmrt/hera/hirax/mwa/mwa_dipole/paper), generic element shapes
(delta/dipole/dish/gaussian/rect/square), arbitrary apertures with or
without a feed, an optional phased-array beamformer with random delay/gain
error realizations, and a ground-plane multiplier. The dict is parsed on
the host; the pattern is computed on the device of `dircos`.
"""

from __future__ import annotations

import torch

from . import analytic as AB


def _feed_telescope(telescope, pol):
    """The telescope dict as `pol`'s feed sees it: a Y feed is the X feed
    rotated 90 deg in azimuth."""
    if pol in ("Y", "y"):
        # resolve the effective orientation before rotating: the
        # orientation-sensitive branches default to (1,0,0) when
        # orientation_dircos is absent, so a Y feed rotates that default
        ox, oy, oz = ((telescope or {}).get("orientation_dircos")
                      or (1.0, 0.0, 0.0))
        telescope = dict(telescope or {},
                         orientation_dircos=(-oy, ox, oz))
    return telescope


# Telescope ids whose beam is an Airy dish of a fixed diameter (m), and
# those whose beam is never one
_DISH_IDS = {"hera": 14.0, "hirax": 6.0}
_OTHER_IDS = ("vla", "gmrt", "ugmrt", "mwa", "mwa_dipole", "paper")


def _dish(telescope):
    """(diameter, axis) of the Airy dish that primary_beam computes for the
    feed's `telescope` dict, or None where it computes another beam: hera
    and hirax about orientation_dircos (None: zenith), a generic `shape:
    dish` of `size` about primary_beam's pointing_center_dircos (None
    here)."""
    tid = telescope.get("id")
    if tid in _DISH_IDS:
        return _DISH_IDS[tid], telescope.get("orientation_dircos")
    if (tid not in _OTHER_IDS and telescope.get("aperture_locs") is None
            and telescope.get("shape", "delta") == "dish"):
        return telescope.get("size"), None
    return None


def airy_dish(telescope, pol="X"):
    """(diameter, axis) of the Airy power pattern that primary_beam
    computes for `telescope` and `pol` with no beamformer and no pointing
    centre, or None where it computes another: a pol other than X or Y, a
    dish of no size, and every beam that is no Airy dish."""
    if pol not in ("X", "Y", "x", "y"):
        return None
    dish = _dish(_feed_telescope(telescope, pol) or {})
    if dish is None or not dish[0]:
        return None
    return float(dish[0]), dish[1]


def _power_from_field(ep, af=None, gp=None):
    """power = mean over realizations of |ep * AF|^2, times gp^2."""
    if af is not None:
        field = ep[..., None] * af if ep.ndim == 2 else ep * af
        pb = torch.mean(torch.abs(field) ** 2, dim=-1)
    else:
        pb = torch.abs(ep) ** 2
    if gp is not None:
        pb = pb * gp ** 2
    return pb


def primary_beam(dircos, freqs, telescope, pointing_info=None,
                 pointing_center_dircos=None, short_dipole=False,
                 half_wave=False, generator=None, pol="X", band_freq=None):
    """Power pattern (nsrc, nchan) for sources at `dircos` (local ENU
    direction cosines, float32 tensor) and `freqs` (Hz, float32 tensor).

    telescope: dict with keys id / shape / size / orientation_dircos /
    element_locs / aperture_locs / feedinfo / groundplane / ground_modify.
    pointing_info: dict with delays / gains / delayerr / gainerr / nrand /
    pointing_center_dircos (a 3-sequence or a (3,) tensor) for the
    beamformer. generator: the torch.Generator of the random errors (None:
    a fresh one seeded 0 on the tensors' device). band_freq: the host
    frequency (Hz) that picks the VLA/GMRT band (None: freqs[0], read from
    the device).
    pol: 'X' (default) or 'Y'. The Y feed is the X feed rotated 90 deg
    in azimuth; orientation-sensitive beams (dipole/beamformer/feed)
    change, axisymmetric dishes do not.
    """
    if pol not in ("X", "Y", "x", "y"):
        raise ValueError("pol must be 'X' or 'Y'")
    telescope = _feed_telescope(telescope, pol)
    tid = (telescope or {}).get("id", None)

    if tid in ("vla",):
        return AB.vla_pbcor_beam(dircos, freqs, band_freq=band_freq)
    if tid in ("gmrt", "ugmrt"):
        return AB.gmrt_beam(dircos, freqs, instrument=tid,
                            band_freq=band_freq)
    if tid in _DISH_IDS:
        dia, axis = _dish(telescope)
        return AB.airy_beam(dircos, freqs, dia, pointing_dircos=axis,
                            power=True)
    if tid in ("mwa",):
        ep = AB.dipole_beam(dircos, freqs, 0.74,
                            orientation_dircos=telescope.get(
                                "orientation_dircos", (1.0, 0.0, 0.0)),
                            short_dipole=short_dipole, half_wave=half_wave,
                            power=False)
        element_locs = telescope.get("element_locs")
        if element_locs is None:
            element_locs = AB.mwa_tile_positions()
        pinfo = pointing_info or {}
        af = AB.array_field_pattern(
            element_locs, dircos, freqs,
            pointing_dircos=pinfo.get("pointing_center_dircos",
                                      pointing_center_dircos),
            delays=pinfo.get("delays"), gains=pinfo.get("gains"),
            delayerr=pinfo.get("delayerr", 0.0) or 0.0,
            gainerr_db=pinfo.get("gainerr", 0.0) or 0.0,
            nrand=pinfo.get("nrand", 1) or 1, generator=generator)
        return _power_from_field(ep, af=af,
                                 gp=_ground_plane(telescope, dircos, freqs))
    if tid in ("mwa_dipole", "paper"):
        size = 0.74 if tid == "mwa_dipole" else 2.0
        ep = AB.dipole_beam(dircos, freqs, size,
                            orientation_dircos=telescope.get(
                                "orientation_dircos", (1.0, 0.0, 0.0)),
                            short_dipole=short_dipole, half_wave=half_wave,
                            power=False)
        return _power_from_field(ep, gp=_ground_plane(telescope, dircos,
                                                      freqs))

    # Arbitrary aperture samples ------------------------------------------
    if (telescope or {}).get("aperture_locs") is not None:
        # generic aperture of isotropic radiators, optionally illuminated
        # by a feed (telescope['feedinfo'])
        pinfo = pointing_info or {}
        pdc = pinfo.get("pointing_center_dircos", pointing_center_dircos)
        feedinfo = telescope.get("feedinfo")
        if feedinfo:
            return AB.feed_aperture_combined_field_pattern(
                telescope["aperture_locs"], feedinfo, dircos, freqs,
                pointing_dircos=pdc, short_dipole=short_dipole,
                half_wave=half_wave, power=True)
        return AB.generic_aperture_field_pattern(
            telescope["aperture_locs"], dircos, freqs,
            pointing_dircos=pdc, delays=pinfo.get("delays"),
            gains=pinfo.get("gains"),
            delayerr=pinfo.get("delayerr", 0.0) or 0.0,
            gainerr_db=pinfo.get("gainerr", 0.0) or 0.0,
            nrand=pinfo.get("nrand", 1) or 1, generator=generator,
            power=True)

    # Generic shapes ------------------------------------------------------
    shape = (telescope or {}).get("shape", "delta")
    nsrc, nchan = dircos.shape[0], freqs.shape[0]
    if shape == "delta":
        ep = torch.ones((nsrc, nchan), dtype=dircos.dtype,
                        device=dircos.device)
    elif shape == "dipole":
        ep = AB.dipole_beam(dircos, freqs, telescope["size"],
                            orientation_dircos=telescope.get(
                                "orientation_dircos", (1.0, 0.0, 0.0)),
                            short_dipole=short_dipole, half_wave=half_wave,
                            power=False)
    elif shape == "dish":
        ep = AB.airy_beam(dircos, freqs, _dish(telescope)[0],
                          pointing_dircos=pointing_center_dircos,
                          power=False)
    elif shape == "gaussian":
        ep = AB.gaussian_beam(dircos, freqs, telescope["size"],
                              pointing_dircos=pointing_center_dircos,
                              power=False)
    elif shape == "rect":
        ep = AB.uniform_rect_aperture_beam(
            dircos, freqs, telescope["size"],
            pointing_dircos=pointing_center_dircos, power=False)
    elif shape == "square":
        ep = AB.uniform_square_aperture_beam(
            dircos, freqs, telescope["size"],
            pointing_dircos=pointing_center_dircos, power=False)
    else:
        raise ValueError(f"invalid telescope shape {shape!r}")

    af = None
    if pointing_info is not None and telescope.get("element_locs") is not None:
        af = AB.array_field_pattern(
            telescope["element_locs"], dircos, freqs,
            pointing_dircos=pointing_info.get("pointing_center_dircos",
                                              pointing_center_dircos),
            delays=pointing_info.get("delays"),
            gains=pointing_info.get("gains"),
            delayerr=pointing_info.get("delayerr", 0.0) or 0.0,
            gainerr_db=pointing_info.get("gainerr", 0.0) or 0.0,
            nrand=pointing_info.get("nrand", 1) or 1, generator=generator)

    gp = None
    if telescope.get("groundplane") is not None and shape != "dish":
        gp = _ground_plane(telescope, dircos, freqs)
    return _power_from_field(ep, af=af, gp=gp)


def _ground_plane(telescope, dircos, freqs):
    h = telescope.get("groundplane")
    if h is None:
        return None
    return AB.ground_plane_pattern(dircos, freqs, h,
                                   modifier=telescope.get("ground_modify"),
                                   power=False)
