"""Simulation parameters: schema, template overlay and loaders.

Counterpart of prisim_tpu/config.py with the same schema
(DEFAULT_PARMS), the same overlay semantics (custom keys override the
template key by key up to 3 nesting levels; unknown keys are rejected)
and the same warnings for inert keys. `yaml` is imported only inside
load_parms (for a path or a YAML string) and dump_parms, so a parms dict
overlaid on DEFAULT_PARMS works where pyyaml is not installed."""

from __future__ import annotations

import copy
import os
import warnings

__all__ = ["DEFAULT_PARMS", "load_parms", "merge_parms", "dump_parms"]


DEFAULT_PARMS = {
    "preload": {"template": None},
    "dirstruct": {"rootdir": "./", "project": "prisim_tpu_test",
                  "simid": None},
    "telescope": {
        "label_prefix": "", "id": "custom",
        "latitude": -30.7224, "longitude": 21.4278, "altitude": 0.0,
        "A_eff": 154.0, "eff_aprtr": 0.65, "eff_Q": 0.96,
        "Trx": 50.0, "Tant_freqref": 150e6, "Tant_spindex": -2.55,
        "Tant_ref": 200.0, "Tsys": None},
    "array": {
        "redundant": True, "layout": "HERA-19", "file": None,
        "layout_positions": None, "layout_labels": None,
        "filepathtype": "default",
        "parser": {"comment": None, "delimiter": None, "data_start": 3,
                   "data_end": None, "header_start": 0, "label": None,
                   "east": "East", "north": "North", "up": "Up"},
        "minR": 141.0, "maxR": 141.0,
        "rms_tgtplane": 0.0, "rms_elevation": 0.0, "seed": 200},
    "baseline": {"min": None, "max": None, "direction": None},
    "antenna": {"shape": "dish", "size": 14.0,
                "orientation": [90.0, 270.0], "ocoords": "altaz",
                "phased_array": False, "ground_plane": None},
    "phasedarray": {"file": None, "filepathtype": "default",
                    "delayerr": 0.0, "gainerr": 0.0, "nrand": 1},
    "beam": {"use_external": False, "file": None,
             "filepathtype": "default", "filefmt": "HDF5",
             "identifier": "", "pol": "X", "chromatic": True,
             "select_freq": 150e6, "spec_interp": "cubic",
             # pol 'full': 4-pol run with physical XY/YX leakage from
             # crossed-dipole Jones vectors (beams/jones.py — beyond
             # the single-pol reference). feeds configures the Jones
             # model: dipole length [m], ground-plane height [m]
             # (None = free space), X/Y axis azimuths [deg E-thru-N],
             # short_dipole/half_wave element factor selection.
             "feeds": {"length": 1.3, "height": None,
                       "x_orientation_deg": 0.0,
                       "y_orientation_deg": 90.0,
                       "short_dipole": False, "half_wave": True}},
    "bandpass": {"freq": 150e6, "freq_resolution": 390625.0,
                 "nchan": 256, "pfb_method": None, "pfb_filepath":
                 "default", "pfb_file": None},
    "obsparm": {"obs_date": "2015/11/23", "obs_mode": "drift",
                "t_obs": None, "n_acc": 2, "t_acc": 1080.0},
    "gains": {"file": None, "filepathtype": "default",
              # interpolation onto the sim grids: linear|cubic|nearest
              # (interp1d, GainInfo.interpolate_gains) or 'spline'
              # (smoothing splines, GainInfo.splinator/spline_gains,
              # interferometry.py:3107/3382) with optional smoothness
              "interp": "cubic", "smoothness": None},
    "pointing": {"file": None, "jd_init": None, "lst_init": 0.0,
                 "drift_init": {"alt": None, "az": None, "ha": 0.0,
                                "dec": -30.7224},
                 "track_init": {"ra": 0.0, "dec": -30.7224, "ha": 0.0,
                                "epoch": "2000"}},
    "phasing": {"center": [90.0, 270.0], "coords": "altaz"},
    "snapshot": {"avg_drifts": False, "beam_switch": False, "pick": None,
                 "range": None, "all": True},
    "skyparm": {"model": "custom", "fsky": None, "epoch": "2000",
                "nside": None, "n_mdl_freqs": 8, "parallel": False,
                "flux_unit": "Jy", "custom_reffreq": 0.15,
                "flux_min": 10.0, "flux_max": None,
                "fluxcut_reffreq": None, "spindex": -0.83,
                "spindex_rms": 0.0, "spindex_seed": None,
                "roi_radius": None, "lidz": True, "21cmfast": False,
                "global_EoR_parms": [0.027, 150e6, 1.0],
                "nsrc": 100, "seed": 100},
    "catalog": {"filepathtype": "default", "DSM_file_prefix": None,
                "spectrum_file": None, "SUMSS_file": None,
                "NVSS_file": None, "MWACS_file": None, "GLEAM_file": None,
                "custom_file": None, "skymod_file": None},
    "processing": {"gradient_mode": None, "memuse": None,
                   "memavail": None, "n_bins_blo": 4, "n_sky_sectors": 1,
                   "bpass_shape": "rect", "ant_bpass_file": None,
                   "f_pad": 1.0, "coarse_channel_width": 16,
                   "bp_correct": True, "noise_bp_correct": False,
                   "n_pad": 0, "max_abs_delay": 1.0,
                   "delay_transform": False, "memsave": False,
                   "store_prev_sky": True, "cleanup": 3,
                   "src_block": 512, "use_pallas": "auto", "acc_chunk": None,
                   # engine: 'direct' runs the direct NUDFT (kernel K1a
                   # on a card), 'nufft' the banded delay-space NUFFT
                   # (kernel K2 on a card) behind its gate against the
                   # direct engine; 'auto' is 'nufft' on a card and
                   # 'direct' on the CPU. The nufft_* keys keep the JAX
                   # package's schema (see prisim_tpu/config.py);
                   # nufft_spread 'sorted' (or 'scatter') runs the sorted
                   # delay-space NUFFT (kernel delay_spread) behind its
                   # gate, nufft_inflight is inert (NOOP_KEYS) and
                   # nufft_dot_split only sets the plan field (K2 sums
                   # in float64).
                   "engine": "auto", "nufft_rank": None,
                   "nufft_spread": "auto",
                   "nufft_crosscheck": True, "nufft_inflight": None,
                   "nufft_crosscheck_tol": None,
                   "nufft_node_model": True,
                   "nufft_truth_amps": "auto",
                   "nufft_resid_tol": 1e-4,
                   "nufft_beta": None, "nufft_dot_split": None},
    "pp": {"key": "freq", "eqvol": True, "method": "pool",
           "mesh_axes": None, "n_chunks": 1},
    "flags": {"flag_chan": -1, "bp_flag_repeat": False,
              "n_edge_flag": [0, 0],
              "flag_repeat_edge_channels": False},
    "save_redundant": True,
    "save_formats": {"fmt": "HDF5", "npz": True, "uvfits": False,
                     "uvh5": False, "uvfits_method": None,
                     "phase_center": None},
    "plots": False,
    "diagnosis": {"resource_monitor": False, "refresh_interval": None,
                  "wait_after_run": False, "jax_profile": None},
}


# Keys accepted for reference-YAML compatibility but deliberately inert
# here, with the reason: load_parms warns when a config sets one of
# these to a non-default value.
NOOP_KEYS = {
    "processing.memsave":
        "the direct engine always sums float64 phasors from two-float "
        "cycle counts; there is no lower-memory mode to switch to",
    "processing.store_prev_sky":
        "spectra are precomputed once for the whole run; the reference's "
        "per-snapshot HDF5 spectrum cache (interferometry.py:6222-6249) "
        "is obsolete",
    "processing.n_bins_blo":
        "parsed but never used by the reference itself "
        "(run_prisim.py:225 is its only mention)",
    "skyparm.parallel":
        "host-side catalog construction is vectorized numpy; no process "
        "pool exists to parallelize",
    "skyparm.lidz":
        "HI-cube selection is via skyparm.model (hi_cube/lidz/21cmfast), "
        "not this boolean",
    "skyparm.21cmfast":
        "HI-cube selection is via skyparm.model, not this boolean",
    "processing.nufft_inflight":
        "banded snapshots run one after another in eager PyTorch; there is "
        "no queue of dispatched snapshots to bound",
    "pp.eqvol":
        "the device mesh (parallel/mesh.py) always splits the baselines, "
        "channels or sources into equal padded shards; there is no "
        "work-stealing counter to toggle",
    "pp.method":
        "no multiprocessing pool exists; device parallelism comes from "
        "the device mesh of run_simulation(devices=...)",
}


def _noop_key_warnings(custom, defaults=None):
    """Warnings for explicitly-set inert keys (dotted-path lookup)."""
    out = []
    defaults = defaults or DEFAULT_PARMS
    for dotted, why in NOOP_KEYS.items():
        sec, key = dotted.split(".")
        val = (custom.get(sec) or {}).get(key, _MISSING) \
            if isinstance(custom.get(sec), dict) else _MISSING
        if val is _MISSING:
            continue
        if val != (defaults.get(sec) or {}).get(key):
            out.append("config key %s=%r has no effect: %s"
                       % (dotted, val, why))
    return out


class _Missing:
    def __repr__(self):
        return "<missing>"


_MISSING = _Missing()


def merge_parms(template, custom, _depth=0, _path=""):
    """Overlay custom onto template, rejecting unknown keys; at most 3
    nested dict levels (run_prisim.py:76-101 semantics)."""
    if _depth >= 3:
        raise TypeError("parameter nesting deeper than 3 levels is not "
                        "supported (at %s)" % _path)
    out = copy.deepcopy(template)
    for key, val in custom.items():
        if key == "preload":
            continue
        if key not in template:
            raise KeyError("invalid parameter %r found in custom "
                           "simulation parameters" % (_path + key))
        if isinstance(val, dict) and isinstance(template[key], dict):
            out[key] = merge_parms(template[key], val, _depth + 1,
                                   _path + key + ".")
        else:
            out[key] = copy.deepcopy(val)
    return out


def load_parms(source, use_builtin_defaults=True):
    """Load simulation parameters from a YAML path, a YAML string, or a
    dict. Applies preload.template overlay if present; otherwise overlays
    onto the builtin DEFAULT_PARMS (so partial configs are valid)."""
    if isinstance(source, dict):
        custom = copy.deepcopy(source)
    elif isinstance(source, str):
        import yaml
        if os.path.exists(source):
            with open(source) as f:
                custom = yaml.safe_load(f) or {}
        else:
            custom = yaml.safe_load(source) or {}
    else:
        raise TypeError("source must be a path, YAML string, or dict")
    template = None
    preload = custom.get("preload") or {}
    if preload.get("template"):
        import yaml
        with open(preload["template"]) as f:
            template = yaml.safe_load(f)
    elif use_builtin_defaults:
        template = DEFAULT_PARMS
    for msg in _noop_key_warnings(custom):
        warnings.warn(msg, stacklevel=2)
    if template is None:
        return custom
    return merge_parms(template, custom)


def dump_parms(parms, path):
    """Write resolved parameters (metadata provenance, the reference's
    simparms.yaml at run_prisim.py:2212-2220). Needs pyyaml."""
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(parms, f, default_flow_style=False,
                       sort_keys=False)
