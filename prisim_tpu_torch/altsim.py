"""pyuvsim interoperability: config conversion in both directions.

Counterpart of prisim_tpu/altsim.py, the rebuild of PRISim's
scripts/altsim_interface.py (``simparms_from_pyuvsim_to_prisim``
:11-169): translate a pyuvsim "obsparam" YAML (+ telescope config +
layout csv) into a parameter dict, and export a config as pyuvsim
obsparam files, for cross-simulator validation runs. The code is a copy
on the port's config.load_parms; pyyaml is imported when a function is
called, and without it each raises ImportError before any work."""

from __future__ import annotations

import os

import numpy as np

from .config import load_parms

__all__ = ["pyuvsim_to_parms", "parms_to_pyuvsim"]


def _read_layout_csv(path):
    """pyuvsim layout csv: Name Number BeamID E N U (whitespace)."""
    names, e, n, u = [], [], [], []
    with open(path) as f:
        header = f.readline()
        for ln in f:
            parts = ln.split()
            if len(parts) < 6:
                continue
            names.append(parts[0])
            e.append(float(parts[3]))
            n.append(float(parts[4]))
            u.append(float(parts[5]))
    return names, np.stack([e, n, u], axis=-1)


def pyuvsim_to_parms(obsparam_path):
    """pyuvsim obsparam YAML -> parameter dict (load_parms).

    Handles freq (start_freq/channel_width/Nfreqs), time
    (start_time/Ntimes/integration_time), and the telescope config
    (location, layout csv)."""
    import yaml
    base = os.path.dirname(os.path.abspath(obsparam_path))
    with open(obsparam_path) as f:
        obs = yaml.safe_load(f)
    fr = obs.get("freq") or {}
    tm = obs.get("time") or {}
    tl = obs.get("telescope") or {}
    custom = {
        "bandpass": {
            "freq": float(fr.get("start_freq", 150e6))
            + float(fr.get("channel_width", 1e5))
            * (int(fr.get("Nfreqs", 1)) / 2.0),
            "freq_resolution": float(fr.get("channel_width", 1e5)),
            "nchan": int(fr.get("Nfreqs", 1)),
        },
        "obsparm": {
            "n_acc": int(tm.get("Ntimes", 1)),
            "t_acc": float(tm.get("integration_time", 1.0)),
        },
    }
    tcfg_name = tl.get("telescope_config_name")
    if tcfg_name:
        with open(os.path.join(base, tcfg_name)) as f:
            tcfg = yaml.safe_load(f)
        loc = tcfg.get("telescope_location")
        if isinstance(loc, str):
            loc = [float(x) for x in
                   loc.strip("()[] ").split(",")]
        if loc:
            custom["telescope"] = {"latitude": float(loc[0]),
                                   "longitude": float(loc[1]),
                                   "altitude": float(loc[2]),
                                   "id": str(tcfg.get("telescope_name",
                                                      "custom"))}
    layout_csv = tl.get("array_layout")
    if layout_csv:
        # normalize the 6-column pyuvsim csv (Name Number BeamID E N U)
        # into the 4-column (label, E, N, U) format our parser reads
        names, enu = _read_layout_csv(os.path.join(base, layout_csv))
        norm_path = os.path.join(base, "layout_prisim.txt")
        with open(norm_path, "w") as f:
            for nm, p in zip(names, enu):
                f.write("%s %.6f %.6f %.6f\n" % (nm, p[0], p[1], p[2]))
        custom.setdefault("array", {})["file"] = norm_path
        custom["array"]["layout"] = None
        custom["array"]["parser"] = {"data_start": 0}
    if tm.get("start_time") is not None:
        custom.setdefault("pointing", {})["jd_init"] = \
            float(tm["start_time"])
    return load_parms(custom)


def parms_to_pyuvsim(parms, outdir):
    """Parameter dict -> pyuvsim obsparam + telescope config +
    layout csv written under outdir. Returns the obsparam path."""
    import yaml
    from .driver import build_layout, build_frequencies
    if not isinstance(parms, dict) or "telescope" not in parms:
        parms = load_parms(parms)
    os.makedirs(outdir, exist_ok=True)
    layout = build_layout(parms)
    freqs = build_frequencies(parms)
    layout_csv = os.path.join(outdir, "layout.csv")
    with open(layout_csv, "w") as f:
        f.write("Name\tNumber\tBeamID\tE\tN\tU\n")
        for i, (lbl, pos) in enumerate(zip(layout.labels,
                                           layout.positions)):
            f.write("%s\t%d\t0\t%.6f\t%.6f\t%.6f\n"
                    % (lbl, i, pos[0], pos[1], pos[2]))
    tp = parms["telescope"]
    tcfg = {
        "telescope_name": tp.get("id", "custom"),
        "telescope_location": "(%.6f, %.6f, %.1f)"
        % (float(tp["latitude"]), float(tp.get("longitude") or 0.0),
           float(tp.get("altitude") or 0.0)),
        "beam_paths": {0: {"type": "airy",
                           "diameter": float(parms["antenna"].get(
                               "size") or 14.0)}},
    }
    tcfg_path = os.path.join(outdir, "telescope_config.yaml")
    with open(tcfg_path, "w") as f:
        yaml.safe_dump(tcfg, f)
    obsparam = {
        "filing": {"outdir": ".", "outfile_name": "sim"},
        "freq": {"Nfreqs": int(parms["bandpass"]["nchan"]),
                 "channel_width":
                 float(parms["bandpass"]["freq_resolution"]),
                 "start_freq": float(freqs[0])},
        "time": {"Ntimes": int(parms["obsparm"]["n_acc"]),
                 "integration_time":
                 float(parms["obsparm"]["t_acc"]),
                 "start_time":
                 float(parms["pointing"].get("jd_init") or 2458000.5)},
        "telescope": {"array_layout": "layout.csv",
                      "telescope_config_name":
                      "telescope_config.yaml"},
    }
    obs_path = os.path.join(outdir, "obsparam.yaml")
    with open(obs_path, "w") as f:
        yaml.safe_dump(obsparam, f)
    return obs_path
