"""The benchmark's harness: cells by name, the window, the trace, the check.

A cell is `workloads/<name>.json`; it names its configuration,
`configs/<name>.json`, whose `sections` are the parameter sections the
program is given, and may name the plain reference that judges it
(`reference_class`; reference/__init__.py). A per-layer metric is
`metrics/<name>.py`, found by the name BENCHMARK.json gives it. `run_cell`
runs one cell: set-up (CUDA, the kernel libraries, a warm simulation of
one accumulation at the cell's shapes), then the window, a closed loop of
whole simulations through prisim_tpu_torch.driver.run_simulation, each
drawing its LST from the seed; then, with the program's state freed, the
plain reference judges a sample, drawn from the seed, of what the
simulations produced. A cell without a `product` writes none and is
judged by the arrays run_simulation returned; a cell with
`"product": {"fmt": "fits"}` writes each simulation's native FITS
product, the warm one's too, under build/products/<pid>/ inside the
window, is judged by the files read back (reference/products.py), and
removes them once judged.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import io
import json
import os
import re
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "prisim_tpu")
PHASE_LINE = re.compile(r"^\[prisim_tpu_torch\] \.\.\. (.+) \(([0-9.]+) s\)$")
# the driver's phase labels, by the key the metrics read
PHASES = {"inputs": "inputs built and on", "gate": "banded shared-amps gate",
          "vis": "visibilities computed + transferred",
          "noise": "Tsys, rms and noise",
          "post": "gains, container, phasing, projection"}
# and the product's write, which only a cell with a product prints
PRODUCT_PHASES = dict(PHASES, write="products saved")
SHORT = {"inputs": "inputs (driver.prepare_simulation)",
         "gate": "banded gate", "vis": "snapshots and transfer",
         "noise": "finalize: Tsys, rms and noise",
         "post": "finalize: gains, container, phasing, projection",
         "write": "product write (driver._save_products)"}
DEFAULT_REFERENCE = "model.DriftReference"
# what a simulation's run_simulation writes: nothing, or the check's file
NO_PRODUCT = {"fmt": "none", "npz": False}
FITS_PRODUCT = {"fmt": "fits", "npz": False}
NOT_A_PRODUCT = {
    "npz": "the NPZ export holds no noise rms and no projected baselines",
    "hdf5": "HDF5 needs h5py, which the card's machine does not have"}


# -- by name --------------------------------------------------------------

def _json(path):
    with open(path) as f:
        return json.load(f)


def load_workload(name):
    path = HERE / "workloads" / (name + ".json")
    if not path.is_file():
        raise SystemExit("gpubench: no cell %r (%s)" % (name, path))
    return _json(path)


def load_config(name):
    return _json(HERE / "configs" / (name + ".json"))


def load_metric(name):
    """The module metrics/<name>.py."""
    path = HERE / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_entries(cell_name):
    """(end-to-end names, per-layer names) that BENCHMARK.json asks of
    this cell."""
    bench = _json(ROOT / "BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or cell_name in m["workloads"]
    return ([m["name"] for m in bench["end_to_end"] if mine(m)],
            [m["name"] for m in bench["per_layer"] if mine(m)])


def reference_class(config):
    """The class of the configuration's plain reference: its
    "reference_class", "<module>.<Class>" of reference/<module>.py, or
    model.DriftReference where the key is absent. SystemExit, naming the
    configuration and the key, where there is no such class."""
    name = config.get("reference_class", DEFAULT_REFERENCE)
    mod, _, cls = str(name).partition(".")
    full = "%s.reference.%s" % (__package__, mod)
    found = None
    if mod.isidentifier() and cls.isidentifier():
        try:
            found = getattr(importlib.import_module(full), cls, None)
        except ModuleNotFoundError as exc:
            if exc.name != full:
                raise
    if not isinstance(found, type):
        raise SystemExit("gpubench: configuration %r: reference_class %r "
                         "names no class of gpubench/reference/<module>.py"
                         % (config.get("name"), name))
    return found


def product_format(cell):
    """The format of the product a simulation of `cell` writes: None
    without a "product", else "fits" (the native-schema FITS product,
    which holds every array the check reads). SystemExit, with the
    reason, for any other."""
    product = cell.get("product")
    if product is None:
        return None
    if product == {"fmt": "fits"}:
        return "fits"
    fmt = str(product.get("fmt")).lower() if isinstance(product, dict) \
        else None
    raise SystemExit("gpubench: cell %r: product %r: only "
                     '{"fmt": "fits"} is written (%s)'
                     % (cell.get("name"), product, NOT_A_PRODUCT.get(
                         fmt, "no product format of the port")))


def cell_sections(cell, config, lst_hours, seed, n_acc=None):
    """The parameter sections of one simulation of `cell`."""
    s = copy.deepcopy(config["sections"])
    s["obsparm"]["n_acc"] = int(n_acc or cell["n_acc"])
    s["pointing"]["lst_init"] = float(lst_hours)
    s.setdefault("processing", {})["engine"] = cell["engine"]
    s["skyparm"]["seed"] = int(seed)
    s["save_formats"] = dict(FITS_PRODUCT if product_format(cell)
                             else NO_PRODUCT)
    return s


def products_dir():
    """Where this process's simulations write their products: inside the
    checkout, beside build/kernels/, one directory a process."""
    return ROOT / "build" / "products" / str(os.getpid())


def sim_dir(cell, i):
    """Where simulation `i` of a run of `cell` writes its product (0 the
    warm one): products_dir()/sim<i>, or None for a cell without one."""
    return products_dir() / ("sim%d" % i) if product_format(cell) else None


def product_file(outdir):
    """The native FITS product run_simulation writes under `outdir`."""
    return Path(outdir) / "simdata" / "simvis.fits"


def product_bytes(outdir):
    """Bytes of every file run_simulation wrote under `outdir`."""
    return sum(f.stat().st_size for f in Path(outdir).rglob("*")
               if f.is_file())


def lst_draws(cell, seed):
    """The LST (hours) of the warm simulation and of each simulation of the
    window, and the generator the sample is drawn from."""
    rng = np.random.default_rng(int(seed))
    lo, hi = cell["lst_hours"]
    draws = rng.uniform(lo, hi, 4096)
    return draws, rng


# -- one simulation -------------------------------------------------------

class TimedLines(io.TextIOBase):
    """A text stream that keeps each line with the host time it ended."""

    def __init__(self):
        self.lines = []
        self._part = ""

    def writable(self):
        return True

    def write(self, s):
        now = time.time()
        self._part += s
        *done, self._part = self._part.split("\n")
        self.lines.extend((now, line) for line in done)
        return len(s)


def engine_of(text):
    """The engine a run took, from its verbose log."""
    if "falling back to the direct engine" in text:
        return "demoted to direct"
    if "delay-space NUFFT" in text:
        return "sorted"
    return "banded" if "banded NUFFT:" in text else "direct"


def phase_spans(lines, t_start, phases=PHASES):
    """{key: [(start, end, seconds)]} of the driver's phases (`phases`,
    label by key), on the host clock of the lines: each phase ends when its
    line is printed and starts where the one before it ended (the
    simulation's start for the inputs), the gate where the banded engine
    printed its plan."""
    spans, prev, plan_t = {}, t_start, None
    for t, line in lines:
        if line.startswith("[prisim_tpu_torch] banded NUFFT:"):
            plan_t = t
        m = PHASE_LINE.match(line)
        key = m and next((k for k, p in phases.items()
                          if m.group(1).startswith(p)), None)
        if not key:
            continue
        if key == "gate":
            a = prev if plan_t is None else plan_t
        else:
            a, prev = prev, t
        spans.setdefault(key, []).append((a, t, t - a))
    return spans


def simulate(parms, device, outdir=None):
    """run_simulation(parms, save=False, verbose=True), or with an
    `outdir` run_simulation(parms, outdir=outdir, save=True, verbose=True),
    which writes the product the sections' save_formats name there, with
    its output kept line by line: (VisibilitySet or None, record)."""
    from prisim_tpu_torch.driver import run_simulation
    out = TimedLines()
    rec = dict(t_start=time.time(), error=None, outdir=outdir)
    vs = None
    try:
        with contextlib.redirect_stdout(out):
            if outdir is None:
                vs, _ = run_simulation(parms, save=False, verbose=True,
                                       device=device)
            else:
                vs, _ = run_simulation(parms, outdir=str(outdir), save=True,
                                       verbose=True, device=device)
    except Exception as exc:         # a failed operation: counted, not fatal
        rec["error"] = "%s: %s" % (type(exc).__name__, exc)
    rec["t_end"] = time.time()
    rec["lines"] = out.lines
    text = "\n".join(line for _, line in out.lines)
    rec["engine"] = engine_of(text)
    rec["spans"] = phase_spans(out.lines, rec["t_start"],
                               PHASES if outdir is None else PRODUCT_PHASES)
    return vs, rec


# -- the trace ------------------------------------------------------------

def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class DeviceTrace:
    """Device events of one profiled simulation, on the host's clock."""

    def __init__(self, prof, rec, marker):
        from torch.autograd import DeviceType
        events = list(prof.events())
        mark = [e for e in events if e.name == marker]
        # profiler microseconds -> host seconds, by the marker's start
        off = rec["t_start"] - mark[0].time_range.start / 1e6 if mark else 0.0
        self.ops = []                       # (name, start s, end s)
        for e in events:
            # the marker's device-side annotation is no operation
            if e.device_type == DeviceType.CUDA and e.name != marker \
                    and not getattr(e, "is_user_annotation", False):
                self.ops.append((e.name, e.time_range.start / 1e6 + off,
                                 e.time_range.end / 1e6 + off))
        self.t0, self.t1 = rec["t_start"], rec["t_end"]
        self.window_s = self.t1 - self.t0
        self.busy = _union([(a, b) for _, a, b in self.ops])
        self.busy_s = sum(b - a for a, b in self.busy)
        self.spans = rec["spans"]

    def kernel_seconds(self, pattern):
        """Summed device time of the operations whose name matches."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.ops if rx.search(n))

    def by_name(self, n=10):
        tot = {}
        for name, a, b in self.ops:
            tot[name] = tot.get(name, 0.0) + (b - a)
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]

    def phase_at(self, t):
        """The innermost driver phase that holds host time t."""
        best = None
        for key, spans in self.spans.items():
            for a, b, sec in spans:
                if a <= t <= b and (best is None or sec < best[1]):
                    best = (key, sec)
        return SHORT[best[0]] if best else "host, outside the driver's phases"

    def idle_gaps(self, n=10):
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.phase_at(0.5 * (a + b)), b - a] for a, b in gaps[:n]]


class TraceInfo:
    """What a per-layer metric reads: the cell, the reference's geometry,
    the simulations of the window (their phase spans), and the profiled
    one's record, device events and banded plan sizes."""

    def __init__(self, cell, ref, sims, device_trace, profiled, plan):
        self.cell, self.ref = cell, ref
        self.sims = sims
        self.trace = device_trace
        self.profiled = profiled
        self.plan = plan

    def phase_mean(self, *keys):
        """Mean over the simulations of the summed seconds of these phase
        keys; None where no simulation printed them."""
        vals = []
        for rec in self.sims:
            got = [sum(s[2] for s in rec["spans"][k]) for k in keys
                   if k in rec["spans"]]
            if got:
                vals.append(sum(got))
        return float(np.mean(vals)) if vals else None


# -- the run --------------------------------------------------------------

def _release(device):
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def set_up(cell, config, seed, dev, log, t_process=None):
    """CUDA, the kernel libraries the cell's engine launches, and a warm
    simulation of one accumulation at the cell's shapes (the LST of the
    seed's first draw). False, with the reason on `log`, when the warm
    simulation fails or takes another engine. Prints the seconds of each
    part, from t_process (the process's start) where given."""
    marks = [("", time.time() if t_process is None else t_process)]
    import torch
    from prisim_tpu_torch import _build
    from prisim_tpu_torch.config import load_parms
    marks.append(("start and imports", time.time()))
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
        marks.append(("cuda", time.time()))
        libs = ("nudft", "banded") if cell["expect_engine"] == "banded" \
            else ("nudft",)
        for name in libs:
            _build.load_kernel_library(name)
            info = _build.build_info(name)
            print("gpubench build: %s %s in %.3f s (%s)"
                  % (name, "compiled" if info["built"] else "loaded",
                     info["seconds"], info["path"]), file=log)
        marks.append(("libraries", time.time()))
    draws, _ = lst_draws(cell, seed)
    warm = load_parms(cell_sections(cell, config, draws[0], seed, n_acc=1))
    _, rec = simulate(warm, dev, sim_dir(cell, 0))
    marks.append(("warm simulation", time.time()))
    print("gpubench set-up: " + ", ".join(
        "%s %.3f s" % (k, t - marks[i][1])
        for i, (k, t) in enumerate(marks[1:])), file=log)
    _echo(rec, log)
    if rec["error"] or rec["engine"] != cell["expect_engine"]:
        print("gpubench: the warm simulation failed (engine %s, %s)"
              % (rec["engine"], rec["error"]), file=log)
        return False
    _release(dev)
    return True


def run_cell(cell, config, seed, seconds, trace, device="cuda",
             t_process=None, per_layer=(), end_to_end=("vis_rate", "peak_gb",
                                                       "setup_s"),
             log=sys.stderr):
    """Run one cell; returns the result dict that run.py prints (None
    where a guarantee of the run broke: then it says why on `log`). The
    products of a cell that writes them are removed, with products_dir(),
    once the run is judged or has failed."""
    try:
        return _run_cell(cell, config, seed, seconds, trace, device,
                         t_process, per_layer, end_to_end, log)
    finally:
        shutil.rmtree(products_dir(), ignore_errors=True)


def _run_cell(cell, config, seed, seconds, trace, device, t_process,
              per_layer, end_to_end, log):
    t_process = time.time() if t_process is None else t_process
    import torch
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    from prisim_tpu_torch.config import load_parms
    draws, rng = lst_draws(cell, seed)
    if not set_up(cell, config, seed, dev, log, t_process):
        return None

    # the window
    plan_sizes = []
    if trace:
        from prisim_tpu_torch import driver as drv
        from torch.profiler import ProfilerActivity, profile, record_function
        engine_fn = drv.banded_engine

        def spy(*a, **k):
            plan, snap = engine_fn(*a, **k)
            plan_sizes.append(dict(
                K=plan.K, rank=plan.rank, ndir=plan.ndir, nbl=plan.nbl,
                R_max=plan.R_max, n_chunks=snap.n_chunks,
                src_chunk=snap.src_chunk, truth=bool(snap.truth)))
            return plan, snap
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    setup_s = t0 - t_process
    sims, kept, dev_trace, profiled, prof = [], [], None, None, None
    i = 0
    while time.time() - t0 < seconds:
        i += 1
        lst = float(draws[i])
        parms = load_parms(cell_sections(cell, config, lst, seed))
        if trace and i == 1:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            drv.banded_engine = spy
            try:
                with profile(activities=acts) as prof:
                    with record_function("gpubench.simulation"):
                        vs, rec = simulate(parms, dev, sim_dir(cell, i))
            finally:
                drv.banded_engine = engine_fn
            profiled = rec
        else:
            vs, rec = simulate(parms, dev, sim_dir(cell, i))
        rec["lst_init"] = lst
        rec["ok"] = rec["error"] is None and \
            rec["engine"] == cell["expect_engine"]
        sims.append(rec)
        if rec["ok"] and rec["outdir"] is not None:
            # the product, read back once the window has closed
            kept.append((lst, product_file(rec["outdir"])))
        elif rec["ok"]:
            # the returned arrays, sampled once the window has closed
            kept.append((lst, SimpleNamespace(
                skyvis=vs.skyvis, vis=vs.vis, vis_noise=vs.vis_noise,
                projected_baselines=vs.projected_baselines,
                vis_rms=vs.vis_rms, lst=vs.lst)))
        else:
            print("gpubench: simulation %d at LST %.6f h failed: engine %s, "
                  "%s" % (i, lst, rec["engine"], rec["error"]), file=log)
        del vs
    t_end = max(r["t_end"] for r in sims)
    window_s = t_end - t0
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print("gpubench: the process holds %s after the window"
              % ", ".join(loaded), file=log)
        return None
    for rec in sims:
        _echo(rec, log)
    _log_products(sims, log)
    if prof is not None and cuda:
        dev_trace = DeviceTrace(prof, profiled, "gpubench.simulation")
    del prof

    # the check: a sample of the completed simulations (all of them where
    # the cell's sample holds as many), and of each a sample, drawn from
    # the seed, against the reference
    from .reference.check import (judge, keep_sample, pick_simulations,
                                  sample_indices, worst)
    t_check = time.time()
    ref = reference_class(config)(cell_sections(cell, config, 0.0, seed),
                                  device=dev)
    idx = sample_indices(ref, rng, cell["sample"])
    kept = [(kept[i][0], kept[i][1] if isinstance(kept[i][1], Path)
             else keep_sample(kept[i][1], idx)) for i in
            pick_simulations(len(kept), rng, cell["sample"]["simulations"])]
    _release(dev)
    per_sim = [judged(got, ref, lst, idx, log) for lst, got in kept]
    numbers = worst(per_sim)
    limits = cell["limits"]
    correct = bool(kept) and judge(numbers, limits)
    check_s = time.time() - t_check

    ok = [r for r in sims if r["ok"]]
    vis_per_sim = ref.nbl * ref.nchan * cell["n_acc"]
    result = dict(correct=correct, attempted=len(sims),
                  failed=len(sims) - len(ok))
    metrics = {}
    if not trace:
        values = dict(
            vis_rate=(vis_per_sim * len(ok) / window_s, "vis/s"),
            peak_gb=(peak / 1e9, "GB"), setup_s=(setup_s, "s"))
        for name in end_to_end:
            if name in values and (name != "vis_rate" or ok):
                metrics[name] = dict(value=values[name][0],
                                     unit=values[name][1])
    else:
        unprofiled = [r for r in ok if r is not profiled]
        info = TraceInfo(cell, ref, unprofiled or ok, dev_trace, profiled,
                         plan_sizes[-1] if plan_sizes else None)
        for name in per_layer:
            mod = load_metric(name)
            value = mod.read(info) if (profiled and profiled["ok"]) else None
            if value is not None:
                metrics[name] = dict(value=float(value), unit=mod.UNIT)
    result["metrics"] = metrics
    device_info = dict(
        platform="gpu" if cuda else dev.type,
        kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        count=1, memory_peak_bytes=peak)
    if trace and dev_trace is not None:
        device_info.update(busy_s=dev_trace.busy_s,
                           window_s=dev_trace.window_s)
        result["breakdown"] = dict(
            device_ops=[[n[:120], s] for n, s in dev_trace.by_name()],
            idle_gaps=dev_trace.idle_gaps())
    result["device"] = device_info
    result["checks"] = {k: dict(value=numbers[k], limit=limits.get(k))
                        for k in numbers}
    print("gpubench: window %.3f s, %d simulations (%d failed), set-up "
          "%.3f s, check %.3f s over %d simulations"
          % (window_s, len(sims), len(sims) - len(ok), setup_s, check_s,
             len(kept)), file=log)
    for k in numbers:
        print("check %s %r limit %r" % (k, numbers[k], limits.get(k)),
              file=log)
    return result


def judged(got, ref, lst_init, idx, log):
    """The readings of one simulation: of the sample kept in memory, or of
    the sample read back from its product's file (inf, as for a sample of
    the wrong shape, where that file cannot be read)."""
    from .reference.check import NUMBERS, readings
    from .reference.products import read_sample
    if isinstance(got, Path):
        try:
            got = read_sample(got, idx)
        except (OSError, ValueError) as exc:
            print("gpubench: the product %s reads as no product: %s"
                  % (got, exc), file=log)
            return dict.fromkeys(NUMBERS, float("inf"))
    return readings(got, ref, lst_init, idx)


def _log_products(sims, log):
    """The bytes each simulation wrote, and the wall time of its write."""
    for rec in sims:
        if rec["outdir"] is not None:
            print("gpubench product: %s wrote %d bytes in %.3f s"
                  % (rec["outdir"], product_bytes(rec["outdir"]),
                     sum(x[2] for x in rec["spans"].get("write", ()))),
                  file=log)


def _echo(rec, log):
    for _, line in rec["lines"]:
        if line.startswith("[prisim_tpu_torch]"):
            print(line, file=log)
