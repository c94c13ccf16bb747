"""The readings that the limits of `correct` are set from.

    python3 gpubench/calibrate.py --workload <cell> --seeds <n,n,...>
                                  [--control 3] [--phase32 3]
                                  [--faults <name,...>] [--fault-seeds 3]
                                  [--out <file.jsonl>]

On the card, at the cell's own size, in one process: set-up as a run
makes it, then for each seed the simulation that a run's window starts
with (the seed's LST, the cell's accumulations) through run_simulation,
its sample judged by the reference as a run judges it (the program's
readings); for the first --control seeds, the control too: the reference
one step below the precision the configuration states (float32 phases,
bfloat16 amplitudes; reference/model.py) put in the program's place; for
the first --phase32 seeds, the reference with float32 phases alone; a
reference that has no such precision (its `precisions`) gives "not
computed" in their place. Then each fault of gpubench/faults.py named in
--faults, planted in the program once for its first --fault-seeds seeds.
The configuration's own reference judges (harness.reference_class). A
cell with a product writes each simulation's product as a run does and is
judged by the file read back (reference/products.py), beside the readings
of the arrays the simulation returned (`memory`); the files are removed
once read. One JSON line a simulation, on standard output and in --out.
The benchmark's runs never run this.
"""

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def calibrate(cell, config, seeds, n_control, device, n_phase32=0,
              fault_names=(), n_fault=3, log=sys.stderr):
    """Yield one dict a simulation: its seed, LST, fault (None for the
    program as it is), engine, seconds, readings and, for the program's
    first seeds, the controls' readings."""
    import torch
    from gpubench import faults
    from gpubench import harness as H
    dev = torch.device(device)
    try:
        if not H.set_up(cell, config, seeds[0], dev, log):
            raise SystemExit("gpubench calibrate: the set-up failed")
        ref, n = None, 0
        for fault, group in [(None, seeds)] + [(f, seeds[:n_fault])
                                               for f in fault_names]:
            undo = faults.plant(fault) if fault else None
            try:
                for k, seed in enumerate(group):
                    n += 1
                    row, ref = _simulation(
                        cell, config, seed, fault,
                        fault is None and k < n_control,
                        fault is None and k < n_phase32, dev, n, ref, log)
                    yield row
            finally:
                if undo:
                    undo()
    finally:
        shutil.rmtree(H.products_dir(), ignore_errors=True)


def _simulation(cell, config, seed, fault, control, phase32, dev, n, ref,
                log):
    """(row, reference) of the n-th simulation, the one a run's window
    starts with; the reference is built on the first that completes."""
    from prisim_tpu_torch.config import load_parms
    from gpubench import harness as H
    from gpubench.reference.check import keep_sample, readings, sample_indices
    draws, rng = H.lst_draws(cell, seed)
    lst = float(draws[1])
    parms = load_parms(H.cell_sections(cell, config, lst, seed))
    vs, rec = H.simulate(parms, dev, H.sim_dir(cell, n))
    row = dict(seed=seed, lst_init=lst, fault=fault,
               engine=rec["engine"], error=rec["error"],
               seconds=rec["t_end"] - rec["t_start"],
               phases={key: sum(x[2] for x in v)
                       for key, v in rec["spans"].items()})
    if rec["error"] or rec["engine"] != cell["expect_engine"]:
        H._echo(rec, log)
        return row, ref
    if ref is None:
        ref = H.reference_class(config)(
            H.cell_sections(cell, config, 0.0, seed), device=dev)
    idx = sample_indices(ref, rng, cell["sample"])
    got = keep_sample(vs, idx)
    del vs
    H._release(dev)
    t0 = time.time()
    if rec["outdir"] is None:
        row["readings"] = readings(got, ref, lst, idx)
    else:
        row.update(
            product_bytes=H.product_bytes(rec["outdir"]),
            write_s=sum(x[2] for x in rec["spans"].get("write", ())),
            readings=H.judged(H.product_file(rec["outdir"]), ref, lst, idx,
                              log),
            memory=readings(got, ref, lst, idx))
        shutil.rmtree(rec["outdir"], ignore_errors=True)
    row["check_s"] = time.time() - t0
    # a control keeps the program's noise draw, the same in memory and in
    # the file
    offered = getattr(ref, "precisions", ("float64",))
    for name, wanted in (("control", control), ("phase32", phase32)):
        if wanted:
            row[name] = (readings(got, ref, lst, idx, name)
                         if name in offered else "not computed")
    return row, ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--phase32", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gpubench import harness as H
    import torch
    if not torch.cuda.is_available():
        print("gpubench calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = H.load_workload(args.workload)
    config = H.load_config(cell["config"])
    seeds = [int(x) for x in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    try:
        for row in calibrate(cell, config, seeds, args.control, "cuda",
                             args.phase32,
                             [f for f in args.faults.split(",") if f],
                             args.fault_seeds):
            line = json.dumps(dict(row, workload=args.workload))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
