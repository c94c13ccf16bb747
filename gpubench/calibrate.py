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
the first --phase32 seeds, the reference with float32 phases alone. Then
each fault of gpubench/faults.py named in --faults, planted in the
program, on the first --fault-seeds seeds. One JSON line a simulation, on
standard output and in --out. The benchmark's runs never run this.
"""

import argparse
import json
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
    from prisim_tpu_torch.config import load_parms
    from gpubench import faults
    from gpubench import harness as H
    from gpubench.reference.check import keep_sample, readings, sample_indices
    from gpubench.reference.model import DriftReference
    dev = torch.device(device)
    if not H.set_up(cell, config, seeds[0], dev, log):
        raise SystemExit("gpubench calibrate: the set-up failed")
    ref = None
    runs = [(seed, k, None) for k, seed in enumerate(seeds)]
    runs += [(seed, k, f) for f in fault_names
             for k, seed in enumerate(seeds[:n_fault])]
    for seed, k, fault in runs:
        draws, rng = H.lst_draws(cell, seed)
        lst = float(draws[1])
        parms = load_parms(H.cell_sections(cell, config, lst, seed))
        undo = faults.plant(fault) if fault else None
        try:
            vs, rec = H.simulate(parms, dev)
        finally:
            if undo:
                undo()
        row = dict(seed=seed, lst_init=lst, fault=fault,
                   engine=rec["engine"], error=rec["error"],
                   seconds=rec["t_end"] - rec["t_start"],
                   phases={key: sum(x[2] for x in v)
                           for key, v in rec["spans"].items()})
        if rec["error"] or rec["engine"] != cell["expect_engine"]:
            H._echo(rec, log)
            yield row
            continue
        if ref is None:
            ref = DriftReference(H.cell_sections(cell, config, 0.0, seed),
                                 device=dev)
        idx = sample_indices(ref, rng, cell["sample"])
        got = keep_sample(vs, idx)
        del vs
        H._release(dev)
        t0 = time.time()
        row["readings"] = readings(got, ref, lst, idx)
        row["check_s"] = time.time() - t0
        if fault is None and k < n_control:
            row["control"] = readings(got, ref, lst, idx, "control")
        if fault is None and k < n_phase32:
            row["phase32"] = readings(got, ref, lst, idx, "phase32")
        yield row


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
