"""Run one cell of the benchmark of the PyTorch/CUDA port on this machine.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Prints, as the last line of standard output, one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device` (and with --trace 1
`breakdown`) and last `checks`, the numbers that decided `correct`, each
with its limit; those numbers are also the last lines of standard error.
With --trace 0 the metrics are the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from a torch.profiler trace of the
window's first simulation and from the driver's phase lines. A cell
whose workload file has a "product" writes each simulation's product
under build/products/<pid>/ inside the window, is judged by the files
read back, and removes them before it prints. Exits non-zero, printing
no result, without a CUDA card, or when the process holds JAX or the JAX
package once the window has closed.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment():
    """No kernel variant and no debug dump. The kernel libraries build
    into build/kernels/ inside the checkout (prisim_tpu_torch._build)."""
    for name in ("PRISIM_KERNEL_DEFINES", "PRISIM_DEBUG_XCHECK_DUMP"):
        os.environ.pop(name, None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    from gpubench import harness

    cell = harness.load_workload(args.workload)
    config = harness.load_config(cell["config"])
    e2e, per_layer = harness.benchmark_entries(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("gpubench: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print("gpubench: the cell asks for %d cards, %d visible"
              % (cell["chips"], torch.cuda.device_count()), file=sys.stderr)
        return 2
    result = harness.run_cell(cell, config, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_process=T_PROCESS, per_layer=per_layer,
                              end_to_end=e2e)
    if result is None:
        return 3
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
