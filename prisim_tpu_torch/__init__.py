"""prisim_tpu_torch — the PyTorch/CUDA port of prisim_tpu.

The simulator's direct-engine drift-scan path on torch tensors, with the
NUDFT kernel written by hand in CUDA C++ for the NVIDIA H100 (sm_90a).
The JAX package prisim_tpu is the reference it is held against; this
package imports neither jax nor anything of prisim_tpu: it keeps its own
copies of the numpy host modules (constants, layouts, baselines, healpix,
ephemeris, skymodel, gains). Only the tests import both packages.

Entry points (lazy: importing the package imports nothing heavy):

    from prisim_tpu_torch import run_simulation, load_parms
    vs, outdir = run_simulation(parms, device="cuda")   # or "cpu"

    python -m prisim_tpu_torch.driver -i parms.yaml [--device cuda|cpu]

The device is explicit: "cuda" without a card raises.
"""

__version__ = "0.1.0"

_LAZY = {
    "run_simulation": ("prisim_tpu_torch.driver", "run_simulation"),
    "load_parms": ("prisim_tpu_torch.config", "load_parms"),
    "DEFAULT_PARMS": ("prisim_tpu_torch.config", "DEFAULT_PARMS"),
    "VisibilitySet": ("prisim_tpu_torch.vis", "VisibilitySet"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError("module 'prisim_tpu_torch' has no attribute %r"
                         % name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
