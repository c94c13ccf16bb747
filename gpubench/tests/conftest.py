"""Test set-up of the benchmark's own tests:

    python -m pytest gpubench/tests -q

They run on the CPU at tiny sizes; the tests marked `gpu` need a CUDA card
and skip without one (the decision is made in the `card` fixture)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


TINY_SAMPLE = dict(baselines_span=4, baselines_random=3, channels_span=6,
                   channels_random=2, snapshots=3, simulations=8)


def tiny(workload, engine=None, layout="HERA-7", nchan=32, nside=8,
         n_acc=3):
    """(cell, config) of a real cell cut to a size the CPU holds."""
    from gpubench import harness as H
    cell = H.load_workload(workload)
    config = copy.deepcopy(H.load_config(cell["config"]))
    s = config["sections"]
    s["array"]["layout"] = layout
    s["bandpass"]["nchan"] = nchan
    s["skyparm"]["nside"] = nside
    cell = dict(cell, n_acc=n_acc, sample=dict(TINY_SAMPLE))
    if engine is not None:
        # on the CPU, engine auto is the direct engine; nufft drives the
        # banded engine there
        cell["engine"] = engine
    return cell, config
