"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (set-up, the window, the check) on the CPU at a tiny size, with one
fault of gpubench/faults.py planted in the program: the engine's faults
through the direct, banded and sorted engines, the noise's through the
direct engine (the noise is drawn and added after either). The same run
without a fault is correct. The product faults, which need a cell that
writes its product, are in test_gpubench_products.py."""

import pytest

from gpubench import faults
from gpubench import harness as H

from conftest import tiny

ENGINE_FAULTS = ("none", "state_unchanged", "half_the_batch",
                 "answer_altered")
NOISE_FAULTS = ("noise_dropped", "noise_doubled", "noise_not_added")


def _run(fault, cell, config):
    undo = faults.plant(fault)
    try:
        return H.run_cell(cell, config, 2 ** 31 + 77, 0.3, False,
                          device="cpu", log=open("/dev/null", "w"))
    finally:
        undo()


@pytest.mark.parametrize("engine,expect", [("direct", "direct"),
                                           ("nufft", "banded")])
@pytest.mark.parametrize("fault", ENGINE_FAULTS)
def test_fault_makes_the_run_not_correct(fault, engine, expect):
    cell, config = tiny("hera331.banded", engine=engine)
    cell["expect_engine"] = expect
    res = _run(fault, cell, config)
    assert res is not None and res["attempted"] >= 1
    if fault == "none":
        assert res["correct"] and res["failed"] == 0
    else:
        assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ("none",) + NOISE_FAULTS)
def test_noise_fault_makes_the_run_not_correct(fault):
    # 9 baselines x 128 channels x 4 accumulations: enough noise samples
    # that noise left out or doubled reads far over the noise_z limit
    cell, config = tiny("hera37.direct", layout="HERA-7", nchan=128,
                        n_acc=4)
    res = _run(fault, cell, config)
    assert res is not None and res["attempted"] >= 1
    checks = res["checks"]
    if fault == "none":
        assert res["correct"] and res["failed"] == 0, checks
    else:
        assert not res["correct"], checks
        bad = {"noise_not_added": "sum_err"}.get(fault, "noise_z")
        assert checks[bad]["value"] > checks[bad]["limit"], checks


@pytest.mark.parametrize("fault", ENGINE_FAULTS)
def test_fault_on_the_sorted_route(fault):
    """hera331.sorted cut to the CPU as tests/test_sorted_route.py cuts it
    (HERA-19, 64 channels over the same band, nside 16, 2 accumulations):
    the snapshot faults plant in the sorted route's engine too."""
    cell, config = tiny("hera331.sorted", layout="HERA-19", nchan=64,
                        nside=16, n_acc=2)
    config["sections"]["bandpass"]["freq_resolution"] = 100e6 / 64
    res = _run(fault, cell, config)
    assert res is not None and res["attempted"] >= 1
    assert res["failed"] == 0
    if fault == "none":
        assert res["correct"], res["checks"]
    else:
        assert not res["correct"], res["checks"]
        assert res["checks"]["vis_err"]["value"] > \
            res["checks"]["vis_err"]["limit"]
