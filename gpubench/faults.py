"""Faults planted in the program, to show that `correct` catches them.

Each entry returns {name: replacement} for attributes of
prisim_tpu_torch.driver; the benchmark's runs plant none. The tests in
gpubench/tests/ plant each in a run on the CPU, and calibrate.py
(--fault) in a run on the card at a cell's own size:

    state_unchanged  every snapshot returns the first one's visibilities
                     (a step that leaves its state unchanged), on the
                     direct, banded and sorted routes
    half_the_batch   half of the sources left out, the rest doubled (the
                     mean taken over the rest)
    answer_altered   the last snapshot's visibilities conjugated where
                     the engine produces them, on the same three routes
    noise_dropped    the thermal noise drawn as zeros
    noise_doubled    the thermal noise drawn at twice its rms
    noise_not_added  the noise drawn but not added to the visibilities
    product_sky_zeroed  the product written with its sky visibilities
                     zeroed; the set run_simulation returns stays right
    product_stale    each product written from the first set of its shape
                     that the writer was given (a stale buffer): from the
                     second simulation of a run on, another simulation's
                     data set; the returned sets stay right

A cell runs on one card, so there is no exchange between cards to leave
out.
"""

import dataclasses

import numpy as np


def _each_snapshot(fn):
    """Wrap the driver's engines so that fn edits their (T, B, C) cube."""
    from prisim_tpu_torch import driver

    def wrap(inner):
        def engine(*a, **k):
            return fn(inner(*a, **k))
        return engine
    return {"simulate_drift": wrap(driver.simulate_drift),
            "_simulate_banded": wrap(driver._simulate_banded),
            "_simulate_sorted": wrap(driver._simulate_sorted)}


def _unchanged(v):
    return v[:1].expand_as(v).clone()


def _altered(v):
    v = v.clone()
    v[-1] = v[-1].conj()
    return v


def _half_the_sources():
    from prisim_tpu_torch import driver
    inner = driver.build_observed_sky

    def sky(*a, **k):
        sm = inner(*a, **k)
        scale = np.array(sm.spec_parms["flux-scale"], dtype=np.float64)
        scale[1::2] = 0.0
        scale[0::2] *= 2.0
        return dataclasses.replace(sm, spec_parms=dict(
            sm.spec_parms, **{"flux-scale": scale}))
    return {"build_observed_sky": sky}


def _noise_scaled(factor):
    from prisim_tpu_torch import driver
    inner = driver.generate_noise

    def noise(*a, **k):
        return inner(*a, **k) * factor
    return {"generate_noise": noise}


def _noise_not_added():
    from prisim_tpu_torch import driver
    inner = driver.apply_gains

    def apply(skyvis, gains, noise=None):
        return inner(skyvis, gains)
    return {"apply_gains": apply}


def _product_sky_zeroed():
    from prisim_tpu_torch import driver
    inner = driver._save_products

    def save(vs, parms, outdir=None):
        return inner(dataclasses.replace(vs, skyvis=np.zeros_like(
            vs.skyvis)), parms, outdir)
    return {"_save_products": save}


def _product_stale():
    from prisim_tpu_torch import driver
    inner = driver._save_products
    first = {}

    def save(vs, parms, outdir=None):
        return inner(first.setdefault(np.shape(vs.vis), vs), parms, outdir)
    return {"_save_products": save}


FAULTS = {"none": lambda: {},
          "state_unchanged": lambda: _each_snapshot(_unchanged),
          "half_the_batch": _half_the_sources,
          "answer_altered": lambda: _each_snapshot(_altered),
          "noise_dropped": lambda: _noise_scaled(0.0),
          "noise_doubled": lambda: _noise_scaled(2.0),
          "noise_not_added": _noise_not_added,
          "product_sky_zeroed": _product_sky_zeroed,
          "product_stale": _product_stale}


def plant(name):
    """Plant fault `name` in the driver; returns a function that takes it
    out again."""
    from prisim_tpu_torch import driver
    patches = FAULTS[name]()
    saved = {k: getattr(driver, k) for k in patches}
    for k, fn in patches.items():
        setattr(driver, k, fn)

    def undo():
        for k, fn in saved.items():
            setattr(driver, k, fn)
    return undo
