"""Device-mesh parallelism over (baseline, channel, source) axes.

Counterpart of prisim_tpu/parallel/mesh.py. JAX's mesh is a single
controller: one process drives every device of a jax.sharding.Mesh through
shard_map. Its counterpart here is one process that drives a grid of
torch.devices: a `Mesh` is an object array of torch.device shaped like the
mesh, with its axis names, and each shard's work is issued on its device
from the host loop (no torch.distributed, which would need a launcher and
rank-aware IO that the reference does not have).

  * bl/chan shards -> each (bl, chan) block runs the NUDFT on its own
    baseline rows and its own channel sub-grid, chan0 = i_chan *
    nchan_local offsetting the full band's grid scalars (exact in the
    two-float cycle counts), so no shard builds the full channel axis;
  * src shards -> partial visibilities of each source block, summed in a
    fixed shard order on the device of the block's first shard (JAX's
    psum over 'src');
  * the NUFFT with the sorted spread takes the same bl/chan/src shards:
    a chan shard spreads its own sub-band (the carrier offset by chan0
    dnu tau cycles) with its own Chebyshev basis;
  * the banded engine shards over 'bl' only: one collapse=False plan over
    the padded baselines, whose per-baseline tables each shard slices, so
    that every shard has the gate's G, R_max and FFT length.

Every shard's launches of a snapshot are issued before any result is read
back: on a host with several cards a read inside one shard would hold the
others. On a CUDA shard the kernels run (K1a, K2, delay_spread), on a CPU
shard their plain versions. A device may appear more than once in a mesh:
that is how a multi-shard mesh is built on the CPU (torch has one CPU device) or on a
one-card host, where the shards run one after another.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import tracing
from .. import twofloat as tf
from ..engine.cuda_nudft import nudft_cuda
from ..engine.nudft import nudft_visibilities
from ..engine.observe import (check_kernel_knobs, rotated_sources,
                              schedule_tensors)

__all__ = ["make_mesh", "pad_to_multiple", "simulate_drift_sharded",
           "simulate_drift_src_sharded", "simulate_drift_nufft_sharded",
           "simulate_drift_banded_sharded"]


@dataclasses.dataclass
class Mesh:
    """A grid of torch devices: `devices` is an object ndarray of
    torch.device shaped like the mesh, one axis per name of
    `axis_names`."""
    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self):
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self):
        """The device of the mesh's first shard."""
        return self.devices.flat[0]


def _as_device(d):
    """torch.device of `d`; a CUDA device without an index is the current
    card, and 'cuda' without a card raises."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mesh device %s was requested but no CUDA "
                               "card is available" % dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("mesh devices must be CUDA or CPU, got %s" % dev)
    return dev


def make_mesh(shape=None, axis_names=("bl", "chan"), devices=None):
    """Build a Mesh over `devices` (default: every visible CUDA card; raises
    without one).

    shape: tuple matching axis_names; default puts all devices on the first
    axis (visibilities are embarrassingly parallel over baselines). A list
    may repeat a device: `["cpu"] * 8` is an 8-shard mesh on the CPU."""
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_cards == 0:
            raise RuntimeError("make_mesh: no CUDA card is visible; pass "
                               "devices=[...] (e.g. ['cpu'] * n)")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = [_as_device(d) for d in np.asarray(devices, dtype=object).ravel()]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError("mesh shape %s does not match axis names %s"
                         % (shape, tuple(axis_names)))
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != #devices {n}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), tuple(axis_names))


def pad_to_multiple(arr, multiple, axis=0, value=0.0):
    """Pad `arr` along `axis` so its length is a multiple of `multiple`."""
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return np.asarray(arr)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(np.asarray(arr), pad, constant_values=value)


def _shards(mesh, axes):
    """{(i_bl, i_chan, i_src): device}: the shard of each block of the
    named `axes` (an axis of the mesh missing from `axes`, or any other
    axis, replicates: its first index serves)."""
    out = {}
    names = mesh.axis_names
    for idx in np.ndindex(mesh.devices.shape):
        pos = dict(zip(names, idx))
        if any(v for k, v in pos.items() if k not in axes):
            continue
        key = tuple(pos.get(a, 0) for a in ("bl", "chan", "src"))
        out[key] = mesh.devices[idx]
    return out


def _on(x, dev):
    """Tensor `x` as a contiguous tensor on `dev`."""
    return x.to(dev).contiguous()


def _zero_pad(t, rows, cols=0):
    """2-D tensor `t` with `rows` zero rows and `cols` zero columns added
    (`t` itself when there are none)."""
    return torch.nn.functional.pad(t, (0, cols, 0, rows)) if rows or cols \
        else t


def _sharded_drift(mesh, instrument, sky, observation, beam_fn, shard_fn,
                   src_axis, edge_channels=False):
    """The drift scan on `mesh`: pads and slices the inputs, runs
    shard_fn(x, sched_t) for every shard and accumulation (x the shard's
    inputs: blh/bll, seqh/seql, flux, freqs, chan0; sched_t its device's
    (Mh, Ml, pch, pcl) of the accumulation) and assembles the (T, B, C)
    complex64 result on the mesh's first device. Padded channels carry
    zero flux, or with `edge_channels` the last channel's."""
    axis_sizes = mesh.shape
    has_src = src_axis and "src" in axis_sizes
    if src_axis and not has_src:
        raise ValueError("src-sharded mode needs a 'src' mesh axis")
    if sky.src_shape_sigma is not None:
        raise ValueError("the mesh sums point sources; a sky with source "
                         "shapes runs on one device")
    n_bl = axis_sizes.get("bl", 1)
    n_ch = axis_sizes.get("chan", 1)
    n_src = axis_sizes.get("src", 1) if has_src else 1

    # Padding to divisible sizes, on the sky's device: zero baseline rows
    # (trimmed), zero flux on padded sources and on padded channels (or
    # the edge channel's, trimmed).
    nchan, nbl = instrument.nchan, instrument.nbl
    S = int(sky.s_eq_hi.shape[0])
    B_pad = -(-nbl // n_bl) * n_bl
    nchan_pad = -(-nchan // n_ch) * n_ch
    S_pad = -(-S // n_src) * n_src
    blh = _zero_pad(instrument.bl_hi, B_pad - nbl)
    bll = _zero_pad(instrument.bl_lo, B_pad - nbl)
    seqh = _zero_pad(sky.s_eq_hi, S_pad - S)
    seql = _zero_pad(sky.s_eq_lo, S_pad - S)
    flux = sky.flux
    if edge_channels and nchan_pad != nchan:
        flux = torch.cat([flux, flux[:, -1:].expand(-1, nchan_pad - nchan)],
                         dim=1)
    flux = _zero_pad(flux, S_pad - S, nchan_pad - flux.shape[1])
    freqs = np.concatenate([instrument.freqs, instrument.nu0 + instrument.dnu
                            * np.arange(nchan, nchan_pad)])

    nb, nc, ns = B_pad // n_bl, nchan_pad // n_ch, S_pad // n_src
    shards = _shards(mesh, ("bl", "chan", "src") if has_src
                     else ("bl", "chan"))
    inputs = {}
    sched = {}
    for (i, j, k), dev in shards.items():
        rb, rc, rs = (slice(i * nb, (i + 1) * nb), slice(j * nc, (j + 1) * nc),
                      slice(k * ns, (k + 1) * ns))
        inputs[i, j, k] = dict(
            blh=_on(blh[rb], dev), bll=_on(bll[rb], dev),
            seqh=_on(seqh[rs], dev), seql=_on(seql[rs], dev),
            flux=_on(flux[rs, rc], dev),
            freqs=torch.as_tensor(freqs[rc], dtype=torch.float32, device=dev),
            chan0=j * nc)
        if dev not in sched:
            sched[dev] = schedule_tensors(observation, instrument.latitude,
                                          dev)

    first = mesh.first
    T = observation.n_acc
    out = torch.empty((T, n_bl * nb, nchan_pad), dtype=torch.complex64,
                      device=first)
    for t in range(T):
        with tracing.span("snapshot", t=t):
            # every shard's launches first, then the reads
            parts = {key: shard_fn(inputs[key],
                                   tuple(a[t] for a in sched[dev]))
                     for key, dev in shards.items()}
            for i in range(n_bl):
                for j in range(n_ch):
                    acc = parts[i, j, 0]
                    for k in range(1, n_src):
                        acc = acc + parts[i, j, k].to(acc.device)
                    out[t, i * nb:(i + 1) * nb, j * nc:(j + 1) * nc] = \
                        acc.to(first)
    return out[:, :nbl, :nchan]


def _nudft_shard(instrument, beam_fn, src_block):
    """shard_fn of the direct engine: K1a on a CUDA shard, its plain
    version (in blocks of src_block sources) on a CPU shard, each shard on
    its own channel sub-grid (chan0)."""
    gs = instrument.grid_scalars()

    def shard_vis(x, sched_t):
        seh, sel, amps, _ = rotated_sources(*sched_t, x["seqh"], x["seql"],
                                            x["flux"], x["freqs"], beam_fn)
        args = (seh.contiguous(), sel.contiguous(), x["blh"], x["bll"],
                amps.contiguous(), gs, x["freqs"].shape[0])
        if seh.is_cuda:
            return nudft_cuda(*args, chan0=x["chan0"])
        return nudft_visibilities(*args, chan0=x["chan0"],
                                  src_block=src_block)

    return shard_vis


def _nufft_drift_core(x, sched_t, *, nu0, dnu, rank, K, beta, has_chan,
                      beam_fn):
    """One shard's accumulation of the NUFFT drift scan (sorted spread,
    kernel delay_spread on a card): the shard's baselines and sources on
    its own sub-band, whose Chebyshev basis it fits (chebyshev_basis_jit,
    kept in x), with the carrier offset by chan0 dnu tau cycles for a
    'chan' shard; the shard's sources below the horizon are left out
    before the beam. Spans "beam_flux" and "project", then those of
    _nufft_snapshot's blocks. Returns (B_shard, C_shard) complex64."""
    from ..engine.nufft_delay import (_nufft_snapshot, chebyshev_basis_jit,
                                      spectral_project)
    if "basis" not in x:
        x["basis"] = chebyshev_basis_jit(x["freqs"], rank)
    pinvQ, Qb = x["basis"]
    with tracing.span("beam_flux"):
        seh, sel, amps, _ = rotated_sources(*sched_t, x["seqh"], x["seql"],
                                            x["flux"], x["freqs"], beam_fn,
                                            above_horizon=True)
    with tracing.span("project"):
        P = spectral_project(amps, pinvQ)
    del amps
    return _nufft_snapshot(seh, sel, P, x["blh"], x["bll"], Qb, nu0, dnu,
                           x["freqs"].shape[0], beta=beta, K=K,
                           chan0=x["chan0"] if has_chan else None)


def simulate_drift_nufft_sharded(instrument, sky, observation, beam_fn,
                                 mesh, rank=16, K=13, beta=2.0):
    """Drift scan through the NUFFT engine with the sorted spread, sharded
    over ('bl', 'chan'[, 'src']) like the direct engine: 'bl' shards take
    their baselines, 'chan' shards their sub-band (chan0, with the padded
    channels edge-replicated so that the last shard's spectral fit stays
    smooth), 'src' partials are summed in shard order. Each shard fits its
    own sub-band's basis at rank min(rank, its channels). Returns (T, B, C)
    complex64 on the mesh's first device."""
    axis_sizes = mesh.shape
    n_ch = axis_sizes.get("chan", 1)
    nchan_local = -(-instrument.nchan // n_ch)
    core = functools.partial(
        _nufft_drift_core, nu0=instrument.nu0, dnu=instrument.dnu,
        rank=min(int(rank), nchan_local), K=K, beta=beta,
        has_chan="chan" in axis_sizes, beam_fn=beam_fn)
    return _sharded_drift(mesh, instrument, sky, observation, beam_fn, core,
                          src_axis="src" in axis_sizes and
                          axis_sizes["src"] > 1, edge_channels=True)


def _shard_plan(plan, rows):
    """The banded plan of the baselines `rows` (a slice) of a collapse=False
    plan: its per-baseline tables sliced, every other field (directions,
    G_blk, R_max, the FFT length) shared."""
    return dataclasses.replace(
        plan, d_of_b=plan.d_of_b[rows], blk_lo=plan.blk_lo[rows],
        n_blk=plan.n_blk[rows], blen_hi=plan.blen_hi[rows],
        blen_lo=plan.blen_lo[rows], ramp=plan.ramp[rows])


def simulate_drift_banded_sharded(instrument, sky, observation, beam_fn,
                                  mesh, rank=32, interpret=False,
                                  node_model=True, truth=None,
                                  plan_kw=None):
    """Drift scan through the banded NUFFT engine (kernel K2 on a card, its
    plain version on the CPU), sharded over the 'bl' mesh axis.

    One collapse=False plan over the baselines, padded with copies of
    baseline 0 to a multiple of the 'bl' size, gives each shard its rows'
    per-baseline tables (block ranges, |b|, ramp); the directions, sources
    and every other plan field are the same on every shard. The spread
    needs the full band per shard, so 'chan'/'src' axes larger than 1 are
    rejected. `truth` = {"beam_df", "flux_nodes"} selects the truth-amps
    path. `interpret` is checked as in observe.check_kernel_knobs: the
    device of each shard picks the kernel or its plain version.

    Returns ((T, B, C) complex64 on the mesh's first device, ok), ok the
    AND of every shard's unit-source span check (False => the caller must
    fall back)."""
    _check_knobs(mesh, interpret=interpret)
    from ..engine.nufft_banded import (make_banded_plan,
                                       make_banded_snapshot_fns)
    from ..engine.nufft_delay import chebyshev_projection

    axis_sizes = mesh.shape
    n_bl = axis_sizes.get("bl", 1)
    if any(v > 1 for k, v in axis_sizes.items() if k != "bl"):
        raise ValueError("banded sharding supports only the 'bl' mesh "
                         "axis (the spread needs the full band per "
                         "shard); chan and src meshes take the sorted "
                         "spread, simulate_drift_nufft_sharded")

    nchan = instrument.nchan
    # rank approaching nchan makes the Chebyshev basis ill-conditioned;
    # half the channel count is the reference's ceiling
    rank = min(int(rank), max(2, nchan // 2))
    bl64 = tf.join_f64(instrument.bl_hi, instrument.bl_lo)
    B = bl64.shape[0]
    B_pad = -(-B // n_bl) * n_bl
    if B_pad != B:
        # copies of baseline 0 (a zero vector would be rejected by the
        # direction grouping); padded rows are trimmed
        bl64 = np.concatenate(
            [bl64, np.repeat(bl64[:1], B_pad - B, axis=0)], axis=0)
    plan = make_banded_plan(bl64, instrument.nu0, instrument.dnu, nchan,
                            rank=rank, collapse=False, **(plan_kw or {}))
    pinvQ, Q = chebyshev_projection(np.asarray(instrument.freqs), rank)
    pad = B_pad - B

    def padded(t):
        return torch.cat([t, t[:1].expand(pad, 3)]) if pad else t

    nb = B_pad // n_bl
    runs, sched = {}, {}
    for (i, _, _), dev in _shards(mesh, ("bl",)).items():
        rows = slice(i * nb, (i + 1) * nb)
        inst = dataclasses.replace(
            instrument, bl_hi=_on(padded(instrument.bl_hi)[rows], dev),
            bl_lo=_on(padded(instrument.bl_lo)[rows], dev))
        sky_d = dataclasses.replace(
            sky, s_eq_hi=_on(sky.s_eq_hi, dev), s_eq_lo=_on(sky.s_eq_lo, dev),
            flux=_on(sky.flux, dev))
        runs[i] = (dev, make_banded_snapshot_fns(
            inst, sky_d, beam_fn, _shard_plan(plan, rows), pinvQ, Q,
            node_model=node_model, truth=truth))
        if dev not in sched:
            sched[dev] = schedule_tensors(observation, instrument.latitude,
                                          dev)

    first = mesh.first
    T = observation.n_acc
    out = torch.empty((T, B_pad, nchan), dtype=torch.complex64, device=first)
    oks = []
    for t in range(T):
        with tracing.span("snapshot", t=t):
            parts = {i: run(*(a[t] for a in sched[dev]))
                     for i, (dev, run) in runs.items()}
            for i, (v, ok) in parts.items():
                out[t, i * nb:(i + 1) * nb] = v.to(first)
                oks.append(ok.to(first))
    ok = bool(torch.stack(oks).all())
    return out[:, :B, :], ok


def _check_knobs(mesh, use_pallas=None, interpret=False):
    """observe.check_kernel_knobs on every device of `mesh`."""
    for dev in set(mesh.devices.flat):
        check_kernel_knobs(dev, use_pallas, interpret)


def simulate_drift_sharded(instrument, sky, observation, beam_fn, mesh,
                           src_block=512, use_pallas=None,
                           interpret=False):
    """Drift scan sharded over ('bl', 'chan'). Returns (T, B, C) complex64
    on the mesh's first device, padded rows and columns stripped. Each CUDA
    shard runs kernel K1a, each CPU shard its plain version (in blocks of
    `src_block` sources): the device picks, and use_pallas/interpret are
    checked as in observe.check_kernel_knobs."""
    _check_knobs(mesh, use_pallas, interpret)
    return _sharded_drift(mesh, instrument, sky, observation, beam_fn,
                          _nudft_shard(instrument, beam_fn, src_block),
                          src_axis=False)


def simulate_drift_src_sharded(instrument, sky, observation, beam_fn, mesh,
                               src_block=512, use_pallas=None,
                               interpret=False):
    """Drift scan with the *source* axis sharded and the partial
    visibilities summed in shard order on each block's first device: the
    reference's pp.key='src' mode with its rank-0 recv-sum. use_pallas and
    interpret as in simulate_drift_sharded."""
    _check_knobs(mesh, use_pallas, interpret)
    return _sharded_drift(mesh, instrument, sky, observation, beam_fn,
                          _nudft_shard(instrument, beam_fn, src_block),
                          src_axis=True)
