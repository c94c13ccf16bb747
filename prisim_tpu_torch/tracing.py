"""Spans and counters of a run: one recorder, off by default.

A span is a named interval of the program, opened where the work is:

    with tracing.span("snapshot", t=3):
        ...

The recorder is on while `enable()` holds or a torch profiler runs
(diagnosis.jax_profile turns both on for its run). It then keeps each
span as a dict: `name`, `id`, `parent` (the id of the innermost open span
it was opened in, None for a root), `trace` (shared by every span under
one root: one run_simulation call), `start_ns` and `end_ns` on the Unix
clock (time.time_ns, the clock on which torch.profiler's
`kineto_results.trace_start_ns()` counts), `attrs` (a few attributes:
engine, accumulation, chunk, sizes), `counts` (the counters added while
it was the innermost span), `launches` (the deltas of the kernels' launch
counters over it, where nonzero), `error` (the type of an exception that
left it) and, under a root whose `device` attribute names a CUDA device,
`device_ms`: the milliseconds of that device's current stream from the
span's opening to its closing (CUDA events), which is the work the span
launched and any idle between. While a profiler runs, each span also
opens record_function("prisim/<name>"), so that the profile shows it and
ties each kernel to the span that launched it.

When the recorder is off, `span` returns one shared no-op context after a
flag check: nothing is kept, no record_function opens, nothing is put on
the device. A span given `line` (one of the driver's phase lines) or
`timed` is timed all the same; one with `line` prints
"[prisim_tpu_torch] ... <line> (<seconds> s)" when it closes without an
exception.

Counters: `count(name, n)` adds a host int; `count_device(name, t)` keeps a
0-d integer tensor, which is summed and read back once, when the root span
closes (by then the run's results have come back to the host), and then
released. `take()` returns the records of the traces closed since the
last take, root by root, and forgets them; meanwhile at most the last
MAX_TRACES closed traces are kept. Spans belong to the thread that runs
the simulation.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import time
import uuid

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "count", "count_device", "current", "take", "enable",
           "disable", "recording", "on", "register_launches",
           "kernel_ms_by_span", "MAX_TRACES"]

MAX_TRACES = 4

_state = {"on": False}
_stack = []                       # open spans, innermost last
_done = collections.deque(maxlen=MAX_TRACES)
_launch_counters = {}             # name -> () -> int
_ids = itertools.count(1)


def enable():
    _state["on"] = True


def disable():
    _state["on"] = False


def recording():
    """Whether spans opened now are kept."""
    return _state["on"] or _profiler._is_profiler_enabled


@contextlib.contextmanager
def on():
    """The recorder on for the block, as it was after it."""
    was = _state["on"]
    _state["on"] = True
    try:
        yield
    finally:
        _state["on"] = was


def register_launches(name, read):
    """A launch counter that each kept span reads the delta of: `read()`
    returns the launches so far."""
    _launch_counters[name] = read


class _Noop:
    """The span of an off recorder."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def seconds(self):
        return 0.0


_NOOP = _Noop()


class _Trace:
    def __init__(self, device):
        self.id = uuid.uuid4().hex[:16]
        self.records = []
        self.pending = []         # (record, counter name, 0-d tensor)
        self.timed = []           # (record, start event, end event)
        self.stream = None
        if device is not None and torch.device(device).type == "cuda":
            self.stream = torch.cuda.current_stream(torch.device(device))


class _Span:
    __slots__ = ("name", "line", "attrs", "t0", "t1", "rec", "trace",
                 "_fn", "_ev", "_launch0")

    def __init__(self, name, line, attrs):
        self.name, self.line, self.attrs = name, line, attrs
        self.t1 = None
        self.rec = self.trace = self._fn = self._ev = self._launch0 = None

    def __enter__(self):
        parent = _stack[-1] if _stack else None
        if recording():
            root = parent is None or parent.trace is None
            self.trace = (_Trace(self.attrs.get("device")) if root
                          else parent.trace)
            self.rec = dict(name=self.name, id=next(_ids),
                            parent=None if root else parent.rec["id"],
                            trace=self.trace.id, start_ns=0, end_ns=0,
                            attrs=self.attrs, counts={}, launches={})
            self.trace.records.append(self.rec)
            self._launch0 = {k: f() for k, f in _launch_counters.items()}
            if _profiler._is_profiler_enabled:
                self._fn = _profiler.record_function("prisim/" + self.name)
                self._fn.__enter__()
            if self.trace.stream is not None:
                self._ev = torch.cuda.Event(enable_timing=True)
                self._ev.record(self.trace.stream)
        _stack.append(self)
        self.t0 = time.time_ns()
        if self.rec is not None:
            self.rec["start_ns"] = self.t0
        return self

    def __exit__(self, kind, exc, tb):
        self.t1 = time.time_ns()
        _stack.pop()
        rec = self.rec
        if rec is not None:
            rec["end_ns"] = self.t1
            if kind is not None:
                rec["error"] = kind.__name__
            for k, f in _launch_counters.items():
                n = f() - self._launch0.get(k, 0)
                if n:
                    rec["launches"][k] = n
            if self._ev is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(self.trace.stream)
                self.trace.timed.append((rec, self._ev, end))
            if self._fn is not None:
                self._fn.__exit__(None, None, None)
            if rec["parent"] is None:
                _close(self.trace)
        if self.line and kind is None:
            print("[prisim_tpu_torch] ... %s (%.2f s)"
                  % (self.line, self.seconds()))
        return False

    def set(self, **attrs):
        """Add attributes to the span."""
        self.attrs.update(attrs)

    def seconds(self):
        """Seconds from the opening to the closing (to now while open)."""
        return ((self.t1 if self.t1 is not None else time.time_ns())
                - self.t0) / 1e9


def _close(trace):
    """Resolve a closed root's device counters and stream times, and keep
    its records."""
    groups = {}
    for rec, name, t in trace.pending:
        groups.setdefault((t.device, t.dtype), []).append((rec, name, t))
    for items in groups.values():
        vals = torch.stack([t for _, _, t in items]).tolist()
        for (rec, name, _), v in zip(items, vals):
            rec["counts"][name] = rec["counts"].get(name, 0) + int(v)
    if trace.timed:
        trace.timed[-1][2].synchronize()      # the root's end, recorded last
        for rec, a, b in trace.timed:
            rec["device_ms"] = a.elapsed_time(b)
    trace.pending = trace.timed = None
    _done.append(trace.records)


def span(name, line=None, timed=False, **attrs):
    """A span of the program (see the module's docstring): a context
    manager whose `set(**attrs)` adds attributes and `seconds()` reads its
    time. `line`, when true, is the phase line it prints as it closes;
    `timed` times it when the recorder is off."""
    if not (_state["on"] or _profiler._is_profiler_enabled or line
            or timed):
        return _NOOP
    return _Span(name, line, attrs)


def current(name=None):
    """The innermost open span (named `name`, where given), or a no-op."""
    for s in reversed(_stack):
        if name is None or s.name == name:
            return s
    return _NOOP


def count(name, n):
    """Add the host int `n` to the counter `name` of the innermost span."""
    if _stack and _stack[-1].rec is not None:
        counts = _stack[-1].rec["counts"]
        counts[name] = counts.get(name, 0) + int(n)


def count_device(name, t):
    """Add the 0-d integer tensor `t` (on any device) to the counter `name`
    of the innermost span, without reading it now."""
    if _stack and _stack[-1].rec is not None:
        s = _stack[-1]
        s.trace.pending.append((s.rec, name, t.reshape(())))


def take():
    """The records of the traces closed since the last take (a list of
    dicts, trace by trace, each in opening order); forgets them."""
    out = [rec for records in _done for rec in records]
    _done.clear()
    return out


def kernel_ms_by_span(prof, records):
    """Device milliseconds of the kernels, copies and sets each span
    launched, from a finished torch.profiler `prof` and the spans'
    `records`: each device activity is tied by its correlation id to the
    runtime call that launched it, and counted in the innermost span open
    on the host at that call and in each of that span's parents. Returns
    {span id: ms}."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    launch_ns = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() == DeviceType.CPU
                 and e.name().startswith("cu")}
    recs = sorted(records, key=lambda r: r["start_ns"])
    starts = [r["start_ns"] for r in recs]
    by_id = {r["id"]: r for r in recs}
    out = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        t = launch_ns.get(e.correlation_id())
        j = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        rec = recs[j] if j >= 0 else None
        while rec is not None and rec["end_ns"] < t:
            rec = by_id.get(rec["parent"])
        while rec is not None:
            out[rec["id"]] = out.get(rec["id"], 0.0) + e.duration_ns() / 1e6
            rec = by_id.get(rec["parent"])
    return out
