"""Runtime diagnostics: resource monitoring + phase timing.

Counterpart of prisim_tpu/diagnostics.py (the reference's psutil-based
monitor, PRISim's scripts/prisim_resource_monitor.py:11-56, launched by
run_prisim.py:319-322, and its wall-clock tallies, run_prisim.py:
1967-1991). A background thread samples CPU% and RSS (psutil) and, on a
CUDA device, torch.cuda.memory_allocated to a JSONL file; ``phase_timer``
wraps pipeline stages as spans of prisim_tpu_torch.tracing.

psutil is imported when the monitor starts, in the caller's thread, so a
machine without it raises ImportError there, before any compute; an error
inside the sampling thread is raised again by stop()."""

from __future__ import annotations

import contextlib
import json
import threading
import time

import torch

from . import tracing

__all__ = ["ResourceMonitor", "phase_timer"]


class ResourceMonitor:
    """Background sampler writing JSONL rows
    {t, cpu_percent, rss_bytes, device_bytes_in_use}; the last key only
    for a CUDA `device`."""

    def __init__(self, path, interval=1.0, device="cpu"):
        self.path = path
        self.interval = float(interval)
        self.device = torch.device(device)
        self._stop = threading.Event()
        self._thread = None
        self._error = None

    def _device_bytes(self):
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.memory_allocated(self.device))

    def _run(self, proc):
        try:
            with open(self.path, "a") as f:
                while not self._stop.is_set():
                    row = {
                        "t": time.time(),
                        "cpu_percent": proc.cpu_percent(interval=None),
                        "rss_bytes": proc.memory_info().rss,
                    }
                    dev = self._device_bytes()
                    if dev is not None:
                        row["device_bytes_in_use"] = dev
                    f.write(json.dumps(row) + "\n")
                    f.flush()
                    self._stop.wait(self.interval)
        except BaseException as exc:          # re-raised by stop()
            self._error = exc

    def start(self):
        import psutil
        self._thread = threading.Thread(target=self._run,
                                        args=(psutil.Process(),),
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._error is not None:
            raise RuntimeError("resource monitor failed: %r"
                               % (self._error,)) from self._error

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


@contextlib.contextmanager
def phase_timer(name, sink=None, verbose=True):
    """Wall-clock timer for one pipeline phase, the span `name`; appends
    (name, seconds) to `sink` (list or dict) and/or prints."""
    sp = tracing.span(name, timed=True)
    try:
        with sp:
            yield
    finally:
        dt = sp.seconds()
        if isinstance(sink, dict):
            sink[name] = sink.get(name, 0.0) + dt
        elif isinstance(sink, list):
            sink.append((name, dt))
        if verbose:
            print("[prisim_tpu_torch] %-24s %8.3f s" % (name, dt))
