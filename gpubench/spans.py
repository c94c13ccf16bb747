"""The program's spans and counters in a `--trace 1` run, for the
per-layer metrics that read them.

prisim_tpu_torch.tracing records while torch.profiler runs, so a traced
run holds the spans of the window's first simulation, the one the harness
profiles: its root "simulation" with the phases, snapshots and kernels
under it, the counters added in each (src.processed, src.live, k2.tiles,
k2.items_live, driver.demotions) and, on a card, each span's stream
milliseconds (`device_ms`). `of(info)` takes them from the recorder the
first time a metric asks and keeps them on `info`; it is None where the
program has no recorder (a checkout older than it) or recorded no
simulation, and every metric then reads nothing.
"""


class Trace:
    """The records of one simulation, with their tree."""

    def __init__(self, records):
        self.records = records
        self.kids = {}
        for r in records:
            self.kids.setdefault(r["parent"], []).append(r)

    def named(self, name):
        return [r for r in self.records if r["name"] == name]

    def below(self, rec, name=None):
        """The spans under `rec` (named `name`, where given)."""
        out, todo = [], list(self.kids.get(rec["id"], ()))
        while todo:
            r = todo.pop()
            todo.extend(self.kids.get(r["id"], ()))
            if name is None or r["name"] == name:
                out.append(r)
        return out

    def total(self, rec, counter):
        """The counter summed over `rec` and the spans under it."""
        return sum(r["counts"].get(counter, 0)
                   for r in [rec] + self.below(rec))

    def snapshots(self):
        return self.named("snapshot")


def seconds(rec):
    return (rec["end_ns"] - rec["start_ns"]) / 1e9


def span_seconds(info, name):
    """The seconds of the spans `name` of the profiled simulation, summed;
    None where it has none."""
    tr = of(info)
    got = tr.named(name) if tr is not None else []
    return sum(seconds(r) for r in got) if got else None


def _take():
    try:
        from prisim_tpu_torch import tracing
    except ImportError:
        return None
    records = tracing.take()
    roots = [r for r in records if r["parent"] is None
             and r["name"] == "simulation"]
    if not roots:
        return None
    trace = roots[-1]["trace"]
    return Trace([r for r in records if r["trace"] == trace])


def of(info):
    """The profiled simulation's Trace, or None."""
    if not hasattr(info, "_prisim_trace"):
        info._prisim_trace = _take()
    return info._prisim_trace
