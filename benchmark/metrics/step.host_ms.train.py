"""Median host milliseconds of the program's ``step`` span (the train
step's call, entry to return: the host's enqueue of a step) over the
traced steps.

Also the selection that every reader of the program's spans
(``utils/profiling.py::spans``) shares, by loading this file: a span
counts where its host start lies between the end of the warm-up and the
end of the trace (this run's traced passes: it keeps out what an earlier
run in the process left), and of those the first ``trace.units`` units of
each owner (the device-only pass, which runs before the pass that records
host ops)."""
import statistics


def traced_units(rec, name):
    """{owner: [[records of a unit], ...]}: the outermost spans ``name``
    of each owner's first ``rec.trace.units`` units in the traced window,
    in order of start. Empty where the program keeps no spans."""
    if rec.trace is None:
        return {}
    try:
        from hybrid_ctunet_tpu_torch.utils.profiling import spans
    except ImportError:
        return {}
    lo, hi = rec.t0 + rec.phases["warmup"], rec.t0 + rec.phases["trace"]
    owners = {}
    for r in spans():
        if r.name == name and lo <= r.t0_ns * 1e-9 <= hi and not _inside(r, name):
            owners.setdefault(r.owner, {}).setdefault(r.unit, []).append(r)
    return {owner: sorted(units.values(), key=lambda rs: min(r.t0_ns for r in rs))
            [:rec.trace.units] for owner, units in owners.items()}


def _inside(r, name) -> bool:
    p = r.parent
    while p is not None:
        if p.name == name:
            return True
        p = p.parent
    return False


def median_per_unit(rec, name, value):
    """The median over the traced units of ``value(record)`` summed over
    the unit's spans ``name`` and over the owners' i-th units; None where
    there is no such span or a value is None (no CUDA events: the CPU)."""
    owners = traced_units(rec, name)
    sums = []
    for i in range(min((len(units) for units in owners.values()), default=0)):
        values = [value(r) for units in owners.values() for r in units[i]]
        if None in values:
            return None
        sums.append(sum(values))
    return statistics.median(sums) if sums else None


def read(rec):
    if rec.unit != "step":
        return None
    return median_per_unit(rec, "step", lambda r: r.host_ms)
