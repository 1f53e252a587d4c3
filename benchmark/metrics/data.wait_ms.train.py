"""Mean host milliseconds a step waits in the train loader's ``next()``."""
import statistics


def read(rec):
    times = rec.spans.get("data_wait")
    return 1e3 * statistics.fmean(times) if times else None
