"""Milliseconds of device work a traced volume: the union of the device's
busy intervals over the traced volumes (traced with the device's activity
alone), divided by their count."""


def read(rec):
    if rec.unit != "volume" or rec.trace is None or rec.trace.busy_s <= 0:
        return None
    return 1e3 * rec.trace.busy_s / rec.trace.units
