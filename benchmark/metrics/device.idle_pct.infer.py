"""Share of the traced volumes' wall in which no operation ran on the
device, in percent (1 - the union of device intervals / the traced wall),
traced with the device's activity alone."""


def read(rec):
    if rec.unit != "volume" or rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
