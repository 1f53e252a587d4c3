"""Milliseconds of device work a traced step: the union of the device's
busy intervals over the traced steps (traced with the device's activity
alone), divided by their count. Steadier than ``step_s``, which the host's
work between launches spreads from run to run."""


def read(rec):
    if rec.unit != "step" or rec.trace is None or rec.trace.busy_s <= 0:
        return None
    return 1e3 * rec.trace.busy_s / rec.trace.units
