"""The window's seconds / the train steps completed in it (loading included)."""


def read(rec):
    return rec.window_s / rec.units if rec.unit == "step" and rec.units else None
