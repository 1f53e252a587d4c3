"""Whole volumes segmented in the window x 60 / the window's seconds."""


def read(rec):
    return rec.units * 60.0 / rec.window_s if rec.unit == "volume" and rec.window_s else None
