"""Process start to the first timed unit: imports, kernel libraries, weights,
data, warm-up."""


def read(rec):
    return rec.setup_s
