"""torch.cuda.max_memory_allocated() over the window (after
reset_peak_memory_stats at its start), in GiB."""


def read(rec):
    return rec.window_peak_bytes / 2 ** 30 if rec.unit == "step" and rec.window_peak_bytes else None
