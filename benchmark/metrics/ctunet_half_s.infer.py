"""Mean host seconds of the CTUNet half of a volume (its engine's call, fenced
on its map), over the window's volumes."""
import statistics


def read(rec):
    times = rec.spans.get("ctunet_half")
    return statistics.fmean(times) if times else None
