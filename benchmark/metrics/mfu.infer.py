"""Useful FLOPs of the window's volumes (the reference models' count) over
the window's seconds x the H100's dense bf16 peak, in percent."""
from benchmark.reference.cost import PEAK_BF16_FLOP_PER_S


def read(rec):
    if rec.unit != "volume" or not rec.units:
        return None
    return 100.0 * rec.flops_per_unit * rec.units / (rec.window_s * PEAK_BF16_FLOP_PER_S)
