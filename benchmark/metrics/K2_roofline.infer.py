"""K2 (window attention) against its roofline, in percent: the least time of
the traced volumes' window attentions (per window and head the larger of
4 T^2 dh FLOPs at the bf16 peak and q, k, v read and the output written
once in bf16 at 3.35 TB/s; the sites of the reference model,
``k2_bound_s_per_unit`` of ``drivers/single.py``) over the device time of
K2's kernels in the trace, matched by name. None where the run gives no
bound or the trace holds no K2 kernel."""
from benchmark.harness import kernel_seconds

K2 = ("window_attention_kernel",)


def read(rec):
    bound = getattr(rec, "k2_bound_s_per_unit", 0.0)
    if rec.unit != "volume" or rec.trace is None or not bound:
        return None
    measured = kernel_seconds(rec.trace, K2)
    if measured <= 0:
        return None
    return 100.0 * bound * rec.trace.units / measured
