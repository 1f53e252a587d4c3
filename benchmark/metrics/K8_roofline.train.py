"""K8 (InstanceNorm + LeakyReLU) against its roofline, in percent: the least
time of the traced steps' forward InstanceNorm sites (each input read once
and each output written once, bf16, at 3.35 TB/s; the sites of the
reference model, the recompute not counted) over the device time of K8's
kernels in the trace, matched by name."""
from benchmark.harness import kernel_seconds

K8 = ("in_onchip_kernel", "in_stats_kernel", "in_normalize_kernel")


def read(rec):
    if rec.unit != "step" or rec.trace is None:
        return None
    measured = kernel_seconds(rec.trace, K8)
    if measured <= 0:
        return None
    return 100.0 * rec.k8_bound_s_per_unit * rec.trace.units / measured
