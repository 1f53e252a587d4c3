"""Normalization ops (channels-last). Port of
``hybrid_ctunet_tpu/ops/norm.py``: affine-free InstanceNorm (eps 1e-5) in
every conv path, torch-style LayerNorm (eps 1e-5, affine) in attention paths,
and BatchNorm (``--norm_name batch``, the JAX ``TorchBatchNorm``) in the conv
paths in its place. Statistics are fp32 whatever the activation dtype.

InstanceNorm (+ LeakyReLU) is kernel module K8: ``instance_norm`` and
``instance_norm_leaky`` take the plain version for CPU tensors and launch
``csrc/instance_norm.cu`` for CUDA tensors (the port of
``hybrid_ctunet_tpu/ops/norm_pallas.py``). Both follow the JAX default path
(``ops/norm.py:32-58``), not the Pallas kernel: the variance is clamped at 0
and y is rounded to the activation dtype before the LeakyReLU. The backward
recomputes through the plain version (``norm_pallas.py:98-114``).
``instance_norm_add_leaky`` is a residual block's tail, leaky_relu(norm(a) +
r), in the same kernel's normalize pass (no JAX counterpart: the JAX
package leaves the add and the activation to XLA).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels
from .act import leaky_relu
from .recompute import recompute, recomputing

_THREADS = 256  # csrc/instance_norm.cu: threads per block
_THREADS_48 = 192  # csrc/instance_norm.cu THREADS_48: the two passes' block at C = 48 * 2^k
_SMS = 132  # H100 SXM streaming multiprocessors
SLAB_BYTES = 110_592  # csrc/instance_norm.cu MAX_SLAB: x a CTA holds on chip (two an SM)
GROUP = 64  # csrc/instance_norm.cu CG: channels of an on-chip slab
MAX_CLUSTER = 8  # CTAs of a (portable) thread-block cluster
FOLD_MAX_C = 512  # csrc/instance_norm.cu FOLD_MAX_C: widest C of a folded tail


def reference_instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalize each (batch, channel) of ``x`` (B, X, Y, Z, C) over space.

    Single-pass fp32 statistics E[x^2] - E[x]^2, variance clamped at 0 — the
    JAX package's form, kept so the two agree when |mean| >> std
    (``nn.InstanceNorm3d`` takes another route)."""
    xf = x.float()
    n = x.shape[1] * x.shape[2] * x.shape[3]
    s1 = xf.sum(dim=(1, 2, 3), keepdim=True)
    s2 = xf.square().sum(dim=(1, 2, 3), keepdim=True)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean.square(), min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def pass_threads(channels: int) -> int:
    """The two passes' block at ``channels``: 256 threads where C/8 divides
    256 (C 8..2048 in powers of two; every conv width of the Hybrid-CTUNet
    models, 32-1024), else 192 where C/8 divides 192 (C = 48 * 2^k:
    Swin-UNETR's 48-768), else 0."""
    if channels < 8 or channels % 8:
        return 0
    cv = channels // 8
    return _THREADS if _THREADS % cv == 0 else _THREADS_48 if _THREADS_48 % cv == 0 else 0


def supports(x: torch.Tensor) -> bool:
    """Where the kernel engages: bf16 NDHWC whose C a block of the two
    passes takes (:func:`pass_threads`)."""
    return x.dtype == torch.bfloat16 and x.ndim == 5 and pass_threads(x.shape[-1]) > 0


class Plan(NamedTuple):
    """How ``csrc/instance_norm.cu`` takes a (B, S, C) call. ``onchip``: a
    cluster of ``cluster`` CTAs holds one sample's ``GROUP`` channels, each
    CTA ``rows`` rows of them, in shared memory (one launch, x read once).
    Otherwise ``splits`` statistics blocks per sample, then the normalize
    pass over the same rows (two launches)."""

    onchip: bool
    cluster: int = 0
    rows: int = 0
    splits: int = 0


@functools.lru_cache(maxsize=None)
def plan(batch: int, spatial: int, channels: int) -> Plan:
    """The regime of a call. On chip where one sample's slab of 64 channels
    (each row piece a whole 128-byte line) fits a cluster of at most 8 CTAs
    of ``SLAB_BYTES``: every site of 12x12x24 and below. The cluster then
    takes as many CTAs as give about two an SM over the call, each at least
    32 rows. (Slabs of 16 channels would put 24x24x48 on chip too, but their
    32-byte row pieces ran at half the speed of the two passes on the
    card.) Otherwise the two passes, the statistics pass split in about two
    blocks an SM over the call, each at least four of a block's row steps."""
    need = -(-spatial * GROUP * 2 // SLAB_BYTES)
    if channels % GROUP == 0 and need <= MAX_CLUSTER:
        want = -(-2 * _SMS // (batch * (channels // GROUP)))
        k = max(need, min(MAX_CLUSTER, want, -(-spatial // 32)))
        return Plan(True, cluster=k, rows=-(-spatial // k))
    rows_per_iter = pass_threads(channels) // (channels // 8)
    by_work = max(1, spatial // (4 * rows_per_iter))
    return Plan(False, splits=max(1, min(by_work, -(-2 * _SMS // batch))))


_WORK: Dict[torch.device, torch.Tensor] = {}


def _workspace(device: torch.device, floats: int) -> torch.Tensor:
    """The two-pass form's partial sums: one buffer per device, grown when a
    call needs more (every launch is on the one current stream, which orders
    its reuse)."""
    buf = _WORK.get(device)
    if buf is None or buf.numel() < floats:
        buf = _WORK[device] = torch.empty(floats, dtype=torch.float32, device=device)
    return buf


def _plan_of(x: torch.Tensor):
    if not supports(x) or not x.is_contiguous():
        raise ValueError(f"instance_norm kernel: unsupported {x.dtype} {tuple(x.shape)} "
                         f"(contiguous: {x.is_contiguous()})")
    B, C = x.shape[0], x.shape[-1]
    S = x.shape[1] * x.shape[2] * x.shape[3]
    return B, S, C, plan(B, S, C)


def norm_call(x: torch.Tensor, eps: float = 1e-5, negative_slope=None):
    """K8's C entry bound to its arguments: ``(fn, args, out, plan)``, where
    ``fn(*args)`` normalizes ``x`` (B, X, Y, Z, C), contiguous, into ``out``
    [+ LeakyReLU when ``negative_slope`` is given]."""
    B, S, C, p = _plan_of(x)
    work = 0 if p.onchip else _workspace(x.device, B * p.splits * 2 * C).data_ptr()
    out = torch.empty_like(x)
    act = negative_slope is not None
    args = (x.data_ptr(), out.data_ptr(), work, B, S, C, p.cluster, p.rows, p.splits, eps,
            int(act), float(negative_slope) if act else 0.0, kernels.stream_ptr(x.device))
    return _entry(), args, out, p


def tail_call(a: torch.Tensor, r: torch.Tensor, fold: bool, eps: float = 1e-5,
              negative_slope: float = 0.01):
    """K8's tail entry bound to its arguments: ``(fn, args, out, plan)``,
    where ``fn(*args)`` writes leaky_relu(norm(a) + r) into ``out``, ``r``
    normalized by its own statistics first when ``fold`` (two-pass sites
    only, :func:`folds`; the C entry refuses others). ``a`` and ``r``
    contiguous, of one shape, dtype and device."""
    B, S, C, p = _plan_of(a)
    if r.shape != a.shape or r.dtype != a.dtype or r.device != a.device or not r.is_contiguous():
        raise ValueError(f"instance_norm tail: residual {r.dtype} {tuple(r.shape)} on "
                         f"{r.device} (contiguous: {r.is_contiguous()}) is not a twin of "
                         f"{tuple(a.shape)}")
    floats = (2 if fold else 1) * B * p.splits * 2 * C
    work = 0 if p.onchip else _workspace(a.device, floats).data_ptr()
    out = torch.empty_like(a)
    args = (a.data_ptr(), r.data_ptr(), out.data_ptr(), work, B, S, C, p.cluster, p.rows,
            p.splits, eps, int(fold), float(negative_slope), kernels.stream_ptr(a.device))
    return _tail_entry(), args, out, p


@functools.lru_cache(maxsize=None)
def _entry():
    return kernels.bind(
        "instance_norm", "instance_norm", ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _tail_entry():
    return kernels.bind(
        "instance_norm", "instance_norm_tail", ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def _launch(x: torch.Tensor, eps: float, negative_slope) -> torch.Tensor:
    """K8 on a CUDA tensor, by ``plan``: one launch on chip, or statistics
    then normalize."""
    x = x.contiguous()
    fn, args, out, _ = norm_call(x, eps, negative_slope)
    kernels.check(fn(*args), "instance_norm")
    _count(x.shape[-1])
    return out


def _count(channels: int) -> None:
    instance_norm.launches += 1
    if pass_threads(channels) == _THREADS_48:
        instance_norm.launches_48 += 1


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm of (B, X, Y, Z, C). CPU tensors take the
    plain version; CUDA tensors launch ``csrc/instance_norm.cu``,
    differentiable through the plain version."""
    if not x.is_cuda:
        return reference_instance_norm(x, eps)
    return recompute(lambda x: _launch(x, eps, None), lambda x: reference_instance_norm(x, eps), x)


instance_norm.launches = 0
instance_norm.residual_launches = 0  # fused tails (instance_norm_add_leaky)
instance_norm.launches_48 = 0  # of the launches, those at C = 48 * 2^k (Swin-UNETR's widths)


def instance_norm_leaky(
    x: torch.Tensor, eps: float = 1e-5, negative_slope: float = 0.01
) -> torch.Tensor:
    """InstanceNorm + LeakyReLU, the conv-path epilogue; the same kernel
    (counted on ``instance_norm``) with the activation in its store."""
    def plain(x):
        return leaky_relu(reference_instance_norm(x, eps), negative_slope)

    if not x.is_cuda:
        return plain(x)
    return recompute(lambda x: _launch(x, eps, negative_slope), plain, x)


def tail_supports(a: torch.Tensor, r: torch.Tensor) -> bool:
    """Where the fused tail engages: CUDA tensors, K8's gate takes ``a``, and
    ``r`` has ``a``'s shape, dtype and device, both contiguous."""
    return (a.is_cuda and supports(a) and r.shape == a.shape and r.dtype == a.dtype
            and r.device == a.device and a.is_contiguous() and r.is_contiguous())


def folds(shape) -> bool:
    """Whether a tail of ``shape`` (B, X, Y, Z, C) takes a raw residual into
    K8's passes (normalizing it there): at two-pass sites (24x24x48 and up)
    of at most ``FOLD_MAX_C`` channels. On chip the residual's own norm is a
    launch of its own and the tail adds its result."""
    B, C = shape[0], shape[-1]
    return C <= FOLD_MAX_C and not plan(B, shape[1] * shape[2] * shape[3], C).onchip


class _Tail(torch.autograd.Function):
    """K8's residual tail under autograd. The forward launches the kernel
    and saves ``a`` and ``r``; the backward differentiates the plain
    composition a stage at a time: the LeakyReLU's backward on the sum
    recomputed, then a's norm, then a folded residual's, so that no two
    plain norms' fp32 intermediates are held at once (in one graph, a
    fold's two raised the CTUNet remat train step's peak by ~1.5 GB). The
    gradients are the plain composition's, op for op."""

    @staticmethod
    def forward(ctx, run, fold, eps, slope, a, r):
        ctx.fold, ctx.eps, ctx.slope = fold, eps, slope
        ctx.save_for_backward(a, r)
        return run(a, r)

    @staticmethod
    def backward(ctx, g):
        a, r = ctx.saved_tensors
        need_a, need_r = ctx.needs_input_grad[4:]
        with torch.no_grad():
            res = reference_instance_norm(r, ctx.eps) if ctx.fold else r
        a = a.detach().requires_grad_()
        with torch.enable_grad():
            y = reference_instance_norm(a, ctx.eps)
        g_s = torch.ops.aten.leaky_relu_backward(g, y.detach() + res, ctx.slope, False)
        del res
        g_a = torch.autograd.grad(y, a, g_s)[0] if need_a else None
        del y
        g_r = g_s if need_r else None
        if need_r and ctx.fold:
            r = r.detach().requires_grad_()
            with torch.enable_grad():
                g_r = torch.autograd.grad(reference_instance_norm(r, ctx.eps), r, g_s)[0]
        return None, None, None, None, g_a, g_r


def instance_norm_add_leaky(a: torch.Tensor, r: torch.Tensor, r_raw: bool = False,
                            eps: float = 1e-5, negative_slope: float = 0.01) -> torch.Tensor:
    """A residual block's tail, leaky_relu(instance_norm(a) + r), where ``r``
    is the residual as is or, with ``r_raw``, the raw projection shortcut
    whose InstanceNorm is taken here too. CPU tensors take the plain
    composition; CUDA tensors (:func:`tail_supports`) launch K8's tail
    entry: one normalize pass that adds ``r`` and applies the LeakyReLU,
    bit for bit the unfused K8, add and LeakyReLU. A raw ``r`` is folded
    into the same passes where :func:`folds`, else normalized by K8 first.
    Differentiable through the plain composition (:class:`_Tail`). Counted
    on ``instance_norm.launches`` (one a normalize record) and
    ``instance_norm.residual_launches`` (one a tail)."""
    if not a.is_cuda:
        res = reference_instance_norm(r, eps) if r_raw else r
        return leaky_relu(reference_instance_norm(a, eps) + res, negative_slope)
    fold = r_raw and folds(a.shape)
    if r_raw and not fold:
        r = instance_norm(r, eps)

    def run(a, r):
        fn, args, out, _ = tail_call(a, r, fold, eps, negative_slope)
        kernels.check(fn(*args), "instance_norm_tail")
        _count(a.shape[-1])
        instance_norm.residual_launches += 1
        return out

    if not (torch.is_grad_enabled() and (a.requires_grad or r.requires_grad)):
        return run(a, r)
    return _Tail.apply(run, fold, eps, negative_slope, a, r)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis with elementwise affine, fp32 inside,
    returned in ``x``'s dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def _batch_moments(xf: torch.Tensor, sync: bool):
    """Per-channel mean and biased variance of ``xf`` (..., C) over every
    other axis, and the element count, as device tensors. ``sync``: the sums
    of x and x^2 and the count are summed over the default process group
    first, through the autograd-aware all-reduce, so that the backward sees
    the global batch (SyncBatchNorm)."""
    C = xf.shape[-1]
    flat = xf.reshape(-1, C)
    stats = torch.cat([flat.sum(0), flat.square().sum(0), flat.new_full((1,), flat.shape[0])])
    if sync:
        from torch.distributed.nn.functional import all_reduce

        stats = all_reduce(stats)
    n = stats[2 * C]
    mean = stats[:C] / n
    var = torch.clamp(stats[C:2 * C] / n - mean.square(), min=0.0)
    return mean, var, n


def _batch_normalize(xf, mean, var, weight, bias, eps):
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y * weight.float() + bias.float()


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *, training: bool,
               momentum: float = 0.1, eps: float = 1e-5, sync: bool = False) -> torch.Tensor:
    """BatchNorm over the channels-last ``x`` (B, X, Y, Z, C) with torch's
    semantics (the JAX ``TorchBatchNorm``, ``ops/norm.py:142-200``): in
    training the biased batch variance E[x^2] - E[x]^2 (fp32, clamped at 0)
    normalizes, and the running buffers take the batch mean and the
    unbiased variance (Bessel's factor over the global count) with
    ``momentum``, in place; in eval the running buffers normalize. Returns
    ``x``'s dtype. Plain PyTorch: the JAX package has no BatchNorm kernel.
    The training path keeps only ``x`` for the backward, which recomputes
    the statistics (and their all-reduce under ``sync``). A rematerialized
    block's recompute (``recomputing()``) leaves the buffers as its forward
    set them."""
    if not training:
        return _batch_normalize(x.float(), running_mean, running_var, weight, bias,
                                eps).to(x.dtype)

    def plain(x, weight, bias):
        xf = x.float()
        mean, var, _ = _batch_moments(xf, sync)
        return _batch_normalize(xf, mean, var, weight, bias, eps).to(x.dtype)

    def run(x, weight, bias):
        xf = x.float()
        mean, var, n = _batch_moments(xf, sync)
        if not recomputing():
            with torch.no_grad():
                running_mean.mul_(1.0 - momentum).add_(momentum * mean)
                running_var.mul_(1.0 - momentum).add_(momentum * var * (n / (n - 1.0)))
        return _batch_normalize(xf, mean, var, weight, bias, eps).to(x.dtype)

    return recompute(run, plain, x, weight, bias)
