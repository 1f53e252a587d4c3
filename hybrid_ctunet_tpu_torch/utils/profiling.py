"""Tracing and timing: the port of ``hybrid_ctunet_tpu/utils/profiling.py``.

- ``trace(logdir, device)`` — context manager around ``torch.profiler``
                              writing a TensorBoard-loadable trace.
- ``enable_nan_checks``     — debug mode that raises at the first module
                              whose output holds a NaN or an infinity, and
                              at the first backward function that makes one
                              (the counterpart of ``jax_debug_nans``).
- ``StepTimer``             — host-clock step timing fenced on the result;
                              items/s and items/min.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

_NAN_HOOKS = []  # the global forward hooks while NaN checks are on
_RUNNING = []  # modules whose forward is running, outermost first


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, device=None):
    """Trace the enclosed work with ``torch.profiler``; yields the profiler.
    CUDA activity is recorded on a card (the default device), host activity
    only when the caller passes the CPU. The card is synchronised before the
    trace stops, so every kernel it ran is in it. With ``logdir`` the trace
    is written there for TensorBoard's profile plugin."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    device = torch.device("cuda" if device is None else device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: no CUDA device (pass device='cpu' to trace the host)")
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(logdir) if logdir else None
    with profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _enter(module, args):
    _RUNNING.append(module)


def _check_finite(module, inputs, output):
    _RUNNING.pop()
    for t in _tensors(output):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            root = _RUNNING[0] if _RUNNING else module
            path = next((n for n, m in root.named_modules() if m is module), "")
            _RUNNING.clear()
            raise FloatingPointError(
                f"non-finite output of module {type(root).__name__}{'.' + path if path else ''} "
                f"({type(module).__name__}, shape {tuple(t.shape)}, {t.dtype})")


def enable_nan_checks(enabled: bool = True) -> None:
    """Debug mode: global forward hooks raise ``FloatingPointError`` naming
    the first module whose tensor output is not finite, by its path in the
    outermost running module (they synchronise with the card at every
    module), and autograd's anomaly mode raises at the first backward
    function that returns a NaN. ``False`` removes both."""
    while _NAN_HOOKS:
        _NAN_HOOKS.pop().remove()
    _RUNNING.clear()
    if enabled:
        _NAN_HOOKS.append(torch.nn.modules.module.register_module_forward_pre_hook(_enter))
        _NAN_HOOKS.append(torch.nn.modules.module.register_module_forward_hook(_check_finite))
    torch.autograd.set_detect_anomaly(enabled, check_nan=True)


def _tensors(result):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (tuple, list)):
        for r in result:
            yield from _tensors(r)
    elif isinstance(result, dict):
        for r in result.values():
            yield from _tensors(r)


class StepTimer:
    """Throughput meter. ``tic()`` before the step, ``toc(result, n_items)``
    after; ``toc`` synchronises every card that holds a tensor of ``result``
    (a tensor, or a tuple, list or dict of them), so the device time is
    fully counted."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.times = []
        self.items = []
        self._t0: Optional[float] = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self, result=None, n_items: int = 1) -> float:
        for device in {t.device for t in _tensors(result) if t.is_cuda}:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self.items.append(n_items)
        return dt

    @property
    def mean_s(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def items_per_s(self, *, skip_first: int = 1) -> float:
        """Throughput excluding warm-up steps."""
        ts = self.times[skip_first:] or self.times
        ns = self.items[skip_first:] or self.items
        total_t = sum(ts)
        return sum(ns) / total_t if total_t > 0 else 0.0

    def per_min(self, **kw) -> float:
        return 60.0 * self.items_per_s(**kw)
