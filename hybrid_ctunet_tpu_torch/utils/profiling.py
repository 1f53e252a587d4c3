"""Tracing and timing: the port of ``hybrid_ctunet_tpu/utils/profiling.py``.

- ``trace(logdir, device)`` — context manager around ``torch.profiler``
                              writing a TensorBoard-loadable trace.
- ``enable_nan_checks``     — debug mode that raises at the first module
                              whose output holds a NaN or an infinity, and
                              at the first backward function that makes one
                              (the counterpart of ``jax_debug_nans``).
- ``StepTimer``             — host-clock step timing fenced on the result;
                              items/s and items/min.
- ``span(name)``            — a named span of the program's work while a
                              ``torch.profiler`` profile is active (nothing
                              otherwise): a ``record_function`` range in the
                              trace, and a record in a bounded store that
                              ``spans()`` returns, host and device times
                              resolved.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

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


SPAN_CAPACITY = 65536  # records kept; the oldest go first
# host stamps (``time.perf_counter_ns``) to the profiler's Unix-ns clock
_PROFILER_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
_STORE: Deque["SpanRecord"] = collections.deque(maxlen=SPAN_CAPACITY)
_OPEN: Dict[str, "SpanRecord"] = {}  # the newest open span of each name, on any thread
_THREAD = threading.local()  # .stack: the open spans of this thread, outermost first
_OWNERS = itertools.count()


@dataclass(eq=False)
class SpanRecord:
    """One closed span. ``unit``: the step, call or batch it belongs to;
    ``owner``: the serial of the object that counts the units
    (:func:`new_owner`); ``parent``: the enclosing span's record. Host times
    are ``time.perf_counter_ns()``; ``device_ms`` is the time between the
    span's two CUDA events on its stream, None without them, resolved when
    :func:`spans` reads the record."""
    name: str
    unit: Optional[int]
    owner: Optional[int]
    parent: Optional["SpanRecord"]
    t0_ns: int
    t1_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[tuple] = None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6


class _Off:
    """The span while no profiler runs: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "rf", "within", "cuda", "shadowed")

    def __init__(self, name, unit, owner, within, cuda):
        self.rec = SpanRecord(name, unit, owner, None, 0)
        self.within, self.cuda = within, cuda

    def __enter__(self):
        rec = self.rec
        stack = getattr(_THREAD, "stack", None)
        if stack is None:
            stack = _THREAD.stack = []
        parent = stack[-1] if stack else _OPEN.get(self.within) if self.within else None
        if parent is not None:
            rec.parent = parent
            rec.unit = parent.unit if rec.unit is None else rec.unit
            rec.owner = parent.owner if rec.owner is None else rec.owner
        self.shadowed = _OPEN.get(rec.name)
        _OPEN[rec.name] = rec
        stack.append(rec)
        self.rf = torch.profiler.record_function(rec.name)
        self.rf.__enter__()
        if self.cuda and torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        rec.t0_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        self.rf.__exit__(*exc)
        _THREAD.stack.pop()
        if self.shadowed is None:
            _OPEN.pop(rec.name, None)
        else:
            _OPEN[rec.name] = self.shadowed
        _STORE.append(rec)
        return False


def span(name: str, unit: Optional[int] = None, owner: Optional[int] = None, *,
         within: Optional[str] = None, cuda: bool = True):
    """A context that spans the program's work ``name`` while a
    ``torch.profiler`` profile is active; otherwise a shared no-op (one flag
    read). On, it enters ``torch.profiler.record_function(name)`` and keeps
    a :class:`SpanRecord` in the store. ``unit`` and ``owner`` default to
    the parent's: the enclosing span on this thread or, where there is none,
    the open span named ``within`` on any thread (a recompute on autograd's
    thread names the backward that runs it). ``cuda``: on a CUDA process,
    two timing events on the current stream time the span on the device;
    False for host work off the device's queue."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, unit, owner, within, cuda)


def new_owner() -> int:
    """A fresh serial for an object that numbers its spans' units."""
    return next(_OWNERS)


def spans() -> List[SpanRecord]:
    """The stored records in the order they closed, each one's device time
    resolved (waiting for its end event)."""
    out = list(_STORE)
    for rec in out:
        events = rec.events
        if events is not None:
            events[1].synchronize()
            rec.device_ms, rec.events = events[0].elapsed_time(events[1]), None
    return out


def to_profiler_ns(t_ns: int) -> int:
    """A host stamp (``time.perf_counter_ns``) on the profiler's clock: Unix
    ns, as ``kineto_results.trace_start_ns()`` plus an event's offset."""
    return t_ns + _PROFILER_OFFSET_NS
