"""Structured metrics logging, tracing and profiler traces.

The port's own copy of `ipercore_tpu/utils/logging.py`: the same JSONL file
and the same echoed `[metrics]` line; `profile_trace` records a
`torch.profiler` trace (Chrome trace JSON) where the JAX package records a
`jax.profiler` one.

Tracing. `span(name, **attrs)` marks a layer's work as a context manager.
Spans record while `torch.profiler` records (a `profile` block, or between
its `start()` and `stop()`), and only then: elsewhere `span()` returns one
shared no-op after reading one module global. A span records its name,
start and end on the profiler's clock (`time.time_ns`, the clock of the
profiler's events), its parent (the span open on the same thread when it
began), a request id (the id of its top-level span), its thread and its
attributes. Spans are kept in memory, at most `MAX_SPANS` of them, and
`take_spans()` hands them out and empties the store; `profile_trace` writes
them into its Chrome trace beside the kernels.

    with span("stream.enqueue", chunk=3):
        ...

An attribute known only at the end is added with the span's `set`:

    with span("pose2d.decode", frames=n) as s:
        ...
        s.set(peaks=peaks)

Counters. `count(name, n)` adds to one registry of integers, always on;
`counts()` reads it and `reset_counts(names)` sets entries back to 0.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple, Optional

from torch.autograd import profiler as _torch_profiler

MAX_SPANS = 1 << 16


class MetricsLogger:
    """Append-only JSONL metrics log (+ mirrored stdout line)."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, **metrics) -> None:
        rec = {"t": time.time(), **metrics}
        line = json.dumps(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            printable = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items())
            print(f"[metrics] {printable}", flush=True)


class Span(NamedTuple):
    """One closed span. Times are `time.time_ns()`; `parent` is None for a
    top-level span, whose `id` is the `request` of every span under it;
    `thread` is the thread's native id, as the profiler's events give it."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: int
    thread: int
    attrs: dict


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        """Nothing to record."""


_NO_SPAN = _NoSpan()
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_open = threading.local()  # .stack: the spans open on this thread, innermost last; .tid
_ids = itertools.count(1)


class _OpenSpan:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
            _open.tid = threading.get_native_id()  # a system call: once a thread
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else None
        self.request = outer.request if outer is not None else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.stack.pop()
        _spans.append(Span(self.name, self.start_ns, end, self.id, self.parent, self.request,
                           _open.tid, self.attrs))
        return False

    def set(self, **attrs):
        """Add attributes known only once the work is done."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A span around a layer's work while `torch.profiler` records; the
    shared no-op otherwise."""
    if not _torch_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _OpenSpan(name, attrs)


def take_spans() -> list:
    """The closed spans recorded so far (`Span`s, in the order they closed),
    and an empty store."""
    out = []
    while _spans:
        out.append(_spans.popleft())
    return out


_counts: dict = {}
_counts_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    """A copy of every counter."""
    with _counts_lock:
        return dict(_counts)


def reset_counts(names) -> None:
    """Set the named counters to 0."""
    with _counts_lock:
        for name in names:
            _counts[name] = 0


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Record a torch.profiler trace (host and, where there is one, CUDA
    activity) around a block into `<log_dir>/trace.json` (open it in Perfetto
    or chrome://tracing), with the port's spans of the block on a track of
    their own beside the kernels. Usage:
    `with profile_trace('/tmp/trace'): run_step()`."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    _add_spans_to_chrome_trace(path, [s for s in take_spans() if s.start_ns >= t0])


def _add_spans_to_chrome_trace(path: str, spans: list) -> None:
    """Append spans as complete events ("ph": "X") of the process, one track
    a thread, in the trace's microseconds since its `baseTimeNanoseconds`."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    for s in spans:
        trace["traceEvents"].append({
            "ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": f"spans {s.thread}",
            "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"id": s.id, "parent": s.parent, "request": s.request, **s.attrs}})
    with open(path, "w") as f:
        json.dump(trace, f)
