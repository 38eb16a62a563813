"""Tracing (counterpart of blazeseq_tpu/tracing.py).

`Tracer` holds named host wall-clock sections (they nest) and counters,
with a report() summary; `global_tracer()` is the process-wide one, the
program's tracer.

The program marks its layers with `span(name)` and counts with
`count(name, n)`. Both record into `global_tracer()` only while tracing is
on: while a torch.profiler is recording, or inside a `capture()` block.
Off, `span()` returns one shared no-op context manager and `count()`
returns at once: no clock is read and nothing is recorded. On, each span
is also a record-function range of the profiler when one records (the
C++ form of `torch.profiler.record_function`, `cpu_op` events named
`bs.*`), so it sits in the device trace on the profiler's own clock
beside the kernels and copies; and it is kept in memory with its name,
its `perf_counter_ns` start and end, its parent span and its request. A
request is a `bs.run_file_device` or `bs.run_file` span opened outside any
other request; its children, and the counters counted under it, carry its
id (`request_count` reads one of them while it is open). Parents are per
thread: a span opened in another thread never nests into this thread's.
`Tracer.requests(last=k)` reads the last k requests by span name (total
time, self time and calls) with their counters and the spans' own
bookkeeping time, which no self time holds.

`device_trace(dir)` captures a torch.profiler trace of the enclosed block
(CPU activity, and CUDA kernels and copies when a card is present) and
writes it into `dir` as a Chrome trace, `trace.json`, which chrome://tracing
or Perfetto opens.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

import torch

__all__ = ["Span", "Tracer", "capture", "count", "device_trace",
           "global_tracer", "request_count", "span"]

# a span of one of these names opens a request, unless inside one
REQUEST_SPANS = ("bs.run_file_device", "bs.run_file")
# the counter of spans left out of Tracer.spans past its bound
DROPPED = "tracing.dropped"
# the requests a tracer keeps, the last ones
KEPT_REQUESTS = 256
# the spans a tracer keeps in `spans`, the first ones
MAX_SPANS = 1 << 17

_profiler_enabled = torch._C._autograd._profiler_enabled
# a profiler range opened and closed in C++: no Python frame of its own
# lands in a profile taken with stacks
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.autograd.profiler.record_function)
_now = time.perf_counter_ns


class Span(NamedTuple):
    """One closed span: ids are given in opening order; `parent` is the id
    of the span open on the same thread when it opened (None at the top),
    `request` the id of its request (None outside one)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: Optional[int]


class _Request:
    __slots__ = ("id", "name", "totals", "counters", "overhead_ns")

    def __init__(self, rid: int, name: str):
        self.id, self.name = rid, name
        self.totals: Dict[str, list] = {}  # name -> [total_ns, self_ns, calls]
        self.counters: Dict[str, int] = defaultdict(int)
        self.overhead_ns = 0  # what its spans' own bookkeeping took


class _Open:
    """A span being timed: a context manager that records itself into its
    tracer when it closes. Its own bookkeeping, from the first clock read
    of __enter__ to the last of __exit__ less the span itself, is measured
    and kept out of its parent's self time."""

    __slots__ = ("tracer", "name", "id", "parent", "request", "t0",
                 "child_ns", "range", "cost")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        t_in = _now()
        tr = self.tracer
        try:
            stack = tr._local.stack
        except AttributeError:
            stack = tr._local.stack = []
        self.id = next(tr._ids)
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        self.request = None if top is None else top.request
        if self.request is None and self.name in REQUEST_SPANS:
            self.request = _Request(self.id, self.name)
        self.child_ns = 0
        self.range = None
        if _profiler_enabled():
            self.range = _record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        self.t0 = _now()
        self.cost = self.t0 - t_in
        return tr

    def __exit__(self, *exc):
        t1 = _now()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        tr, name, req = self.tracer, self.name, self.request
        stack = tr._local.stack
        stack.pop()
        d = t1 - self.t0
        self_ns = d - self.child_ns
        kept = False
        with tr._lock:
            tr.times[name] += d * 1e-9
            tr.self_times[name] += self_ns * 1e-9
            tr.calls[name] += 1
            if req is not None:
                tot = req.totals.get(name)
                if tot is None:
                    req.totals[name] = [d, self_ns, 1]
                else:
                    tot[0] += d
                    tot[1] += self_ns
                    tot[2] += 1
                if req.id == self.id:
                    tr._requests.append(req)
            if len(tr._spans) < MAX_SPANS:
                tr._spans.append((self.id, name, self.t0, t1, self.parent,
                                  None if req is None else req.id))
                kept = True
        if not kept:
            tr.count(DROPPED)
        cost = self.cost + _now() - t1
        if stack:
            stack[-1].child_ns += d + cost
            if req is not None:
                req.overhead_ns += cost
        return False


class Tracer:
    """Named sections or spans (they nest, per thread) and counters. Every
    span is kept in `spans` up to MAX_SPANS; past that it is dropped and
    counted under `tracing.dropped`, and the totals by name (`times`,
    `self_times`, `calls`, and each request's) still count it. The last
    KEPT_REQUESTS requests are kept."""

    def __init__(self):
        self.times: Dict[str, float] = defaultdict(float)
        self.self_times: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self._spans: list = []  # Span fields as plain tuples
        self._requests: deque = deque(maxlen=KEPT_REQUESTS)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    @property
    def spans(self) -> List[Span]:
        """The kept spans, in closing order."""
        return [Span(*s) for s in self._spans]

    def section(self, name: str) -> _Open:
        """Time the enclosed block as `name`, whether tracing is on or not
        (the module's `span` records only while it is on)."""
        return _Open(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name`, and to the request open on this
        thread, if any."""
        stack = getattr(self._local, "stack", None)
        with self._lock:
            self.counters[name] += n
            if stack and stack[-1].request is not None:
                stack[-1].request.counters[name] += n

    def requests(self, last: Optional[int] = None) -> List[dict]:
        """The last `last` closed requests (all that are kept for None),
        oldest first: each {"id", "name", "spans": {span name: {"total_s",
        "self_s", "calls"}}, "counters": {name: n}, "overhead_s"}. Self
        time is a span's time less what its child spans on the same thread
        cover, their own bookkeeping included; `overhead_s` is that
        bookkeeping over the request's spans, the request's own left
        out."""
        with self._lock:
            reqs = list(self._requests)
        if last is not None:
            reqs = reqs[len(reqs) - min(int(last), len(reqs)):]
        return [dict(id=r.id, name=r.name,
                     spans={k: dict(total_s=v[0] * 1e-9, self_s=v[1] * 1e-9,
                                    calls=v[2])
                            for k, v in r.totals.items()},
                     counters=dict(r.counters),
                     overhead_s=r.overhead_ns * 1e-9) for r in reqs]

    def reset(self) -> None:
        """Forget every time, counter, span and request."""
        with self._lock:
            for d in (self.times, self.self_times, self.calls,
                      self.counters):
                d.clear()
            self._spans.clear()
            self._requests.clear()

    def report(self) -> str:
        """One line a name: total seconds, self seconds, share of the
        summed totals and calls, by total; then the counters."""
        lines = ["== trace report =="]
        total = sum(self.times.values())
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            lines.append("%-28s %8.3fs %8.3fs %5.1f%% (%d calls)"
                         % (name, t, self.self_times[name],
                            100 * t / total if total else 0,
                            self.calls[name]))
        for name, v in sorted(self.counters.items()):
            lines.append("%-28s %d" % (name, v))
        return "\n".join(lines)


class _NoSpan:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_GLOBAL = Tracer()
_capturing = 0  # open capture() blocks
_capture_lock = threading.Lock()


def global_tracer() -> Tracer:
    return _GLOBAL


def span(name: str):
    """A span of the program's tracer around the enclosed block while
    tracing is on; the shared no-op context manager while it is off."""
    if _capturing or _profiler_enabled():
        return _Open(_GLOBAL, name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add `n` to the program tracer's counter `name` while tracing is
    on."""
    if _capturing or _profiler_enabled():
        _GLOBAL.count(name, n)


def request_count(name: str) -> int:
    """Counter `name` of the request open on this thread, so far: 0 while
    tracing is off and outside a request."""
    stack = getattr(_GLOBAL._local, "stack", None)
    if not stack or stack[-1].request is None:
        return 0
    return stack[-1].request.counters.get(name, 0)


@contextlib.contextmanager
def capture():
    """Turn tracing on for the enclosed block without a profiler; yields
    the program's tracer."""
    global _capturing
    with _capture_lock:
        _capturing += 1
    try:
        yield _GLOBAL
    finally:
        with _capture_lock:
            _capturing -= 1


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Profile the enclosed block; yields `trace_dir`. The trace lands in
    `trace_dir/trace.json` when the block ends, also when it raises."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield trace_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
