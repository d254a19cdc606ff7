"""Spans and counters inside the step loop.

A span times one phase of the program: its host start and end
(`time.perf_counter_ns`) and, on a card, a pair of CUDA events recorded
on the current stream at its two ends (where its stream time is read). Their interval is the phase's
stream time: the device's timeline from when the stream reached the
phase's first operation to when it finished its last, gaps the host left
inside the phase included. A counter adds up a count where the work
happens; a count that lives on the device stays there as a tensor until
`report()`, so nothing is read back while the program runs.

The switch: the recorder records while a `torch.profiler` runs, and
inside `with recording():` (the spans without the profiler's cost). Each
entry point (`Scenario.step_chunk`, `Engine.simulate`, a `Mesh`
collective) reads it once per call with `probe(device)`, which gives None
when it is off. Every span and counter below an entry point then costs one
`if` on that probe: no record function, no event, no counter. Under a
profiler each span is also a host operation named `csf::<name>`, so it
sits on the profiler's clock beside the device trace.

The recorder keeps what it records in memory until `clear()`: every
profiled call of the process, and every call inside `recording()`.
`report()` reads it once, after the caller's synchronize:

    with tracing.recording():
        scen.step_chunk()
    print(tracing.report())

Spans (parent in brackets; the first four have host times only):
`csf::chunk` and `csf::sync` [chunk] (`Scenario.step_chunk` and its
synchronize); `csf::simulate` [chunk where called from it] (the whole of
`Engine.simulate`); below it `csf::capture` (a `ChunkRunner`'s warm-up
and graph capture), `csf::rebuild` (each neighbor-table build),
`csf::permute` (the state into the table's cell order), `csf::load` (the
copies into the runner's static buffers), `csf::replay` (the graph
launch, or the eager chunk where there is no runner), `csf::copy_out`
(the record rows and the final clone out of the runner's buffers),
`csf::unpermute` (back to the caller's row order); `csf::collective`
(one `parallel.sharding.Mesh` collective).

Counters: `steps`, `rebuilds`, `captures` (`ChunkRunner` constructions);
`table_pairs`, the receiver x source pairs the pair kernel walks through
the tables' valid slots (a table's valid slots x block x block_src x the
steps it serves); `table_overflow_rows`, the receiver blocks whose table
overflowed (`NeighborConfig.kb` too small: the farthest source blocks
were dropped), summed over the rebuilds; `field_pairs`, the pairs whose
field K1 evaluated on the card (`Engine.field_pairs`, a device count that
only grows, of which `growth` takes a copy at both ends of each recorded
`Engine.simulate`; the plain version on the CPU counts none).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

PREFIX = "csf::"
# device tensors a counter holds before it sums them into one
FOLD_COUNTS = 512
# spans the recorder holds before it folds the finished ones into totals
FOLD_SPANS = 8192


def _host_operation(name: str):
    """The profiler's mark of a span: a record function of the scope
    that aten operations have. `torch.profiler.record_function` marks a
    user annotation, for which the profiler also draws a range on the
    device's timeline over the kernels launched inside it, and a device
    trace would count that range as device activity."""
    return torch._C._profiler._RecordFunctionFast(name)


class Span:
    """One timed phase, a context manager. `stream` (a CUDA stream, or
    None) is where the pair of events is recorded; `profiled` also enters
    a host operation of the span's name in the profiler's trace; `recorder`
    (or None) is the `Recorder` that takes the span at its end, and whose
    innermost open span is its `parent`."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "events",
                 "_stream", "_function", "_recorder")

    def __init__(self, name: str, stream=None, profiled: bool = False,
                 recorder=None):
        self.name = name
        self.parent = None
        self.start_ns = self.end_ns = None
        self._stream = stream
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if stream is not None else None)
        self._function = (_host_operation(name) if profiled else None)
        self._recorder = recorder

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        if self._recorder is not None:
            self.parent = self._recorder._open(self)
        if self._function is not None:
            self._function.__enter__()
        if self.events is not None:
            self.events[0].record(self._stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self._stream)
        if self._function is not None:
            self._function.__exit__(*exc)
        self.end_ns = time.perf_counter_ns()
        if self._recorder is not None:
            self._recorder._close(self)
        return False

    def host_ms(self) -> float:
        return 1e-6 * (self.end_ns - self.start_ns)

    def stream_ms(self):
        """The stream time between the two events (waits for the second),
        or None without a card."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])

    def seconds(self) -> float:
        """Stream seconds on a card, host seconds without one."""
        ms = self.stream_ms()
        return 1e-3 * (self.host_ms() if ms is None else ms)


class Recorder:
    """Spans and counters in memory, read by `report()`."""

    def __init__(self):
        self._local = threading.local()
        self.clear()

    def clear(self):
        self.spans = []
        self.counters = {}
        self._totals = {}     # name -> [count, host ms, stream ms or None]
        self._pending = {}    # counter -> [(device tensor, factor)]
        self._folded = {}     # counter -> device tensor

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, span):
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(span)
        return parent

    def _close(self, span):
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        self.spans.append(span)
        if len(self.spans) >= FOLD_SPANS:
            self._fold_spans()

    def _fold_spans(self):
        """Fold the spans whose device work has finished into the totals
        (a query, not a wait): a long recording holds no more than
        FOLD_SPANS spans and their events."""
        kept = []
        for sp in self.spans:
            if sp.events is not None and not sp.events[1].query():
                kept.append(sp)
            else:
                _add_span(self._totals, sp)
        self.spans = kept

    def count(self, name: str, value, factor: int = 1):
        """Add `value` x `factor` to counter `name`: a Python number, or a
        device tensor, held (not read) and summed at `report()`."""
        if not isinstance(value, torch.Tensor):
            self.counters[name] = self.counters.get(name, 0) + value * factor
            return
        pending = self._pending.setdefault(name, [])
        pending.append((value, factor))
        if len(pending) >= FOLD_COUNTS:
            self._fold_counter(name)

    def _fold_counter(self, name: str):
        total = self._folded.get(name)
        by_factor = {}
        for t, f in self._pending.pop(name):
            by_factor.setdefault(f, []).append(t.reshape(-1))
        for f, ts in by_factor.items():
            part = torch.cat(ts).sum(dtype=torch.int64) * f
            total = part if total is None else total + part
        self._folded[name] = total

    def report(self) -> dict:
        """{"steps", "spans": {name: {"count", "host_ms", "stream_ms"}},
        "counters": {name: int}}: the spans summed by name (stream_ms
        None where no span of the name ran on a card) and every counter.
        Call after the recorded work's synchronize."""
        totals = {k: list(v) for k, v in self._totals.items()}
        for sp in self.spans:
            _add_span(totals, sp)
        counters = dict(self.counters)
        for name in list(self._pending):
            self._fold_counter(name)
        for name, t in self._folded.items():
            counters[name] = counters.get(name, 0) + int(t)
        return {"steps": counters.get("steps", 0),
                "spans": {k: {"count": n, "host_ms": h, "stream_ms": s}
                          for k, (n, h, s) in totals.items()},
                "counters": counters}


def _add_span(totals: dict, sp: Span):
    entry = totals.setdefault(sp.name, [0, 0.0, None])
    entry[0] += 1
    entry[1] += sp.host_ms()
    ms = sp.stream_ms()
    if ms is not None:
        entry[2] = (entry[2] or 0.0) + ms


RECORDER = Recorder()
_recording = 0


class Probe:
    """One entry-point call's handle on the recorder while it is on:
    its spans' events go to `stream`, the current stream of the call's
    card at its entry (None without a card; looked up once, as the
    lookup costs more than an event's record)."""

    __slots__ = ("stream", "profiled")

    def __init__(self, stream, profiled: bool):
        self.stream = stream
        self.profiled = profiled

    def span(self, name: str, stream: bool = True) -> Span:
        return Span(PREFIX + name, self.stream if stream else None,
                    self.profiled, RECORDER)


def current_stream(device):
    """The current stream of `device` where it is a card, else None."""
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


def probe(device) -> Probe | None:
    """Read the switch for one call of an entry point whose tensors live
    on `device`: a Probe while a profiler runs or inside `recording()`,
    else None."""
    profiled = torch.autograd._profiler_enabled()
    if not (profiled or _recording):
        return None
    return Probe(current_stream(device), profiled)


_OFF = contextlib.nullcontext()


def span(p: Probe | None, name: str, stream: bool = True):
    """The span `csf::<name>` of probe `p`, or a context that does
    nothing where `p` is None. `stream=False` leaves out its events: a
    span whose stream time nothing reads (an entry point's) costs the
    host less."""
    return _OFF if p is None else p.span(name, stream)


def count(p: Probe | None, name: str, value, factor: int = 1):
    """Add to counter `name` where probe `p` records."""
    if p is not None:
        RECORDER.count(name, value, factor)


@contextlib.contextmanager
def growth(p: Probe | None, name: str, tensor):
    """Add to counter `name` how far the device count `tensor` grows
    inside the block, where probe `p` records and `tensor` is not None: a
    copy at entry and a difference at exit, queued on the stream and read
    at `report()`."""
    if p is None or tensor is None:
        yield
        return
    start = tensor.clone()
    try:
        yield
    finally:
        RECORDER.count(name, tensor - start)


@contextlib.contextmanager
def recording():
    """Record the spans and counters of the calls inside the block, with
    no profiler running."""
    global _recording
    _recording += 1
    try:
        yield RECORDER
    finally:
        _recording -= 1


def report() -> dict:
    """What the recorder holds (`Recorder.report`)."""
    return RECORDER.report()


def clear():
    """Empty the recorder."""
    RECORDER.clear()
