"""The program's span recorder: the one clock of its timings.

A span is a named interval on the host clock.  Its parent is the
innermost span open on the same thread when it opens, and its self time
is its duration less what its children cover.  A *run* (one
``run_pipeline`` call) keeps, per span name, the total and self seconds
and the number of times it was entered, and the counters added while it
was open; the last :data:`KEEP_RUNS` finished runs stay in memory
(:func:`recent_runs`).

A span costs two clock reads and a dict update.  Only while a
``torch.profiler`` session is active does it also open
``torch.profiler.record_function`` under its name, so the program's
spans land in the session's Chrome trace beside the kernels.  No span
waits for a device.

Usage::

    with spans.RunSpan("rpvg.pass") as whole:   # opens a run on this thread
        with spans.Span("rpvg.fragments") as frag:
            ...
            spans.count("fragments.blocks")
    whole.seconds, frag.seconds, whole.run.summary()

A thread that works for another thread's run records into it
explicitly (:func:`each`); its spans are the roots of their thread.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional

import torch
from torch.autograd import profiler as _session_flag

KEEP_RUNS = 64

# The clock every span reads (seconds); tests put their own in its place.
clock = time.perf_counter


class Run:
    """What one run recorded: per span name [total_s, self_s, count], and
    the counters."""

    __slots__ = ("spans", "counters", "_lock")

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, int] = {}
        # The reader thread of the fragment pass records into the run of
        # the thread that started it.
        self._lock = threading.Lock()

    def add(self, name: str, total: float, own: float) -> None:
        with self._lock:
            entry = self.spans.get(name)
            if entry is None:
                self.spans[name] = [total, own, 1]
            else:
                entry[0] += total
                entry[1] += own
                entry[2] += 1

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def summary(self) -> Dict[str, Dict]:
        """{"spans": name -> {"total_s", "self_s", "count"}, "counters"}."""
        with self._lock:
            return {
                "spans": {
                    name: {"total_s": total, "self_s": own, "count": int(n)}
                    for name, (total, own, n) in self.spans.items()
                },
                "counters": dict(self.counters),
            }


_RECENT: "collections.deque" = collections.deque(maxlen=KEEP_RUNS)
_local = threading.local()


def _thread():
    try:
        _local.stack
    except AttributeError:
        _local.stack = []
        _local.run = None
    return _local


def current_run() -> Optional[Run]:
    """The run open on this thread, or None."""
    return _thread().run


def recent_runs(n: int) -> List[Dict]:
    """The summaries of the last ``n`` finished runs, oldest first."""
    if n <= 0:
        return []
    return [run.summary() for run in list(_RECENT)[-n:]]


class Span:
    """One interval; a context manager, or :func:`begin` / :meth:`close`
    where the interval does not follow a block (the phase clock)."""

    __slots__ = ("name", "run", "start", "end", "children", "parent", "_record", "_stack")

    def __init__(self, name: str, run: Optional[Run] = None):
        self.name = name
        self.run = run
        self.end = None

    def __enter__(self) -> "Span":
        return self._open(None)

    def _open(self, start: Optional[float]) -> "Span":
        state = _thread()
        if self.run is None:
            self.run = state.run
        stack = self._stack = state.stack
        self.parent = stack[-1] if stack else None
        self.children = 0.0
        self._record = None
        # Every profiler session sets the module's flag for all threads;
        # the thread-local state covers a session that does not.
        if getattr(_session_flag, "_is_profiler_enabled", False) or (
            torch.autograd._profiler_enabled()
        ):
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        stack.append(self)
        self.start = clock() if start is None else start
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _pop(self) -> None:
        """Off the stack, with whatever its thread left open above it
        (a block that raised between a phase clock's laps)."""
        stack = self._stack
        if self not in stack:  # already unwound by a span it was inside
            self._exit_record()
            return
        while stack:
            top = stack.pop()
            if top is self:
                break
            top._exit_record()
        self._exit_record()

    def _exit_record(self) -> None:
        if self._record is not None:
            self._record.__exit__(None, None, None)
            self._record = None

    def close(self, end: Optional[float] = None, name: Optional[str] = None) -> float:
        """End the span at ``end`` (read now when None), recorded under
        ``name`` when given; returns its seconds."""
        self.end = clock() if end is None else end
        self._pop()
        seconds = self.end - self.start
        if self.parent is not None:
            self.parent.children += seconds
        if name is not None:
            self.name = name
        if self.run is not None:
            self.run.add(self.name, seconds, seconds - self.children)
        return seconds

    def discard(self) -> None:
        """End the span without recording it: its time stays its
        parent's own."""
        self._pop()

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def elapsed(self) -> float:
        """Seconds since the span opened (for a log line)."""
        return clock() - self.start


def begin(name: str, start: Optional[float] = None) -> Span:
    """Span ``name``, open until its :meth:`Span.close`; from ``start``
    when given (a clock reading that ended the span before it)."""
    return Span(name)._open(start)


class RunSpan(Span):
    """Span ``name``, the root of a new run when this thread has none open
    (the run is finished and kept when the span closes)."""

    __slots__ = ("owner", "_saved")

    def __enter__(self) -> "RunSpan":
        state = _thread()
        self.owner = state.run is None
        if self.owner:
            # A run's root has no parent: it starts a stack of its own.
            self._saved = state.stack
            state.stack = []
            state.run = Run()
        return super().__enter__()

    def __exit__(self, *exc) -> None:
        self.close()
        if self.owner:
            state = _thread()
            state.stack = self._saved
            state.run = None
            _RECENT.append(self.run)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of this thread's run, if one is open."""
    run = _thread().run
    if run is not None:
        run.count(name, n)


def each(name: str, iterable: Iterable, run: Optional[Run]) -> Iterator:
    """The items of ``iterable``, producing each one a span ``name`` of
    ``run`` (the exhausted last call is not recorded)."""
    items = iter(iterable)
    while True:
        step = Span(name, run).__enter__()
        try:
            item = next(items)
        except StopIteration:
            step.discard()
            return
        except BaseException:
            step.discard()
            raise
        step.close()
        yield item
