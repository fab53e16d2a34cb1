"""Host spans: the wall time of named phases of the program's host work.

``with span(name):`` adds the block's wall time and one count to
``totals[name]``.  While a ``torch.profiler`` records, it also opens a
``torch.profiler.record_function(name)``, so the span is a
``user_annotation`` row of the profiler's Chrome trace, on the clock of
the device rows beside it.  Otherwise it costs a flag read, two clock reads
and a dict update.

``totals`` maps a name to ``[count, ns, self ns]`` (self: the span's time
less that of the spans opened inside it) and is plain integers, as
:data:`..ops.cuda_fd.launch_counts` is; :func:`take` hands them over and
starts them afresh (the trainer writes them into ``metrics.jsonl``).
Spans nest within one thread; the program opens them from its main thread
only.  A span row carries its name alone: its start places it (a chunk's
first step, a segment's index) among the rows of the trace.

No span is opened inside a CUDA graph's capture: a capture records device
work only, and a span inside it would time the capture, not the replays.
"""

from __future__ import annotations

import time

from torch.autograd import profiler as _profiler

_clock = time.perf_counter_ns
totals: dict[str, list[int]] = {}
_children: list[int] = []   # child ns of each open span, innermost last


class span:
    """A named host span (a context manager); ``ns`` is its duration once
    it has closed."""

    __slots__ = ("name", "ns", "_t0", "_row")

    def __init__(self, name: str):
        self.name, self.ns = name, 0

    def __enter__(self) -> span:
        self._row = None
        if _profiler._is_profiler_enabled:
            self._row = _profiler.record_function(self.name)
            self._row.__enter__()
        _children.append(0)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        ns = self.ns = _clock() - self._t0
        own = ns - _children.pop()
        if _children:
            _children[-1] += ns
        t = totals.get(self.name)
        if t is None:
            totals[self.name] = [1, ns, own]
        else:
            t[0] += 1
            t[1] += ns
            t[2] += own
        if self._row is not None:
            self._row.__exit__(*exc)


def take() -> dict[str, list[int]]:
    """The totals since the last call (``[count, ns, self ns]`` a name),
    which start afresh."""
    out = dict(totals)
    totals.clear()
    return out

