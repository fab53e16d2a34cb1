"""The program's host spans in a traced window.

``deepfluids_tpu_torch.spans`` makes each span a ``user_annotation`` row of
the profiler's Chrome trace while a profiler records, on the clock of the
device rows, so a span's time can be set against the device's idle gaps
(:meth:`benchmark.trace.Trace.gaps`).  A trace of a program without spans
holds no such row: the readers built on this return None there.  Times
are in seconds.
"""

from __future__ import annotations

import bisect

from benchmark.trace import Trace

# The chunk feed of the trainer: the host's work for each chunk of steps
# (the block of indices, rates and masks; the staging and copies; the
# graph's launch), and the staging wait inside the fill, in which the host
# waits on the device and so does not feed it.
FEED = ("train.block", "train.fill", "train.replay")
STAGE_WAIT = "train.stage_wait"


def union(trace, names) -> list[tuple[float, float]]:
    """The union of the span rows named ``names``, clipped to the window,
    in order; empty where no device row lies in the window (a CPU run's
    trace: the spans are read beside the device's rows)."""
    if not trace.busy():
        return []
    rows = [r for r in trace.host
            if r.cat == "user_annotation" and r.name in names]
    return Trace(trace.window, device=rows).busy()


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def both(xs, ys) -> list[tuple[float, float]]:
    """The intersection of two ordered lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(xs, ys) -> list[tuple[float, float]]:
    """The parts of the ordered disjoint intervals ``xs`` that none of
    ``ys`` covers, in order."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


def share(trace, seconds: float) -> float:
    """``seconds`` as a percentage of the window."""
    return 100.0 * seconds / trace.window_s


def feed_idle(trace) -> float | None:
    """The device idle that the chunk feed causes (%): the window's idle
    gaps in which the feed issues a CUDA call, so that the card waits on
    the host's launches, counted inside the feed's spans less their
    staging waits.  The short gaps between the kernels of a replay that is
    already launched, in which the feed issues nothing, are the step's."""
    feed = union(trace, FEED)
    if not feed:
        return None
    fed = minus(feed, union(trace, (STAGE_WAIT,)))
    starts = [a for a, _ in fed]
    calls = []
    for r in trace.host:
        i = bisect.bisect_right(starts, r.t0) - 1
        if r.cat == "cuda_runtime" and i >= 0 and r.t0 < fed[i][1]:
            calls.append(r.t0)
    calls.sort()
    waited = [(a, b) for a, b in trace.gaps()
              if bisect.bisect_left(calls, a) < bisect.bisect_left(calls, b)]
    return share(trace, length(both(fed, waited)))
