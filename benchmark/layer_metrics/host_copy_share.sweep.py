"""The sweep's host copies' share of the traced sweep's wall time (%): the
union of ``sweep_on_device``'s ``sweep.host_copy`` spans (each segment's
copy from pinned memory into the output array) over the window; None
where the trace holds no such span."""

from benchmark import spans


def read(ctx):
    copies = spans.union(ctx.trace, ("sweep.host_copy",))
    if not copies:
        return None
    return spans.share(ctx.trace, spans.length(copies))
