"""The device-to-host copies' share of the traced sweep's wall time (%):
``sweep_on_device``'s segment copies into pinned memory."""


def read(ctx):
    rows = [r for r in ctx.trace.rows("gpu_memcpy") if "DtoH" in r.name]
    if not rows:
        return None
    return 100.0 * sum(r.t1 - r.t0 for r in rows) / ctx.trace.window_s
