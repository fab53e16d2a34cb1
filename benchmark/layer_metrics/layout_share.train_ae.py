"""The device time of the layout transposes, as a share of the traced
window's wall time (%): the rows the breakdown puts in
``layout_transpose`` (cuDNN's NCHW <-> NHWC conversions and other
transposes, ``benchmark.trace.GROUPS``), clipped to the window; None
where nothing ran on the device."""


def read(ctx):
    if not ctx.trace.busy():
        return None
    ops = dict(ctx.trace.breakdown(top=64)["device_ops"])
    return 100.0 * ops.get("layout_transpose", 0.0) / ctx.trace.window_s
