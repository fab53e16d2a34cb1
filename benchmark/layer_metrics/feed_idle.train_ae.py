"""The device's idle time under the trainer's chunk feed, as a share of the
traced window (%): the window's device-idle gaps inside the union of the
``train.block``, ``train.fill`` and ``train.replay`` spans, less their
``train.stage_wait`` (the host waits on the device there); None where the
trace holds no such span."""

from benchmark import spans


def read(ctx):
    return spans.feed_idle(ctx.trace)
