"""The share of the traced window's wall time in which no kernel and no
copy ran on the card (%), from the union of the trace's device rows."""


def read(ctx):
    return ctx.idle_percent()
