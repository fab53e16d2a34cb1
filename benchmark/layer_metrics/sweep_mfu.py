"""The sweep's share of the card's bf16 peak (%): the forward FLOPs of
the fields the traced sweep delivered over its wall time."""


def read(ctx):
    return ctx.mfu_percent(ctx.work["fields"] * ctx.work["flops_per_field"])
