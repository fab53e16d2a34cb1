"""The FD kernels' share of their bytes roofline (%): the sum of each
launch's least bytes at 3.35 TB/s over the sum of their device times in
the traced window; None where no FD kernel ran."""


def read(ctx):
    return ctx.fd_roofline_percent()
