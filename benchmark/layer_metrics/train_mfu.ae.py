"""The autoencoder's training step's share of the card's bf16 peak (%):
the dense and conv FLOPs of the traced steps through encoder and decoder
(forward, weight and input gradients; see ``benchmark/flops_ae.py``) over
the traced window's wall time."""


def read(ctx):
    return ctx.mfu_percent(ctx.work.get("steps", 0)
                           * ctx.work["flops_per_step"])
