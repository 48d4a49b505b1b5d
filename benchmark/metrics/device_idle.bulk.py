"""device_idle.bulk: the share of the traced window of bulk batches in which
no operation ran on the card (1 - union of device operations / window)."""


def read(ctx):
    return ctx.window.idle_share() if ctx.window else None
