"""device_idle.online: the share of the traced window of online batches in
which no operation ran on the card (1 - union of device operations /
window)."""


def read(ctx):
    return ctx.window.idle_share() if ctx.window else None
