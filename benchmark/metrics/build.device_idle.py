"""build.device_idle: the share of the traced build_hnsw_index call in which
no operation ran on the card."""


def read(ctx):
    return ctx.build.idle_share() if ctx.build else None
