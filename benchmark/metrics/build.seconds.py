"""build.seconds: the mean seconds of the set-up's timed builds of the whole
corpus (host clock, the card synchronised), before anything is traced."""


def read(ctx):
    return ctx.build_s
