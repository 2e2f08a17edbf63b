"""The device as a whole: the share of the traced window in which no
kernel, copy or memset ran on the card, in percent."""


def read(ctx):
    w = ctx.trace.window_us
    busy = ctx.trace.busy_us()
    return 100.0 * (1.0 - busy / w) if w > 0 and busy > 0 else None
