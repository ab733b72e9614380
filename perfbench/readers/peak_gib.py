"""The device memory allocated at the window's peak, in GiB."""


def read(ctx):
    return ctx.window["peak_bytes"] / 2 ** 30
