"""The device's idle share of the traced stretch, in %: 1 - (the seconds
in which an operation ran on the device, the union of its activity
intervals) / (the stretch's length), as the result line's ``busy_s`` and
``window_s`` give them. The stretch runs under the profiler, so its idle
share holds the profiler's host cost too."""


def read(ctx):
    t = ctx.trace
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
