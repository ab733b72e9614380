"""Host ms of one call of the timed path with the card idle (a train
step averaged over a round of the tasks; a predictor forward at the
serving batch, the median), measured after the window."""


def read(ctx):
    return getattr(ctx, "enqueue_ms", None)
