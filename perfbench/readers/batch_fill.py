"""Real images per dispatch over ``max_batch``, in %, over the window
(``StreamingPredictor.stats``: dispatches, pad images and dispatches by
padded size)."""


def read(ctx):
    st = ctx.stats
    if not st["dispatches"]:
        return None
    padded = sum(int(s) * c for s, c in st["by_size"].items())
    real = padded - st["pad_images"]
    return 100.0 * real / (st["dispatches"] * int(ctx.traffic["max_batch"]))
