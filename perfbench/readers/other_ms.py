"""Device ms a step (or a dispatch) in kernels of no hand-written group:
the libraries' GEMMs and convolutions, casts, norms, elementwise work and
the optimizer's foreach kernels."""


def read(ctx):
    calls = sum(ctx.batches.values())
    if not calls:
        return None
    g = ctx.trace["group_s"]
    return 1e3 * (g.get("library", 0.0) + g.get("other", 0.0)) / calls
