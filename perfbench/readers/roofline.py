"""A hand-written kernel's share of its roofline, in %: the sum of the
bounds of the traced stretch's launches (``counts.py``, the launches the
wrapper's ``.launches`` counter read there, at the cell's shapes) over the
device seconds of the kernel's group in the trace. A kernel that launched
with no device time in its group fails the run: its kernels' names no
longer match ``kernel_groups.json``."""

from perfbench import counts


def read(ctx, kernel: str):
    launches = (ctx.launches or {}).get(kernel, 0)
    if not launches:
        return None
    dev_s = ctx.trace["group_s"].get(kernel, 0.0)
    if dev_s <= 0.0:
        raise RuntimeError(f"{kernel} launched {launches} times in the "
                           "trace, and no device kernel matched its group")
    bound = counts.explained_bound_s(kernel, ctx.config, ctx.batches,
                                     launches)
    if bound is None:
        raise RuntimeError(f"{kernel}: {launches} launches over "
                           f"{ctx.batches} calls match no set of stages")
    return 100.0 * bound / dev_s
