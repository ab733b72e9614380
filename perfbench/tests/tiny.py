"""Small stand-ins of the benchmark's cells for the CPU tests: the cell's
own configuration and traffic files with the encoder cut to a test-size
one, the image to 64² and the batch and load to a few images."""

import copy

from perfbench import core

SIZES = {"swin_b512": {"name": "swin_micro"}}


def tiny(cell_name: str):
    """(bench, cell, config file, traffic, limits) of a small version of
    ``cell_name``."""
    bench = core.Bench()
    cell = bench.cell(cell_name)
    cfg = copy.deepcopy(bench.config(cell["config"]))
    d = cfg["config"]
    d["data"]["image_size"] = 64
    d["model"]["encoder"].update(SIZES[cell["config"]])
    d["model"]["decoder"].update(pyramid_channels=32,
                                 segmentation_channels=16)
    t = dict(bench.traffic(cell), image=64)
    if t["kind"] == "train_staged":
        t.update(batch=2, warm_rounds=0)
    else:
        t.update(clients=8, max_batch=4, image_pool=16, keep_every=3,
                 compare_per_task=3)
    return bench, cell, cfg, t, bench.limits(cell)
