"""The whole step's share of the card's bf16 peak, in %: the operations
of the window's images (one image's forward, and for training its
backward, counted on the plain reference, ``counts.model_flops``; the
mean over the cell's tasks, which the traffic sends equally often) times
the images a second, over the peak of ``peaks.json``."""

from perfbench import counts


def read(ctx, train: bool):
    from perfbench.reference.config import Config
    from perfbench.reference.tasks import TaskRegistry

    cfg = Config(config_dict=ctx.config_dict)
    registry = TaskRegistry.from_config(cfg)
    types = [t for t, _ in ctx.traffic["tasks"]]
    flops = sum(counts.model_flops(cfg, registry, t, train)
                for t in types) / len(types)
    return 100.0 * flops * ctx.images_per_s / counts.PEAKS["bf16_flops"]
