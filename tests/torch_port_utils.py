"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
seeded numpy weights in the shape of a JAX params tree, fed to both
packages."""

import numpy as np


def random_like_tree(shapes, seed: int):
    """A nested dict of f32 numpy arrays with the shapes of ``shapes`` (a
    JAX params tree of ShapeDtypeStructs or arrays), drawn from one seed:
    kernels ~ N(0, 1/fan_in) (fan_in = the input-channel axis times any
    spatial taps), LayerNorm/GroupNorm scales and FiLM gammas ~ 1 + N(0,
    0.1^2), everything else ~ N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)

    def leaf(path, shape):
        name = path[-1]
        if name == "kernel":
            # HWIO / [T,kh,kw,I,O] conv: taps * I; dense [I,O] / [T,I,O]: I
            fan_in = shape[-2]
            if len(shape) >= 4:
                fan_in *= shape[-3] * shape[-4]
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        if name in ("scale", "gammas"):
            return 1.0 + 0.1 * rng.standard_normal(shape)
        return 0.1 * rng.standard_normal(shape)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in sorted(node.items())}
        return leaf(path, tuple(node.shape)).astype(np.float32)

    return walk(shapes, ())
