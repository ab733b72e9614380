"""The SPM-interaction adapter's modules against the JAX package's flax
modules, on the CPU, with the same seeded numpy weights bridged into both
(``load_jax_params``): ``ConvGNAct`` (stride 1 and 2, an even and an odd
input: flax's 'SAME' pads a stride-2 3x3 conv on an even input (0, 1)),
``SpatialPyramidModule``, ``DeformableCrossAttention2D`` and
``InteractionBlock``, at the test size of the ViT tests: 32 channels,
stem 16, 4 heads, 4 points, a 64² image (pyramid 16²…2²) and a 4² ViT map;
and ``_resize_feature``'s antialiased non-integer downsample against
``jax.image.resize(method='linear')``.

Tolerances, of each output's or grad's largest magnitude:
- f32 forward within 1e-5 (convolutions and GroupNorm sums in another
  order);
- f32 grads (``jax.vjp`` against autograd, one seeded cotangent) with
  respect to every input and every parameter within 1e-4: the weight
  grads of the convolutions sum B·H·W products and the GroupNorm
  pullback cancels, so f32 rounding moves them further than the forward;
- bf16 compute (f32 params) within 4e-2 (about 5 bf16 ulps): both sides
  round every conv, GroupNorm and SiLU output to bf16 (8 bits), in other
  orders, and a one-ulp difference in an offset conv's output moves a
  sampling point. The pyramid's bf16 check runs at 128² (levels 32²…4²;
  measured 0.030 at the deepest level): at 64² its 2² level's GroupNorm
  normalises 4 values a group (one channel a group at 32 channels), so a
  one-ulp difference in its input moved the output by up to 0.145 of its
  largest magnitude over three seeds;
- the resize: f32 within 1e-6, bf16 within one bf16 ulp of the largest
  magnitude (JAX rounds the weights to bf16 and contracts in bf16 with f32
  accumulation, one axis at a time; the port rounds the weights the same
  way and contracts both axes in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.models import layers as jlayers
from fmc_uia_tpu.models.encoders import adapters as jad
from fmc_uia_tpu_torch.models import layers as players
from fmc_uia_tpu_torch.models.encoders import adapters as pad
from fmc_uia_tpu_torch.utils.convert import (
    jax_leaves_to_port,
    load_jax_params,
)
from torch_port_utils import random_like_tree

CH, STEM, HEADS, POINTS, SIZE = 32, 16, 4, 4, 64
BF16_TOL = 4e-2


def _np(t):
    return (t.detach().float().numpy() if torch.is_tensor(t)
            else np.asarray(jnp.asarray(t, jnp.float32)))


def _close(got, ref, rel, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    top = max(float(np.abs(ref).max()), 1e-30)
    assert err <= rel * top, (what, err, top)


def _inputs(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(jmod, port, shapes, seed):
    """flax params drawn from a seed, bridged into the port module."""
    xs = _inputs(shapes, seed)
    tree = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *xs)["params"]
    params = random_like_tree(tree, seed=seed + 100)
    load_jax_params(port, params)
    return params, xs


def check_module(jmod, port, shapes, seed, grads=True):
    """Forward (and with ``grads`` the VJP) of a flax module and its port
    on the same inputs and weights."""
    params, xs = _pair(jmod, port, shapes, seed)
    jx = [jnp.asarray(x) for x in xs]
    ref, vjp = jax.vjp(lambda p, *a: jmod.apply({"params": p}, *a),
                       params, *jx)
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = port(*tx)
    refs = ref if isinstance(ref, (list, tuple)) else [ref]
    outs = out if isinstance(out, (list, tuple)) else [out]
    assert len(outs) == len(refs)
    for i, (o, r) in enumerate(zip(outs, refs)):
        _close(o, r, 1e-5, f"output {i}")
    if not grads:
        return
    rng = np.random.RandomState(seed + 7)
    dys = [rng.standard_normal(r.shape).astype(np.float32) for r in refs]
    jd = [jnp.asarray(d) for d in dys]
    jgrads = vjp(jd if isinstance(ref, (list, tuple)) else jd[0])
    pnames = [n for n, _ in port.named_parameters()]
    pvals = [p for _, p in port.named_parameters()]
    got = torch.autograd.grad(outs, tx + pvals,
                              [torch.from_numpy(d) for d in dys])
    for i, x in enumerate(xs):
        _close(got[i], jgrads[1 + i], 1e-4, f"d input {i}")
    jp = jax_leaves_to_port(jax.tree_util.tree_map(np.asarray, jgrads[0]))
    assert set(jp) == set(pnames)
    for name, g in zip(pnames, got[len(xs):]):
        assert float(np.abs(jp[name]).max()) > 0, name
        _close(g, jp[name], 1e-4, f"d {name}")


def check_bf16(jmod, port, shapes, seed):
    """bf16 compute on bf16 inputs (what the module meets in the model:
    the image is cast to bf16, the pyramid and ViT maps are bf16)."""
    params, xs = _pair(jmod, port, shapes, seed)
    ref = jmod.apply({"params": params},
                     *[jnp.asarray(x, jnp.bfloat16) for x in xs])
    with torch.no_grad():
        out = port(*[torch.from_numpy(x).bfloat16() for x in xs])
    refs = ref if isinstance(ref, (list, tuple)) else [ref]
    outs = out if isinstance(out, (list, tuple)) else [out]
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, i
        _close(o, r, BF16_TOL, f"bf16 output {i}")


@pytest.mark.parametrize("stride,hw", [(1, 16), (2, 16), (2, 15)])
def test_conv_gn_act_matches_jax(stride, hw):
    jmod = jlayers.ConvGNAct(CH, strides=(stride, stride))
    port = players.ConvGNAct(STEM, CH, stride=stride)
    assert [n for n, _ in port.named_parameters()] == [
        "Conv_0.kernel", "GroupNorm_0.scale", "GroupNorm_0.bias"]
    check_module(jmod, port, [(2, hw, hw, STEM)], seed=1)


def test_conv_gn_act_bf16_matches_jax():
    check_bf16(jlayers.ConvGNAct(CH, strides=(2, 2), dtype=jnp.bfloat16),
               players.ConvGNAct(STEM, CH, stride=2, dtype=torch.bfloat16),
               [(2, 16, 16, STEM)], seed=2)


def test_spatial_pyramid_matches_jax():
    jmod = jad.SpatialPyramidModule((CH,) * 4, stem_channels=STEM)
    port = pad.SpatialPyramidModule((CH,) * 4, STEM)
    params, xs = _pair(jmod, port, [(2, SIZE, SIZE, 3)], seed=3)
    assert set(params) == {"stem0", "stem1", "s4_0", "s4_1", "s8_0", "s8_1",
                           "s16_0", "s16_1", "s32_0", "s32_1"}
    with torch.no_grad():
        out = port(torch.from_numpy(xs[0]))
    assert [tuple(o.shape[1:3]) for o in out] == [(16, 16), (8, 8), (4, 4),
                                                  (2, 2)]
    check_module(jmod, port, [(2, SIZE, SIZE, 3)], seed=3)


def test_spatial_pyramid_bf16_matches_jax():
    check_bf16(jad.SpatialPyramidModule((CH,) * 4, stem_channels=STEM,
                                        dtype=jnp.bfloat16),
               pad.SpatialPyramidModule((CH,) * 4, STEM,
                                        dtype=torch.bfloat16),
               [(2, 2 * SIZE, 2 * SIZE, 3)], seed=4)


def _attn(dtype_j=jnp.float32, dtype_p=torch.float32):
    return (jad.DeformableCrossAttention2D(CH, HEADS, POINTS, 0.25,
                                           dtype=dtype_j),
            pad.DeformableCrossAttention2D(CH, HEADS, POINTS, 0.25,
                                           dtype=dtype_p))


# the stride-4 query grid (16²) against the 4² ViT map, and a non-square
# pair
@pytest.mark.parametrize("q,kv", [((16, 16), (4, 4)), ((6, 10), (5, 3))])
def test_deformable_cross_attention_matches_jax(q, kv):
    jmod, port = _attn()
    shapes = [(2, *q, CH), (2, *kv, CH)]
    params, _ = _pair(jmod, port, shapes, seed=5)
    assert params["offset_proj"]["kernel"].shape == (3, 3, CH,
                                                     HEADS * POINTS * 2)
    assert "bias" in params["offset_proj"]
    check_module(jmod, port, shapes, seed=5)


def test_deformable_offsets_keep_the_jax_channel_order():
    """The offset channels are (head, point, xy): the port's sampling
    coordinates equal base + 0.25·tanh(offset conv) read in that order."""
    jmod, port = _attn()
    shapes = [(2, 6, 10, CH), (2, 5, 3, CH)]
    _, xs = _pair(jmod, port, shapes, seed=6)
    q = torch.from_numpy(xs[0])
    with torch.no_grad():
        coords = port.sample_coords(q)
        off = (torch.tanh(port.offset_proj(q)) * 0.25).numpy()
    assert coords.shape == (2, 6, 10, HEADS, POINTS, 2)
    gx = np.linspace(-1.0, 1.0, 10, dtype=np.float32)
    gy = np.linspace(-1.0, 1.0, 6, dtype=np.float32)
    for h, p in ((0, 0), (1, 3), (3, 2)):
        c = 2 * (h * POINTS + p)
        np.testing.assert_array_equal(
            coords[..., h, p, 0].numpy(), gx[None, None, :] + off[..., c])
        np.testing.assert_array_equal(
            coords[..., h, p, 1].numpy(),
            gy[None, :, None] + off[..., c + 1])


def test_deformable_cross_attention_bf16_matches_jax():
    check_bf16(*_attn(jnp.bfloat16, torch.bfloat16),
               [(2, 16, 16, CH), (2, 4, 4, CH)], seed=7)


def test_interaction_block_matches_jax():
    jmod = jad.InteractionBlock(CH, HEADS, POINTS, 0.25)
    port = pad.InteractionBlock(CH, HEADS, POINTS, 0.25)
    shapes = [(2, 16, 16, CH), (2, 4, 4, CH)]
    params, _ = _pair(jmod, port, shapes, seed=8)
    assert set(params) == {"norm1", "norm2", "cross_attn", "ffn0", "ffn1"}
    check_module(jmod, port, shapes, seed=8)


def test_interaction_block_bf16_matches_jax():
    check_bf16(jad.InteractionBlock(CH, HEADS, POINTS, 0.25,
                                    dtype=jnp.bfloat16),
               pad.InteractionBlock(CH, HEADS, POINTS, 0.25,
                                    dtype=torch.bfloat16),
               [(2, 16, 16, CH), (2, 4, 4, CH)], seed=9)


@pytest.mark.parametrize("src,dst", [((16, 16), (14, 14)), ((16, 16), (7, 7)),
                                     ((37, 23), (9, 12))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_feature_antialiased_downsample_matches_jax(src, dst, dtype):
    x = np.random.RandomState(10).standard_normal((2, *src, 5)).astype(
        np.float32)
    jx = jnp.asarray(x, dtype)
    ref = jax.image.resize(jx, (2, *dst, 5), method="linear")
    assert ref.dtype == jx.dtype
    # the JAX adapter's own branch takes this resize
    np.testing.assert_array_equal(
        np.asarray(jad._resize_feature(jx, *dst), np.float32),
        np.asarray(ref, np.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = pad._resize_feature(tx, *dst)
    assert got.dtype == tx.dtype and tuple(got.shape) == (2, *dst, 5)
    top = float(np.abs(np.asarray(ref, np.float32)).max())
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7  # one bf16 ulp of [1, 2)
    _close(got, ref, tol * (1.0 if dtype == "float32" else
                            2.0 ** np.ceil(np.log2(top)) / top))


def test_antialias_weights_match_jax():
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    for n_in, n_out in ((16, 14), (16, 7), (37, 9), (23, 12), (5, 3)):
        ref = compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                 _fill_triangle_kernel, True)
        got = pad.antialias_weights(n_in, n_out)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(got.sum(0).numpy(), 1.0, atol=1e-6)
