"""The host side of the bf16 MLP branch kernels (``ops/swin_block.py``), on
the CPU: K2b's launch plan (``mlp_bwd_plan``: the split-K token slots of
dW1 and dW2, db1's slots of one 128-token tile each, and the workspace
bytes, carved as ``csrc/swin_mlp_bwd.cu`` carves them), db1 summed the way
K2b sums it, and the widths the kernels take and refuse
(``mlp_kernel_dims``: every C % 32 == 0 up to 1003), and K2f's workspace
(``mlp_fwd_plan``: the bf16 weights, and above C = 256 xn and h between
its two products, carved as ``csrc/swin_mlp_fwd.cu`` carves them).

db1 is held against ``_mlp_pullback``'s from the JAX package with
``test_torch_swin_bwd``'s tolerances: f32 1e-5 of its largest magnitude
(the same f32 terms added in another order), bf16 2 bf16 ulps of it."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmc_uia_tpu.ops.swin_block_pallas import _mlp_pullback
from fmc_uia_tpu_torch.ops import swin_block as sb
from test_torch_swin_bwd import _leaf_tol
from test_torch_swin_kernels import DTYPES, _mlp_inputs, _to_np, _torch_mlp_args

# (B, grid, C): the flagship's fused stages (swin_b 512²) at the serving
# and train batches, and swin_t's (224²)
PLAN_CASES = [(B, g, c) for B in (8, 24)
              for g, c in ((128, 128), (64, 256), (56, 96), (28, 192))]
# chip_smoke.py's other K2b cases: the remaining widths the kernels take
# (C = 32, 64, 160, 224) and a ragged 147-token case
SMALL_CASES = [(2, 16, 32), (2, 16, 64), (2, 14, 160), (1, 14, 224),
               (3, 7, 128)]


def _f32_h1_workspace(T, C, Ch):
    """Bytes of a bf16 K2b workspace without the dual product (h1 kept in
    f32): mu, rstd, xn, dyc, h1 (f32), gc, dh1c, dxn, the split-K partials
    of 64 x 64 tiles (about 1024 blocks, at least 256 tokens a split), the
    column-sum and LN partials, each piece at a multiple of 256 bytes."""
    def splits(M, N, K):
        tiles = -(-M // 64) * -(-N // 64)
        return max(1, min(-(-1024 // tiles), -(-K // 256)))

    colsum = -(-T // max(-(-T // 256), 512))
    ln_parts = -(-T // max(-(-T // 256), 64))
    return sb._carve([
        (T, 4), (T, 4), (T * C, 2), (T * C, 2), (T * Ch, 4), (T * Ch, 2),
        (T * Ch, 2), (T * C, 4), (splits(Ch, C, T) * Ch * C, 4),
        (splits(C, Ch, T) * C * Ch, 4), (colsum * Ch, 4), (colsum * C, 4),
        (ln_parts * C, 4), (ln_parts * C, 4)])


@pytest.mark.parametrize("B, grid, C", PLAN_CASES + SMALL_CASES)
def test_split_k_slots_cover_every_token_once(B, grid, C):
    T, Ch = B * grid * grid, 4 * C
    plan = sb.mlp_bwd_plan(T, C, Ch)
    for M, N, w in ((Ch, C, "w1"), (C, Ch, "w2")):
        kchunk, slots = plan[f"kchunk_{w}"], plan[f"slots_{w}"]
        assert kchunk % sb.GEMM_K == 0 and kchunk >= sb.GEMM_K
        bounds = [(z * kchunk, min(T, (z + 1) * kchunk))
                  for z in range(slots)]
        assert bounds[0][0] == 0 and bounds[-1][1] == T
        assert all(lo < hi for lo, hi in bounds)  # no empty slot
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        tiles = -(-M // sb.GEMM_M) * -(-N // sb.GEMM_N)
        assert slots * tiles <= sb.SPLIT_TILES
        assert (kchunk, slots) == sb.split_k_plan(M, N, T)
    # db1: one slot per 128-token tile of the dual product
    assert (plan["tiles"] - 1) * sb.MLP_TILE < T <= plan["tiles"] * sb.MLP_TILE


@pytest.mark.parametrize("B, grid, C", PLAN_CASES)
def test_workspace_drops_the_f32_hidden_buffer(B, grid, C):
    """The plan's workspace is smaller than one that keeps h1 in f32, by
    nearly the T x 4C f32 h1 (the bf16 weight copies and the per-tile db1
    partials take a little of it back)."""
    T, Ch = B * grid * grid, 4 * C
    new, old = sb.mlp_bwd_plan(T, C, Ch)["workspace"], _f32_h1_workspace(
        T, C, Ch)
    assert new < old
    assert old - new > 0.9 * T * Ch * 4, (old, new)


def test_workspace_counts_each_piece():
    """The carving of a small case, piece by piece (256-byte starts)."""
    T, C, Ch = 200, 32, 128
    plan = sb.mlp_bwd_plan(T, C, Ch)
    assert plan["slots_w1"] == plan["slots_w2"] == 1
    assert plan["kchunk_w1"] == plan["kchunk_w2"] == 256
    assert plan["tiles"] == 2
    pieces = [Ch * C * 2, C * Ch * 2, T * 4, T * 4, T * C * 2, T * C * 2,
              T * Ch * 2, T * Ch * 2, T * C * 4, Ch * C * 4, C * Ch * 4,
              2 * Ch * 4, C * 4, 4 * C * 4, 4 * C * 4]
    off = 0
    for p in pieces:
        off = -(-off // 256) * 256 + p
    assert plan["workspace"] == off


def _dh1(x, args, dy, dp):
    """The f32 dh1 of the plain pullback, [T, Ch], from the same rounded
    values (mlp_branch_backward_reference's lines up to dh1)."""
    ln_s, ln_b, w1, b1, w2, _ = args
    cd, B, C = x.dtype, x.shape[0], x.shape[-1]
    xh, _ = sb._ln_stats(x.float().reshape(B, -1, C))
    xn = sb._q(xh * ln_s + ln_b, cd)
    _, dgelu = sb._gelu_and_grad(xn @ sb._q(w1, cd).t() + b1)
    dyc = sb._q(dy.float().reshape(B, -1, C) * dp.view(B, 1, 1), cd)
    return (dgelu * (dyc @ sb._q(w2, cd))).reshape(-1, w1.shape[0])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("C", [32, 96])
def test_db1_tile_partials_in_index_order(C, dt):
    """db1 as K2b forms it: a column sum of the f32 dh1 over each 128-token
    tile (the last one ragged; dp changes inside a tile), then the tile
    partials added in index order, against _mlp_pullback's db1."""
    B, grid = 2, 12  # 288 tokens: tiles of 128, 128, 32
    rng = np.random.RandomState(70 + C)
    x, w = _mlp_inputs(rng, B, grid, C)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dp = np.array([1.0, 0.5], np.float32)
    jdt, tdt = DTYPES[dt]
    ref = 0
    for b in range(B):
        ref = ref + _to_np(_mlp_pullback(
            jnp.asarray(x[b].reshape(-1, C), jdt),
            *(jnp.asarray(w[k]) for k in (
                "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")),
            jnp.asarray(dp[b]), jnp.asarray(dy[b].reshape(-1, C), jdt),
            compute_dtype=jdt)[4])

    dh1 = _dh1(torch.from_numpy(x).to(tdt), _torch_mlp_args(w),
               torch.from_numpy(dy).to(tdt), torch.from_numpy(dp))
    T, Ch = dh1.shape
    tiles = -(-T // sb.MLP_TILE)
    padded = torch.zeros(tiles * sb.MLP_TILE, Ch)
    padded[:T] = dh1
    parts = padded.reshape(tiles, sb.MLP_TILE, Ch).sum(1)
    db1 = parts[0].clone()
    for t in range(1, tiles):
        db1 += parts[t]
    err = float(np.abs(db1.numpy() - ref).max())
    assert err <= _leaf_tol(ref, dt, "db1"), (err, _leaf_tol(ref, dt, "db1"))


@pytest.mark.parametrize("C, Ch", [(32, 128), (96, 384), (128, 512),
                                   (160, 640), (192, 768), (256, 1024),
                                   (288, 1152), (384, 1536), (512, 2048),
                                   (640, 2560), (768, 3072), (992, 3968)])
def test_widths_the_kernels_take(C, Ch):
    sb.mlp_kernel_dims(C, Ch, torch.bfloat16)
    if C <= sb.MLP_F32_MAX_C:  # the f32 forward's shared memory
        sb.mlp_kernel_dims(C, Ch, torch.float32)


@pytest.mark.parametrize("C, Ch, dtype", [
    (16, 64, torch.bfloat16),    # below one 32-wide piece
    (48, 192, torch.bfloat16),   # not a multiple of 32
    (272, 1088, torch.bfloat16),  # above 256, not a multiple of 32
    (1024, 4096, torch.bfloat16),  # swin_b stage 3: JAX's XLA branch
    (1056, 4224, torch.bfloat16),  # wider than the JAX kernel takes
    (32, 96, torch.bfloat16),    # a partial hidden chunk
    (2048, 8192, torch.float32),  # beyond the f32 pullback's rows
    (992, 3968, torch.float32),  # beyond the f32 forward's shared memory
])
def test_widths_the_kernels_refuse(C, Ch, dtype):
    with pytest.raises(ValueError, match="MLP kernels"):
        sb.mlp_kernel_dims(C, Ch, dtype)


@pytest.mark.parametrize("T, C, Ch, wide", [(200, 32, 128, False),
                                            (8192, 256, 1024, False),
                                            (147, 640, 2560, True),
                                            (2048, 768, 3072, True)])
def test_fwd_workspace_counts_each_piece(T, C, Ch, wide):
    """K2f's carving, piece by piece (256-byte starts): W1 and W2 in bf16,
    whatever the tokens; above C = 256 also xn [T, C] and h [T, Ch]."""
    pieces = [Ch * C * 2, C * Ch * 2]
    if wide:
        pieces += [T * C * 2, T * Ch * 2]
    off = 0
    for p in pieces:
        off = -(-off // 256) * 256 + p
    assert sb.mlp_fwd_plan(T, C, Ch)["workspace"] == off


def test_f32_forward_widest_c_fits_shared_memory():
    """MLP_F32_MAX_C: the widest C whose 16-token f32 forward block
    (mlp_smem_floats<16, 16>) fits the 232,448 bytes a block may use."""
    def smem(C, TM=16, HC=16):
        return 4 * (2 * TM + C * (TM + 1) + TM * (C + 1) + C * (HC + 1)
                    + HC * (C + 1) + HC * (TM + 1))
    assert smem(sb.MLP_F32_MAX_C) <= 232448 < smem(sb.MLP_F32_MAX_C + 1)
    assert 768 <= sb.MLP_F32_MAX_C < 896


def test_widest_c_matches_the_kernels():
    """MLP_MAX_C, the widest C whose 4C-wide weights fit the JAX kernel's
    budget, is the C side's kMlpMaxC."""
    src = (Path(sb.__file__).resolve().parent.parent / "csrc"
           / "swin_attn_sm90.cuh").read_text()
    assert f"constexpr int kMlpMaxC = {sb.MLP_MAX_C};" in src
    assert sb.mlp_fits_jax_kernel(sb.MLP_MAX_C, 4 * sb.MLP_MAX_C)
    assert not sb.mlp_fits_jax_kernel(sb.MLP_MAX_C + 1,
                                      4 * (sb.MLP_MAX_C + 1))
