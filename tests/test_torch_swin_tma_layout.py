"""The host side of the bf16 K1 kernels (``ops/swin_block.py``), on CPU
tensors: the rank-4 TMA map of a [B, Hp, Wp, C] grid with its window box
(``window_tma_layout``, the geometry ``csrc/sm90_gemm.cuh``
``make_map_window`` encodes) and what it refuses; the head groups of the
window kernels (``head_groups``: group g's [q | k | v] is three 64-wide
boxes at p C + 64 g of Wqkv's rows or qkv's channels); the token slots of
K1b's split-K weight gradients (``split_k_plan``). The head groups and the
slot plan are held against the plain forward and backward, so that a wrong
one fails here and not only on the card."""

import math

import numpy as np
import pytest
import torch

from fmc_uia_tpu_torch.models.encoders.swin import (
    _relative_position_index,
    block_attn_mask,
)
from fmc_uia_tpu_torch.ops import swin_block as sb


@pytest.mark.parametrize("B, Hp, Wp, C, ws", [
    (2, 16, 16, 128, 8),   # stage 0's width; also the padded grid 12 -> 16
    (24, 64, 64, 256, 8),  # stage 1 at the train batch
    (1, 56, 56, 96, 7),    # window 7: 49 rows of a 64-row tile
    (3, 8, 8, 1024, 8),    # stage 3's width
])
def test_window_box_of_a_grid(B, Hp, Wp, C, ws):
    x = torch.zeros((B, Hp, Wp, C), dtype=torch.bfloat16)
    dims, strides, box = sb.window_tma_layout(x, ws)
    assert dims == (C, Wp, Hp, B)
    assert strides == (2 * C, 2 * C * Wp, 2 * C * Wp * Hp)
    assert box == (64, ws, ws, 1)
    # the recomputed qkv of K1b: the same grid, 3C channels
    qkv = torch.zeros((B, Hp, Wp, 3 * C), dtype=torch.bfloat16)
    assert sb.window_tma_layout(qkv, ws)[1][0] == 6 * C


def test_window_rows_are_the_window_tokens():
    """The box at (c0, x0, y0, b) lists the window's tokens row-major, as
    the reference's window partition does."""
    B, Hp, Wp, C, ws = 2, 14, 21, 8, 7
    x = torch.arange(B * Hp * Wp, dtype=torch.float32).reshape(
        B, Hp, Wp, 1).expand(B, Hp, Wp, C)
    wins = sb._windows(x, ws)[..., 0]  # [B, nW, N]
    nWw = Wp // ws
    for b in range(B):
        for wi in range(wins.shape[1]):
            y0, x0 = (wi // nWw) * ws, (wi % nWw) * ws
            box = x[b, y0:y0 + ws, x0:x0 + ws, 0].reshape(-1)
            assert torch.equal(box, wins[b, wi])


def test_views_tma_cannot_read_are_refused():
    ok = torch.zeros((2, 16, 16, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        sb.window_tma_layout(ok.float(), 8)
    with pytest.raises(ValueError, match="channel stride"):
        sb.window_tma_layout(ok.permute(0, 1, 3, 2)[..., :16], 8)
    flat = torch.zeros(ok.numel() + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sb.window_tma_layout(flat[1:].view(ok.shape), 8)
    with pytest.raises(ValueError, match="Wp stride of 200 bytes"):
        sb.window_tma_layout(torch.zeros((2, 16, 16, 100),
                                         dtype=torch.bfloat16), 8)
    with pytest.raises(ValueError, match="do not tile"):
        sb.window_tma_layout(torch.zeros((2, 12, 12, 128),
                                         dtype=torch.bfloat16), 8)
    with pytest.raises(ValueError, match=r"\[B, Hp, Wp, C\]"):
        sb.window_tma_layout(ok[0], 8)
    with pytest.raises(ValueError, match="head dim 8"):
        sb.head_groups(128, 16)


def _group_rows(C, H):
    """The row of Wqkv (or channel of qkv) behind each column of the window
    kernel's [q | k | v] tile of each head group: three 64-wide boxes at
    p C + 64 g (p = 0, 1, 2); -1 where a box runs past 3C (TMA reads
    zeros there). int64 [groups, 192]."""
    _, groups = sb.head_groups(C, H)
    g, p, i = torch.meshgrid(torch.arange(groups), torch.arange(3),
                             torch.arange(64), indexing="ij")
    src = p * C + 64 * g + i
    return torch.where(src < 3 * C, src, -1).reshape(groups, 192)


@pytest.mark.parametrize("C, H", [(128, 4), (256, 8), (512, 16),
                                  (1024, 32), (96, 3), (128, 8), (48, 3)])
def test_head_group_boxes(C, H):
    """The columns of the real heads of every group hold each row of Wqkv
    exactly once, as q, k or v of that head."""
    G, groups = sb.head_groups(C, H)
    dh = C // H
    assert G * dh == 64 and groups == -(-H // G)
    src = _group_rows(C, H)
    used = []
    for g in range(groups):
        for j in range(192):
            p, i = j // 64, j % 64
            head = g * G + i // dh
            if head < H:
                assert int(src[g, j]) == p * C + head * dh + i % dh
                used.append(int(src[g, j]))
    assert sorted(used) == list(range(3 * C))


def _inputs(B, grid, C, H, ws, shift, seed):
    g = torch.Generator().manual_seed(seed)
    hp = -(-grid // ws) * ws
    N = ws * ws
    x = torch.randn(B, hp, hp, C, generator=g)
    table = torch.randn((2 * ws - 1) ** 2, H, generator=g) * 0.02
    idx = torch.as_tensor(_relative_position_index(ws).reshape(-1))
    bias = table[idx].reshape(N, N, H).permute(2, 0, 1).contiguous()
    m = block_attn_mask(grid, grid, ws, shift)
    mask = None if m is None else torch.as_tensor(m)
    w = dict(ln_scale=1 + 0.1 * torch.randn(C, generator=g),
             ln_bias=0.1 * torch.randn(C, generator=g),
             wqkv=torch.randn(3 * C, C, generator=g) * C ** -0.5,
             bqkv=0.02 * torch.randn(3 * C, generator=g),
             wproj=torch.randn(C, C, generator=g) * C ** -0.5,
             bproj=0.02 * torch.randn(C, generator=g), bias_hnn=bias)
    dy = torch.randn(x.shape, generator=g)
    return x, w, mask, dy


def _branch_on_groups(x, w, wqkv, mask, H, ws):
    """K1f's dataflow in f32 on the CPU: xn = LN1(x) on the grid, each head
    group's tile [q | k | v] = xn W_g^T + b_g from the rows ``_group_rows``
    names (the bias 0 past channel C, as the kernel adds it), per head of
    each group the windowed attention, o in the grid layout, then proj and
    the residual (dp = 1). Differentiable in wqkv."""
    B, Hp, Wp, C = x.shape
    dh = C // H
    G, groups = sb.head_groups(C, H)
    src = _group_rows(C, H)
    real = (src >= 0)[..., None]
    w_g = torch.where(real, wqkv[src.clamp_min(0)], torch.zeros(()))
    ch = 64 * torch.arange(groups)[:, None] + torch.arange(192) % 64
    b_g = torch.where(ch < C, w["bqkv"][src.clamp_min(0)], torch.zeros(()))
    xh, _ = sb._ln_stats(x)
    xn = xh * w["ln_scale"] + w["ln_bias"]
    tiles = (torch.einsum("bhwc,gjc->bhwgj", xn, w_g) + b_g).reshape(
        B, Hp, Wp, groups, 3, 64)
    outs = []
    for g in range(groups):
        for hl in range(G):
            head = g * G + hl
            if head >= H:
                continue
            q, k, v = (sb._windows(tiles[:, :, :, g, p,
                                         hl * dh:(hl + 1) * dh], ws)
                       for p in range(3))
            s = (q * dh ** -0.5) @ k.transpose(-1, -2)
            s = s + w["bias_hnn"][head]
            if mask is not None:
                s = s + mask
            outs.append(sb._unwindows(torch.softmax(s, -1) @ v, ws, Hp, Wp))
    o = torch.cat(outs, dim=-1)
    return x + o @ w["wproj"].t() + w["bproj"], o


@pytest.mark.parametrize("C, H, grid, ws, shift", [
    (64, 2, 16, 8, 4), (64, 4, 16, 8, 0), (96, 3, 14, 7, 3)])
def test_head_groups_against_the_plain_branch(C, H, grid, ws, shift):
    x, w, mask, dy = _inputs(2, grid, C, H, ws, shift, seed=C + H)
    wqkv = w["wqkv"].clone().requires_grad_()
    args = (w["ln_scale"], w["ln_bias"], w["wqkv"], w["bqkv"], w["wproj"],
            w["bproj"], w["bias_hnn"], mask, H)
    out, _ = _branch_on_groups(x, w, wqkv, mask, H, ws)
    ref = sb.attention_branch_reference(x, *args)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    # dWqkv through the group tiles, in Wqkv's own row order
    (dw,) = torch.autograd.grad(out, wqkv, dy)
    dwqkv = sb.attention_branch_backward_reference(x, *args, dy)[3]
    torch.testing.assert_close(dw, dwqkv, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("M, N, K", [
    (128, 128, 393216), (384, 128, 393216), (512, 512, 24576),
    (1536, 512, 24576), (3072, 1024, 6144), (96, 96, 49), (288, 96, 6272),
    (1024, 1024, 1000)])
def test_split_k_slots_cover_every_token_once_in_order(M, N, K):
    kchunk, slots = sb.split_k_plan(M, N, K)
    assert kchunk % sb.GEMM_K == 0 and kchunk >= sb.GEMM_K
    tiles = math.ceil(M / sb.GEMM_M) * math.ceil(N / sb.GEMM_N)
    assert slots == 1 or slots * tiles <= sb.SPLIT_TILES
    bounds = [(z * kchunk, min(K, (z + 1) * kchunk)) for z in range(slots)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    for (a0, a1), (b0, b1) in zip(bounds, bounds[1:]):
        assert a1 == b0
    assert all(a0 < a1 for a0, a1 in bounds)
    # partials of 4 bytes per element within 16 MB (or the output's size)
    assert slots * M * N * 4 <= max(16 << 20, M * N * 4)


def test_slot_sums_against_the_plain_backward(monkeypatch):
    """dWproj = dyf^T o as the kernel sums it (per-slot partials over the
    grid's token rows, slots added in index order) against the plain
    backward's, with slots small enough that there are several."""
    monkeypatch.setattr(sb, "SPLIT_MIN_K", 64)
    C, H, ws = 64, 2, 8
    x, w, mask, dy = _inputs(2, 16, C, H, ws, 4, seed=7)
    _, o = _branch_on_groups(x, w, w["wqkv"], mask, H, ws)
    T = o.shape[0] * o.shape[1] * o.shape[2]
    kchunk, slots = sb.split_k_plan(C, C, T)
    assert slots > 1
    dyf, of = dy.reshape(T, C), o.reshape(T, C)
    parts = [dyf[z * kchunk:(z + 1) * kchunk].t()
             @ of[z * kchunk:(z + 1) * kchunk] for z in range(slots)]
    total = torch.zeros(C, C)
    for p in parts:
        total = total + p
    args = (w["ln_scale"], w["ln_bias"], w["wqkv"], w["bqkv"], w["wproj"],
            w["bproj"], w["bias_hnn"], mask, H)
    dwproj = sb.attention_branch_backward_reference(x, *args, dy)[5]
    torch.testing.assert_close(total, dwproj, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        np.diff([z * kchunk for z in range(slots)] + [T]) > 0, True)
