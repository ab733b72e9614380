"""The host side of the bf16 K4 kernels' TMA maps, on CPU tensors:
``tma_layout`` gives the (dh, N, H, B) dims and the byte strides of N, H
and B that ``csrc/vit_flash_sm90.cuh`` ``make_map`` encodes, and refuses
what TMA cannot take; ``tma_ready`` passes a readable view through
untouched (no copy) and copies the rest. The views are those the kernels
meet: q, k and v as column slices of the qkv projection, the contiguous
[B, N, H, dh] that RoPE gives, autograd's cotangent of the [B, N, H, dh]
output, and misaligned slices."""

import pytest
import torch

from fmc_uia_tpu_torch.ops import vit_attention as va

B, N, H, DH = 2, 37, 12, 64
C = H * DH


def _bhnd(x):
    """[B, N, H, dh] -> the [B, H, N, dh] view the kernels take."""
    return x.permute(0, 2, 1, 3)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_qkv_column_slice(i):
    qkv = torch.zeros((B, N, 3, H, DH), dtype=torch.bfloat16)
    t = _bhnd(qkv[:, :, i])
    dims, strides = va.tma_layout(t)
    assert dims == (DH, N, H, B)
    # n: one token of qkv (3C elements); h: one head; b: one image
    assert strides == (3 * C * 2, DH * 2, N * 3 * C * 2)
    assert va.tma_ready(t).data_ptr() == t.data_ptr()


def test_rope_output_bnhd():
    t = _bhnd(torch.zeros((B, N, H, DH), dtype=torch.bfloat16))
    assert va.tma_layout(t) == ((DH, N, H, B), (C * 2, DH * 2, N * C * 2))
    assert va.tma_ready(t) is t


def test_contiguous_bhnd_f32():
    t = torch.zeros((B, H, N, DH))
    assert va.tma_layout(t) == ((DH, N, H, B),
                                (DH * 4, N * DH * 4, H * N * DH * 4))


def test_autograd_cotangent_of_the_output():
    """The block reshapes o [B, H, N, dh] (a [B, N, H, dh] tensor) back to
    [B, N, C]; autograd hands K4b ``do`` as that layout, which TMA takes
    as it lies. A cotangent broadcast from a scalar has stride 0 and is
    copied."""
    o = _bhnd(torch.zeros((B, N, H, DH), dtype=torch.bfloat16))
    o.requires_grad_()
    seen = []
    o.register_hook(lambda g: seen.append(g))
    (o.transpose(1, 2).reshape(B, N, C).float() * 2).sum().backward()
    (do,) = seen
    dims, strides = va.tma_layout(do)
    assert dims == (DH, N, H, B)
    ones = torch.ones((), dtype=torch.bfloat16).expand(B, H, N, DH)
    with pytest.raises(ValueError, match="last axis"):
        va.tma_layout(ones)
    copy = va.tma_ready(ones)
    assert copy.is_contiguous() and torch.equal(copy, ones)


def test_misaligned_base_is_copied():
    flat = torch.zeros(B * H * N * DH + 1, dtype=torch.bfloat16)
    t = flat[1:].view(B, H, N, DH)  # contiguous, base 2 bytes off
    assert t.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        va.tma_layout(t)
    copy = va.tma_ready(t)
    assert copy.data_ptr() != t.data_ptr() and copy.data_ptr() % 16 == 0
    assert torch.equal(copy, t)
    va.tma_layout(copy)


def test_row_stride_off_16_bytes_is_copied():
    t = torch.zeros((B, H, N, DH + 1), dtype=torch.bfloat16)[..., :DH]
    with pytest.raises(ValueError, match="n stride of 130 bytes"):
        va.tma_layout(t)
    copy = va.tma_ready(t)
    assert va.tma_layout(copy)[1] == (DH * 2, N * DH * 2, H * N * DH * 2)
    assert torch.equal(copy, t)


def test_wrong_rank_is_refused():
    with pytest.raises(ValueError, match=r"\[B, H, N, dh\]"):
        va.tma_layout(torch.zeros((N, DH), dtype=torch.bfloat16))
