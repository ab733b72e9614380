"""Pipeline parallelism: GPipe over the ``pipe`` ranks (port of
``fmc_uia_tpu/parallel/pipeline.py``).

The S stages live one a rank along the ``pipe`` axis. Rank 0 takes the M
microbatches in turn; each rank applies its stage and sends the result
to the next rank (point-to-point ``send``/``recv``); rank S-1 collects
the outputs, which are then broadcast, so every rank holds them, as
JAX's ``psum`` replicates them. All forwards run first, then all
backwards (GPipe): the backward receives each microbatch's output
gradient from the next rank in reverse order and sends its input
gradient to the previous one. The bubble is the usual (S-1)/(M+S-1).

Every stage must map an activation of one shape and dtype to the same
(a uniform pipeline): for Swin this splits one resolution stage's
blocks, not the patch-merging boundaries.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from fmc_uia_tpu_torch.parallel import comm
from fmc_uia_tpu_torch.parallel.mesh import resolve_group


def stack_stage_params(params_list: Sequence[Dict]) -> Dict:
    """Identically structured per-stage {name: tensor} dicts stacked along
    a new leading stage axis."""
    return {k: torch.stack([p[k] for p in params_list])
            for k in params_list[0]}


def shard_stage_params(stacked: Dict, mesh, axis: str = "pipe") -> Dict:
    """This rank's ``[1, ...]`` block of stage-stacked params."""
    group = resolve_group(mesh, axis)
    r = comm.group_rank(group)
    return {k: v[r:r + 1] for k, v in stacked.items()}


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, group, x_mb, *params):
        S, r = comm.group_size(group), comm.group_rank(group)
        M = x_mb.shape[0]
        like = x_mb[0]
        ctx.group, ctx.params = group, params
        ctx.inputs, ctx.outputs = [], []
        out = torch.zeros_like(x_mb)
        with torch.enable_grad():
            for m in range(M):
                inp = (x_mb[m] if r == 0 else comm.recv(like, r - 1, group)
                       ).detach().requires_grad_(True)
                y = stage_fn(list(params), inp)
                ctx.inputs.append(inp)
                ctx.outputs.append(y)
                if r < S - 1:
                    comm.send(y.detach(), r + 1, group)
                else:
                    out[m] = y.detach()
        return comm.broadcast_(out, S - 1, group)

    @staticmethod
    def backward(ctx, grad_out):
        group, params = ctx.group, ctx.params
        S, r = comm.group_size(group), comm.group_rank(group)
        M = grad_out.shape[0]
        like = grad_out[0]
        dx = torch.zeros_like(grad_out)
        pgrads: List = [None] * len(params)
        for m in reversed(range(M)):
            gy = (grad_out[m] if r == S - 1
                  else comm.recv(like, r + 1, group))
            grads = torch.autograd.grad(
                ctx.outputs[m], [ctx.inputs[m]] + list(params), gy,
                allow_unused=True)
            for i, g in enumerate(grads[1:]):
                if g is not None:
                    pgrads[i] = g if pgrads[i] is None else pgrads[i] + g
            if r > 0:
                comm.send(grads[0], r - 1, group)
            else:
                dx[m] = grads[0]
        ctx.inputs = ctx.outputs = None
        dx = comm.broadcast_(dx, 0, group)
        return (None, None, dx, *pgrads)


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches,
                   mesh, axis: str = "pipe"):
    """Run the S pipeline stages over M microbatches.

    Args:
      stage_fn: ``(params, x) -> y`` with y of x's shape and dtype;
        ``params`` is the list ``stage_params`` gives this rank.
      stage_params: this rank's stage parameters: a list of tensors, or a
        {name: tensor} dict whose leaves carry a leading stage dim of S
        (every stage, sliced here; the gradient is gathered back, so it
        is whole on every rank) or of 1 (``shard_stage_params``).
      x_microbatches: ``[M, mb, ...]``, the same on every rank.
      mesh: a DeviceMesh holding ``axis`` (or that axis's process group).

    Returns ``[M, mb, ...]`` outputs on every rank; differentiable.
    """
    group = resolve_group(mesh, axis)
    if group is None:
        raise ValueError(f"pipeline_apply needs a mesh with axis {axis!r}")
    if isinstance(stage_params, dict):
        S = comm.group_size(group)
        local = []
        for v in stage_params.values():
            if v.shape[0] == S and S > 1:
                v = comm.slice_dim(v, 0, group)
            elif v.shape[0] != 1:
                raise ValueError(f"stage-stacked leaf of {v.shape[0]} "
                                 f"stages over a pipe axis of {S}")
            local.append(v[0])
        params = local
        fn = stage_fn
        keys = list(stage_params)

        def stage_fn(ps, x):  # noqa: F811 - the dict view for the caller
            return fn(dict(zip(keys, ps)), x)
    else:
        params = list(stage_params)
    return _GPipe.apply(stage_fn, group, x_microbatches, *params)


def pipeline_swin_stage(encoder, stage: int, x: torch.Tensor, mesh,
                        microbatches: int, axis: str = "pipe"
                        ) -> torch.Tensor:
    """One Swin stage's (window, shifted-window) block pairs split over
    the ``pipe`` ranks (e.g. swin_b's 18-block stage 2: 9 pairs, 3 a rank
    over 3 ranks), ``microbatches`` microbatches GPipe-style. Drop path is
    off (the blocks run in eval mode); gradients flow to each rank's
    blocks and to ``x``. ``x`` is the stage input ``[B, H, W, C]`` (after
    patch merging), the same on every rank; the result equals the
    sequential stage."""
    depth = encoder.depths[stage]
    blocks = [getattr(encoder, f"stage{stage}_block{b}")
              for b in range(depth)]
    group = resolve_group(mesh, axis)
    S, r = comm.group_size(group), comm.group_rank(group)
    n_pairs = depth // 2
    if depth % 2 or n_pairs % S:
        raise ValueError(f"n_pairs {n_pairs} must divide over pipe axis "
                         f"size {S}")
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} must divide into {microbatches} "
                         f"microbatches")
    k = 2 * n_pairs // S
    mine = blocks[r * k:(r + 1) * k]
    params = [p for b in mine for p in b.parameters()]

    def stage_fn(ps, xx):
        for b in mine:
            xx = b(xx, False)
        return xx

    x_mb = x.reshape((microbatches, B // microbatches) + tuple(x.shape[1:]))
    return pipeline_apply(stage_fn, params, x_mb, group).reshape(x.shape)


def pipeline_loss_fn(stage_fn: Callable, loss_fn: Callable, mesh,
                     axis: str = "pipe"):
    """``(stage_params, x_mb, y_mb) -> loss_fn(pipeline_apply(...),
    y_mb)``, differentiable w.r.t. the stage params."""

    def fn(stage_params, x_mb, y_mb):
        out = pipeline_apply(stage_fn, stage_params, x_mb, mesh, axis)
        return loss_fn(out, y_mb)

    return fn
