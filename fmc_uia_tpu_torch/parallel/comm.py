"""The port's collectives: what GSPMD inserts for free in the JAX package.

Three kinds of operation live here:

  * **Differentiable collectives for a replicated loss.** Under a mesh
    every rank of a group computes the same loss from the group's summed
    statistics, so the cotangent that reaches a collective is already the
    whole one on each rank. ``sum_pass`` (all-reduce forward) therefore
    passes the gradient through unchanged, where
    ``torch.distributed.nn.functional.all_reduce`` would sum it again and
    give W times the gradient. Its Megatron dual ``copy_sum_grad``
    (identity forward, all-reduce backward) sits at the input of a
    column-parallel product; ``gather_dim`` (all-gather forward, this
    rank's slice backward) and ``slice_dim`` (slice forward, all-gather
    backward) move between a shard and the whole; ``all_to_all`` is its
    own adjoint.
  * **Gradient sums** over the data axis, one flat buffer per dtype
    (``all_reduce_flat``), and ZeRO-1's ``reduce_scatter_dim``.
  * **The batch scope** (``batch_scope``): the group whose sums make a loss
    global and the rows (start, stop, total) of the global batch this rank
    holds. The losses call ``global_sum`` / ``global_count``; the random
    draws of augmentation, drop path and dropout call ``rand`` /
    ``randn`` / ``randint``, which draw the *global* batch's values from
    the shared generator and keep this rank's rows, so W ranks draw what
    one process draws. Without a scope each is the identity (or the plain
    draw), and single-process numbers do not move.

Gloo (the one backend that runs several ranks on one card) runs the
collectives on CUDA tensors but aborts on point-to-point send/recv from
device memory, so ``send`` / ``recv`` move CUDA tensors through host
memory under gloo; the first use prints one line. Under NCCL nothing is
copied.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_NOTED = set()  # "send_recv" once gloo has copied it through host memory
# (group, (start, stop, total)) of the installed batch scope, or None
_SCOPE: Optional[Tuple] = None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _via_host(t: torch.Tensor, group) -> bool:
    """Whether send/recv of ``t`` goes through host memory: a CUDA tensor
    under gloo."""
    if not t.is_cuda or dist.get_backend(group) != "gloo":
        return False
    if "send_recv" not in _NOTED:
        _NOTED.add("send_recv")
        print("[comm] gloo: send_recv on CUDA tensors goes through host "
              "memory", flush=True)
    return True


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------
def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group``."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in group-rank order."""
    if group is None:
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def broadcast_(t: torch.Tensor, src_group_rank: int, group) -> torch.Tensor:
    if group is not None:
        dist.broadcast(t, src=dist.get_global_rank(group, src_group_rank),
                       group=group)
    return t


def all_to_all_dim0(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` [W * n, ...]: block j goes to group rank j; block j of the
    result came from group rank j."""
    if group is None:
        return t
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    all_to_all_dim0.calls += 1
    return out


all_to_all_dim0.calls = 0  # the expert dispatch's count (chip_smoke.py)


def send(t: torch.Tensor, dst_group_rank: int, group) -> None:
    dst = dist.get_global_rank(group, dst_group_rank)
    src = t.contiguous()
    if _via_host(src, group):
        src = src.cpu()
    dist.send(src, dst=dst, group=group)


def recv(like: torch.Tensor, src_group_rank: int, group) -> torch.Tensor:
    src = dist.get_global_rank(group, src_group_rank)
    host = _via_host(like, group)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if host else like.device)
    dist.recv(buf, src=src, group=group)
    return buf.to(like.device) if host else buf


def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place, through one flat buffer
    per dtype (one collective per dtype, not one per tensor)."""
    if group is None or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group)
        torch._foreach_copy_(ts, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in ts]), ts)])


# (newer torch names it reduce_scatter_single)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the ranks' ``t``."""
    k = t.shape[dim] // group_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((k,) + src.shape[1:], dtype=t.dtype, device=t.device)
    _reduce_scatter(out, src, group=group)
    return out.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# differentiable collectives (the cotangent is replicated over the group)
# ---------------------------------------------------------------------------
class _SumPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopySumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        k = x.shape[dim] // group_size(group)
        return x.narrow(dim, group_rank(group) * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_dim0(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_dim0(g, ctx.group), None


def sum_pass(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the backward passes the gradient unchanged."""
    return x if group is None else _SumPass.apply(x, group)


def copy_sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``group``."""
    return x if group is None else _CopySumGrad.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' shards concatenated along ``dim``; backward: this
    rank's slice of the (replicated) gradient."""
    return x if group is None else _Gather.apply(x, dim, group)


def slice_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``; backward:
    the ranks' gradient blocks gathered, so the whole gradient is
    replicated again."""
    return x if group is None else _Slice.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_dim0``, differentiable (its own adjoint)."""
    return x if group is None else _AllToAll.apply(x, group)


# ---------------------------------------------------------------------------
# the batch scope: global loss statistics and per-row draws
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def batch_scope(group, rows: Tuple[int, int, int]):
    """Inside, ``global_sum`` sums over ``group`` and the per-row draws
    cover the global batch's ``rows[2]`` rows, of which this rank holds
    ``rows[0]:rows[1]``. Restores the previous scope on exit."""
    global _SCOPE
    prev = _SCOPE
    _SCOPE = (group, tuple(int(v) for v in rows))
    try:
        yield
    finally:
        _SCOPE = prev


def _whole_batch() -> bool:
    """No scope, or this rank holds every row: nothing to sum."""
    return _SCOPE is None or _SCOPE[1][1] - _SCOPE[1][0] == _SCOPE[1][2]


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the scope's group (the identity outside one, and
    where this rank holds the whole batch)."""
    return x if _whole_batch() else sum_pass(x, _SCOPE[0])


def global_count(n_local: int, rows_local: int) -> float:
    """The global count of elements of which this rank holds ``n_local``
    in ``rows_local`` rows (the batches' rows split evenly)."""
    if _whole_batch():
        return float(n_local)
    start, stop, total = _SCOPE[1]
    if rows_local != stop - start:
        raise ValueError(f"{rows_local} rows, the batch scope holds "
                         f"{stop - start}")
    return float(n_local // rows_local * total)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` (leading dim: the batch) over the global batch."""
    if _whole_batch():
        return x.mean()
    return global_sum(x.sum()) / global_count(x.numel(), x.shape[0])


def global_mean0(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading (batch) dim of the global batch."""
    if _whole_batch():
        return x.mean(dim=0)
    return global_sum(x.sum(dim=0)) / global_count(x.shape[0], x.shape[0])


def _draw(fn, shape):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if _SCOPE is None:
        return fn(shape)
    start, stop, total = _SCOPE[1]
    if shape[0] != stop - start:
        raise ValueError(f"a per-row draw of {shape[0]} rows, the batch "
                         f"scope holds {stop - start}")
    return fn((total,) + shape[1:])[start:stop]


def rand(shape, generator, device) -> torch.Tensor:
    return _draw(lambda s: torch.rand(s, generator=generator,
                                      device=device), shape)


def randn(shape, generator, device) -> torch.Tensor:
    return _draw(lambda s: torch.randn(s, generator=generator,
                                       device=device), shape)


def randint(low: int, high: int, shape, generator, device,
            dtype=torch.int64) -> torch.Tensor:
    return _draw(lambda s: torch.randint(low, high, s, generator=generator,
                                         device=device, dtype=dtype), shape)


class StopVote:
    """A flag (SIGTERM) agreed by every rank of ``group`` with no device
    sync: each call starts a non-blocking all-reduce of this rank's flag
    on a host (gloo) group and answers with the vote the call before
    started. Every rank makes the same calls, so all stop at the same
    batch boundary, one batch after the first rank saw the flag. Without
    a group the answer is the flag itself."""

    def __init__(self, group):
        if group is not None and dist.get_backend(group) != "gloo":
            group = dist.new_group(dist.get_process_group_ranks(group),
                                   backend="gloo")
        self.group = group
        self._pending = None  # (work, tensor) of the vote in flight

    def __call__(self, flag: bool) -> bool:
        if self.group is None:
            return flag
        t = torch.tensor([1.0 if flag else 0.0])
        work = dist.all_reduce(t, group=self.group, async_op=True)
        prev, self._pending = self._pending, (work, t)
        if prev is None:
            return False
        prev[0].wait()
        return bool(prev[1].item() > 0)


def broadcast_object(obj, group):
    """Rank 0's picklable ``obj`` on every rank of ``group``."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def gather_objects(obj, group) -> List:
    """Every rank's picklable ``obj``, in group-rank order."""
    if group is None:
        return [obj]
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
