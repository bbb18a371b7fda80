"""The collectives the port's multi-rank paths run, as autograd Functions
where gradients must cross ranks.

- :func:`all_reduce_sum`: ``all_reduce(SUM)`` of several tensors packed in
  one vector, forward and backward, for values every rank's loss depends on
  (the cross-rank BatchNorm statistics).
- :func:`copy_to_group` / :func:`gather_channels`: the two halves of a
  column-parallel layer (Megatron's ``f`` and ``g``). The input is used as it
  is and its gradient summed over the model group; the rank's output channels
  are all-gathered into the full channel axis and the gradient of the full
  output is sliced back to the rank's channels.
- :func:`mean_grads_` averages gradients and losses over a group in one
  flat bucket.

With ``group=None`` (a world of one without a process group) every function
is the identity. Tensors stay where they are: NCCL takes CUDA tensors, gloo
CPU tensors and, for ``all_reduce`` and ``broadcast``, CUDA ones; nothing here
copies a tensor to the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "copy_to_group", "gather_channels", "mean_grads_", "broadcast_", "p2p"]


def _packed_all_reduce(tensors, group) -> List[torch.Tensor]:
    """``tensors`` summed over the group in one ``all_reduce`` of one flat
    vector, unpacked to their shapes (views of that vector)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(_packed_all_reduce(xs, group))

    @staticmethod
    def backward(ctx, *dys):
        return (None, *_packed_all_reduce(dys, ctx.group))


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each of ``tensors`` (one dtype) summed over the group's ranks, in one
    packed ``all_reduce``; the gradient of every rank's outputs flows back to
    every rank's inputs (one packed all_reduce SUM backward)."""
    if group is None:
        return list(tensors)
    return list(_AllReduceSum.apply(group, *tensors))


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, dx):
        dx = dx.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity forward; backward sums the input's gradient over the
    group (each rank's channels contributed one part of it)."""
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, index, size):
        ctx.index, ctx.size = index, size
        y = y.contiguous()
        out = torch.empty((size * y.shape[0],) + y.shape[1:], dtype=y.dtype, device=y.device)
        dist.all_gather_into_tensor(out, y, group=group)
        # (size, ..., c) -> (..., size, c)
        out = out.reshape((size,) + y.shape).movedim(0, -2)
        return out.reshape(y.shape[:-1] + (size * y.shape[-1],))

    @staticmethod
    def backward(ctx, dy):
        c = dy.shape[-1] // ctx.size
        return dy[..., ctx.index * c:(ctx.index + 1) * c].contiguous(), None, None, None


def gather_channels(y: torch.Tensor, group, index: int, size: int) -> torch.Tensor:
    """All-gather the last (channel) axis over the group: rank ``index``
    holds channels ``[index * c, (index + 1) * c)``. Backward keeps this
    rank's slice of the gradient."""
    if group is None:
        return y
    return _GatherChannels.apply(y, group, index, size)


def mean_grads_(params: Sequence[torch.Tensor], losses: Sequence[torch.Tensor],
                group) -> List[torch.Tensor]:
    """Average the gradients of ``params`` (those that have one) and the
    scalar ``losses`` over the group in one flat ``all_reduce`` (in the
    gradients' dtype) and write the gradients back; returns the averaged
    losses, detached, each in its own dtype (``group`` None: as given)."""
    losses = [l.detach() for l in losses]
    if group is None:
        return losses
    params = [p for p in params if p.grad is not None]
    dtype = params[0].grad.dtype if params else losses[0].dtype
    parts = [p.grad for p in params] + [l.reshape(1).to(dtype) for l in losses]
    flat = torch.cat([t.reshape(-1) for t in parts])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    at = 0
    for p in params:
        p.grad = flat[at:at + p.grad.numel()].view_as(p.grad)
        at += p.grad.numel()
    return [flat[at + i].to(l.dtype) for i, l in enumerate(losses)]


def broadcast_(tensors: Sequence[torch.Tensor], src: int, group=None) -> None:
    """Broadcast ``tensors`` in place from global rank ``src``."""
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def p2p(sends, recvs, group: Optional[object]) -> None:
    """Post the ``(tensor, global peer rank)`` sends and receives together
    and wait for all of them."""
    ops = [dist.P2POp(dist.isend, t, peer, group) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
