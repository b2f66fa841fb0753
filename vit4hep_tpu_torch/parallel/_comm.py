"""Collectives of the parallel layer, with their gradients.

A group is a ``torch.distributed`` process group; ``None`` stands for a
group of one rank, over which every collective is the identity (the JAX
mesh's axis of size 1). Each function of a tensor is a
``torch.autograd.Function`` whose backward is the collective's transpose
when the code downstream is replicated over the group (every rank computes
the same loss from the same replicated values), as in Megatron-LM:

- :func:`all_reduce`: sum forward, identity backward (after a row-parallel
  product; the pipeline's masked output);
- :func:`copy_to`: identity forward, sum backward (before a column-parallel
  product; a replicated input of the ring or the pipeline);
- :func:`all_gather`: concatenation forward, this rank's slice backward;
- :func:`ppermute`: each rank's tensors go ``shift`` ranks on around the
  ring, and the gradients come back the other way (JAX's ``lax.ppermute``).

Transport: NCCL carries device tensors. Gloo carries CUDA tensors for
``all_reduce`` and ``broadcast``; its point-to-point traffic of a CUDA
tensor goes through host copies (:func:`p2p_staged`), a rule of the
backend that :func:`transport` names.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def p2p_staged(group, device) -> bool:
    """True when point-to-point traffic on ``device`` goes through host
    copies: gloo with a CUDA tensor."""
    return torch.device(device).type == "cuda" and dist.get_backend(group) == "gloo"


def transport(group, device) -> str:
    """How :func:`ppermute` moves tensors of ``device`` over ``group``."""
    if group is None:
        return "none (one rank)"
    kind = "host-staged" if p2p_staged(group, device) else "device"
    return f"{dist.get_backend(group)}, {kind}"


def all_reduce_(t, group):
    """Sum ``t`` over ``group`` in place (no gradient); ``t``."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def mean_over(t, group):
    """The mean of ``t`` over ``group`` (no gradient), a new tensor."""
    t = t.detach().clone()
    return all_reduce_(t, group) / size(group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce(x, group):
    """Sum over ``group``; the gradient passes through unchanged."""
    return x if group is None else _AllReduce.apply(x, group)


def copy_to(x, group):
    """``x`` itself; its gradient is summed over ``group``."""
    return x if group is None else _Copy.apply(x, group)


def gather_list(x, group) -> list:
    """Every rank's ``x`` (equal shapes), in rank order (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return parts


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return torch.cat(gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, index(ctx.group) * ctx.n, ctx.n), None, None


def all_gather(x, group, dim=0):
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    gradient of this rank's part is its slice."""
    return x if group is None else _AllGather.apply(x, group, dim)


def exchange(tensors, group, shift):
    """Send each tensor to the rank ``shift`` ahead on ``group``'s ring and
    receive the one of the rank ``shift`` behind (no gradient)."""
    n, r = size(group), index(group)
    if n == 1 or shift % n == 0:
        return [t.detach().clone() for t in tensors]
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    staged = p2p_staged(group, tensors[0].device)
    ops, received = [], []
    for t in tensors:
        send = t.detach().contiguous()
        if staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]
        received.append(recv)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(t.device) for r, t in zip(received, tensors)]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        return tuple(exchange(tensors, group, shift))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *exchange(grads, ctx.group, -ctx.shift))


def ppermute(tensors, group, shift=1) -> tuple:
    """``tensors`` moved ``shift`` ranks on around ``group``'s ring (one
    exchange for all of them); their gradients move back. Every rank of
    the group must call it with the same shapes, and use every output, so
    that every rank's backward runs the same exchanges."""
    if group is None:
        return tuple(tensors)
    return _PPermute.apply(group, shift, *tensors)
