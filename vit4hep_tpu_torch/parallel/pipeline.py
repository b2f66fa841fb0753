"""GPipe pipeline parallelism over a process group (port of
``vit4hep_tpu/parallel/pipeline.py``).

The transformer stack is cut into ``n_stages`` equal stages, one per rank
of the group, and each rank holds only its stage's blocks. The batch is
split into microbatches that stream through the stages: the schedule runs
``n_micro + n_stages - 1`` ticks, and on each tick every stage applies its
blocks to what it holds and the activations move one stage on
(``_comm.ppermute``, whose backward sends the gradients back). Stage 0
takes microbatch ``t`` on tick ``t``; the last stage stores the microbatch
that leaves it, and its outputs reach every rank by a masked all-reduce
(JAX ``:57-135``). Every stage computes on every tick, as in JAX, so that
each rank's graph, and with it its backward's exchanges, is the same.
Gradients flow through the schedule: a stage's parameters get the
gradients of its blocks, and the replicated inputs those summed over the
stages.

Parameters are trees of tensors (dicts, as JAX's), and ``block_fn(params,
x, *ctx) -> x`` applies one block (``torch.func.functional_call`` turns a
module into one).
"""

from __future__ import annotations

import torch

from vit4hep_tpu_torch.parallel import _comm


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_stage_params(per_block_params: list, n_stages: int):
    """Per-block trees (``depth`` of them, one structure) stacked into one
    tree of leaves (n_stages, blocks_per_stage, ...)."""
    depth = len(per_block_params)
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by n_stages {n_stages}")
    return _tree_map(lambda *xs: torch.stack(xs).reshape(n_stages, depth // n_stages,
                                                         *xs[0].shape), *per_block_params)


def _leading(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _stage_apply(block_fn, stage_params, x, *ctx):
    """This stage's blocks (leading axis of ``stage_params``) in order."""
    for i in range(_leading(stage_params)):
        x = block_fn(_tree_map(lambda a, i=i: a[i], stage_params), x, *ctx)
    return x


def spmd_pipeline(block_fn, stage_params, x_mb, *ctx, group=None):
    """Run microbatches through the pipeline on every rank of ``group``.

    stage_params: this rank's (blocks_per_stage, ...) tree.
    x_mb: (n_micro, mb, ...) microbatches, the same on every rank.
    ctx: extra per-microbatch inputs, each (n_micro, mb, ...).
    Returns the (n_micro, mb, ...) outputs on every rank."""
    n_stages, stage = _comm.size(group), _comm.index(group)
    n_micro = x_mb.shape[0]
    x_mb = _comm.copy_to(x_mb, group)
    ctx = [_comm.copy_to(c, group) for c in ctx]
    last = stage == n_stages - 1
    act = torch.zeros_like(x_mb[0])
    outs = [None] * n_micro
    n_ticks = n_micro + n_stages - 1
    for t in range(n_ticks):
        # stage 0 takes microbatch t; the others keep what the last tick
        # sent them (the select keeps that tensor in stage 0's graph too)
        feed = x_mb[min(t, n_micro - 1)]
        act = torch.where(torch.tensor(stage == 0, device=act.device), feed, act)
        mb_ctx = [c[min(max(t - stage, 0), n_micro - 1)] for c in ctx]
        act = _stage_apply(block_fn, stage_params, act, *mb_ctx)
        # the microbatch leaving the last stage this tick entered at
        # t - (n_stages - 1); every stage keeps its own act there, masked
        # below, so that every act stays in every rank's graph
        done = t - (n_stages - 1)
        if 0 <= done < n_micro:
            outs[done] = act
        if t < n_ticks - 1:
            (act,) = _comm.ppermute((act,), group)
    out = torch.stack(outs)
    out = torch.where(torch.tensor(last, device=out.device), out, torch.zeros_like(out))
    return _comm.all_reduce(out, group)


def pipelined_stack(block_fn, per_block_params, group, x, *ctx, n_micro=None):
    """Run ``x`` (batch first) through the ``depth`` blocks of
    ``per_block_params`` cut into one stage per rank of ``group``, in
    ``n_micro`` microbatches (default: the number of stages). Each rank
    keeps only its stage's slice of the stacked parameters. Returns the
    outputs, of ``x``'s shape, on every rank."""
    n_stages = _comm.size(group)
    n_micro = n_micro or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    stage_params = _tree_map(lambda a: a[_comm.index(group)],
                             stack_stage_params(per_block_params, n_stages))

    def to_mb(a):
        return a.reshape(n_micro, b // n_micro, *a.shape[1:])

    out = spmd_pipeline(block_fn, stage_params, to_mb(x), *(to_mb(c) for c in ctx),
                        group=group)
    return out.reshape(b, *x.shape[1:])
