"""Megatron tensor parallelism over the grid's model axis (port of
``vit4hep_tpu/parallel/sharding_rules.py``).

The rules are JAX's, on the port's parameter names: the qkv and MLP
up-projections of each transformer block (``attn.qkv``, ``mlp.fc1``, JAX's
``Attention_0/Dense_0`` and ``MlpBlock_0/Dense_0``) are column-parallel,
with their biases; the attention's out-projection and the MLP's
down-projection (``attn.proj``, ``mlp.fc2``; ``Dense_1``) are
row-parallel; everything else is replicated. A port ``Linear`` weight is
JAX's kernel transposed, so a column-parallel weight splits its rows:
:func:`spec_for_path` gives the axis name per dimension of the port's
tensor, ``()`` when it is replicated.

JAX places the leaves and lets XLA's partitioner insert the collectives.
Here :func:`shard_tree` keeps each rank's part of the weights in the
parameters themselves (the train state's optimizer moments and EMA alike)
and marks the block, whose forward then runs Megatron's pair of
collectives (``models/vit.py``). The qkv projection splits by heads: each
rank keeps its heads' rows of q, k and v in the ``[q/k/v, head, dim]``
layout, where a contiguous split of its 3 H D rows would not be
head-aligned. A block whose head count (attention) or hidden width (MLP)
the model axis does not divide stays replicated, as JAX leaves such leaves
(``:64-77``). A kernel path that needs a whole weight gathers it
(:func:`full`: every rank of the group computes the same product, and the
gradient of its part is the slice).
"""

from __future__ import annotations

import dataclasses

import torch

from vit4hep_tpu_torch.parallel import _comm
from vit4hep_tpu_torch.parallel.mesh import MODEL_AXIS

# (module, linear) path suffixes of the tensor-parallel products
_COLUMN = (("attn", "qkv"), ("mlp", "fc1"))
_ROW = (("attn", "proj"), ("mlp", "fc2"))


def spec_for_path(path) -> tuple:
    """The axis name per dimension of the parameter at ``path`` (a dotted
    name or a tuple of names; ``()``: replicated)."""
    names = tuple(path.split(".")) if isinstance(path, str) else tuple(path)
    if len(names) < 3:
        return ()
    mod_lin, leaf = tuple(names[-3:-1]), names[-1]
    if leaf == "weight":
        if mod_lin in _COLUMN:
            return (MODEL_AXIS, None)
        if mod_lin in _ROW:
            return (None, MODEL_AXIS)
    if leaf == "bias" and mod_lin in _COLUMN:
        return (MODEL_AXIS,)
    return ()


@dataclasses.dataclass(eq=False)
class Shard:
    """A parameter split over ``group`` along ``dim``: each of its
    ``blocks`` equal blocks along ``dim`` (q, k and v for the qkv
    projection) is cut into one contiguous part per rank."""

    group: object
    dim: int
    blocks: int = 1

    def split(self, full):
        """This rank's part of the whole tensor ``full``."""
        n, r = _comm.size(self.group), _comm.index(self.group)
        return torch.cat([b.chunk(n, self.dim)[r] for b in full.chunk(self.blocks, self.dim)],
                         self.dim).contiguous()

    def join(self, parts):
        """The whole tensor from every rank's part, in rank order."""
        pieces = [p.chunk(self.blocks, self.dim) for p in parts]
        return torch.cat([torch.cat([p[b] for p in pieces], self.dim)
                          for b in range(self.blocks)], self.dim)

    def gather(self, local):
        """The whole tensor from this rank's part (a collective; no
        gradient)."""
        return self.join(_comm.gather_list(local, self.group))


class _Full(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, shard):
        ctx.shard = shard
        return shard.gather(local)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.split(g), None


def full(p):
    """The whole parameter ``p`` (``p`` itself when it is not split); the
    gradient of this rank's part is its slice of the whole one's."""
    shard = getattr(p, "tp_shard", None)
    return p if shard is None else _Full.apply(p, shard)


def _tp_blocks(model, n):
    """``(block, {param name: (param, shard dim, blocks)})`` of every
    attention and MLP the model axis of ``n`` divides."""
    from vit4hep_tpu_torch.models.vit import Attention, MlpBlock

    names = {id(p): name for name, p in model.named_parameters()}
    for mod in model.modules():
        if isinstance(mod, Attention):
            ok, blocks = mod.num_heads % n == 0, {"qkv": 3}
        elif isinstance(mod, MlpBlock):
            ok, blocks = mod.fc1.out_features % n == 0, {}
        else:
            continue
        if not ok:
            continue
        params = {}
        for local_name, p in mod.named_parameters():
            spec = spec_for_path(names[id(p)])
            if spec:
                params[names[id(p)]] = (p, spec.index(MODEL_AXIS),
                                        blocks.get(local_name.split(".")[0], 1))
        yield mod, params


def _optimizer_states(state):
    """``{id(param): its optimizer state dict}`` of a train state."""
    opt = getattr(state, "optimizer", None)
    return {} if opt is None else {id(p): opt.state[p] for p in opt.state}


def _move(state, p, fn):
    """Apply ``fn`` to ``p``'s data and to each optimizer moment and EMA
    entry of ``p``'s shape."""
    st = _optimizer_states(state).get(id(p), {})
    for k, v in st.items():
        if torch.is_tensor(v) and v.shape == p.shape:
            st[k] = fn(v)
    ema = getattr(state, "ema", None)
    if ema is not None:
        for i, q in enumerate(state.params):
            if q is p:
                ema[i] = fn(ema[i])
    p.data = fn(p.data)


def shard_tree(state, mesh):
    """Split the tensor-parallel products of a train state (or a module)
    over ``mesh``'s model axis, in place: parameters, optimizer moments and
    EMA. Returns ``state``."""
    group, n = mesh.model_group, mesh.model
    model = getattr(state, "model", state)
    if n == 1:
        return state
    with torch.no_grad():
        for mod, params in _tp_blocks(model, n):
            if any(getattr(m, "dt", torch.float32) != torch.float32 for m in mod.modules()):
                raise NotImplementedError(
                    "tensor parallelism of a net with compute_dtype bfloat16 is not ported yet "
                    "(ROADMAP.md, queue 1: the dtypes): its row-parallel products sum f32 partials")
            for p, dim, blocks in params.values():
                shard = Shard(group, dim, blocks)
                _move(state, p, shard.split)
                p.tp_shard = shard
            mod.tp_group = group
    return state


def sharded_params(model) -> dict:
    """``{name: param}`` of the split parameters."""
    return {n: p for n, p in model.named_parameters() if getattr(p, "tp_shard", None)}


def unshard_state(state):
    """Undo :func:`shard_tree` (a collective): every tensor whole again and
    every block replicated."""
    model = getattr(state, "model", state)
    with torch.no_grad():
        for p in sharded_params(model).values():
            _move(state, p, p.tp_shard.gather)
            del p.tp_shard
        for mod in model.modules():
            if getattr(mod, "tp_group", None) is not None:
                mod.tp_group = None
    return state


def _walk_state_dict(state, sd, fn):
    """``sd`` (a train state's ``state_dict()``) with ``fn(shard, tensor)``
    applied to each split parameter's entries: the model's, the optimizer's
    moments and the EMA (``sd`` itself is changed)."""
    sharded = sharded_params(state.model)
    if not sharded:
        return sd
    for name, p in sharded.items():
        sd["model"][name] = fn(p.tp_shard, sd["model"][name])
    i = 0
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            shard = getattr(p, "tp_shard", None)
            entry = sd["optimizer"]["state"].get(i)
            if shard is not None and entry is not None:
                # the optimizer's state_dict() holds the live state's dicts
                entry = sd["optimizer"]["state"][i] = dict(entry)
                for k, v in entry.items():  # the moments; "step" is a scalar
                    if torch.is_tensor(v) and v.dim() > 0:
                        entry[k] = fn(shard, v)
            i += 1
    if sd.get("ema") is not None:
        sd["ema"] = [e if getattr(p, "tp_shard", None) is None else fn(p.tp_shard, e)
                     for p, e in zip(state.params, sd["ema"])]
    return sd


def gather_state_dict(state) -> dict:
    """``state.state_dict()`` with every split tensor whole (a collective
    over the model group)."""
    return _walk_state_dict(state, state.state_dict(), lambda s, t: s.gather(t.contiguous()))


def split_state_dict(state, sd) -> dict:
    """A whole checkpoint's ``sd`` cut to this rank's parts of ``state``'s
    split parameters."""
    return _walk_state_dict(state, sd, lambda s, t: s.split(t))
