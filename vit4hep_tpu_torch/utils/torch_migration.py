"""Nets' weights from the reference's own torch checkpoints (port of
``vit4hep_tpu/utils/torch_migration.py``).

The reference saves ``torch.save({"model": state_dict, "optimizer",
"scheduler", "ema"})``; its model keys are ``net.<param>``, with
``module.`` prefixes from DDP. The port's nets already carry the
reference's parameter names, so migrating is key handling:

- the prefixes are stripped (:func:`strip_state_dict_prefixes`);
- the reference's buffers (``pos_z``/``pos_y``/``pos_x``, ``pos_embed``,
  ``attn_mask``; ``grid`` is a ViT1D's), functions of the config, are held
  against the ones the port computes from the same config and dropped;
  one that disagrees, or that the port's net has no counterpart of,
  raises;
- a fine-tuned reference ViT wraps its embedders in Sequentials
  (``x_embedder.0`` the mapper, ``x_embedder.2`` the backbone's;
  ``c_embedder.0`` and ``c_embedder.2.{0,2}``): they become ``x_mapper`` /
  ``c_mapper`` and the plain embedders;
- the energy net's frozen Fourier weights ``time_embed.0.W`` become the
  config's ``fourier_w`` (the port derives them from the config and does
  not store them), and the ``layer.*`` alias of ``layers.0`` is dropped
  once it is seen to equal it.

A cINN's checkpoint is a FrEIA ``GraphINN``: one ``module_list.{i}``
entry per graph node, [coupling, permute] x nblocks, the permutations
told apart by their ``perm`` leaf (:func:`convert_cinn_state_dict`). The
couplings' subnets (ViT1Ds, or the energy cINN's MLPs) become the flow's
``blocks.{2k}.subnet{1,2}``; the permutations go into the config
(``permutations``), from which the port builds the flow. The EMA section
(torch_ema's ``shadow_params``, in the order of the reference model's
trainable parameters) converts through the same converters
(:func:`convert_ema_state_dict`).

Whatever is left must load into the net with ``strict=True``. A port
checkpoint (``utils/checkpoint``, with its ``step``) loads as it is:
:func:`load_net_state_dict` reads either.
"""

from __future__ import annotations

import numpy as np
import torch

from vit4hep_tpu_torch.ops import pos_embed as pe_ops

BUFFER_KEYS = ("pos_z", "pos_y", "pos_x", "grid", "pos_embed", "attn_mask")


def strip_state_dict_prefixes(sd, prefixes=("module.", "net.")):
    """``sd`` with the wrapper prefixes stripped from every key, stacked in
    any order (a DDP-saved model gives ``net.module.<param>``)."""
    out = {}
    for k, v in sd.items():
        stripped = True
        while stripped:
            stripped = False
            for p in prefixes:
                if k.startswith(p):
                    k, stripped = k[len(p):], True
        out[k] = v
    return out


def is_reference_checkpoint(payload) -> bool:
    """A reference checkpoint has a ``model`` section and none of the port's
    counters."""
    return isinstance(payload, dict) and "model" in payload and "step" not in payload


def load_torch_checkpoint(path, section="model"):
    """The prefix-stripped state dict of ``section`` of a reference
    ``model_run<i>.pt``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload[section] if isinstance(payload, dict) and section in payload else payload
    if not isinstance(sd, dict):
        raise ValueError(f"Section '{section}' of {path} is not a state dict")
    return strip_state_dict_prefixes(sd)


def net_kind_from_target(target: str) -> str:
    """``energy`` or ``vit`` for a ``net._target_`` (the shared configs', the
    port's or the reference's path). A ViT1D is a cINN's subnet: a cINN's
    checkpoint converts as a whole (:func:`model_kind`)."""
    if "transformer_cfm" in target or "ParallelTransformer" in target \
            or "MLPTransformer" in target:
        return "energy"
    if target.rsplit(".", 1)[-1] in ("ViT", "ViT2"):
        return "vit"
    raise ValueError(f"No torch-checkpoint converter for net target '{target}' "
                     "(supported: ViT, ParallelTransformer)")


def model_kind(model_cfg) -> str:
    """``cinn`` for a cINN's model config (its flow converts as a whole),
    else the kind of its net (:func:`net_kind_from_target`)."""
    if "CINN" in str(model_cfg.get("_target_", "")) or "CaloChallengeEnergy" in \
            str(model_cfg.get("_target_", "")):
        return "cinn"
    return net_kind_from_target(str(model_cfg.net._target_))


def expected_buffers(param: dict) -> dict[str, np.ndarray]:
    """The buffers a reference ViT of this ``net.param`` registers, as the
    port computes them from the config."""
    from vit4hep_tpu_torch.models.vit import ViTParams

    p = ViTParams.create(param)
    out = {}
    if p.learn_pos_embed:
        out.update(zip(("pos_z", "pos_y", "pos_x"), pe_ops.create_meshgrid(p.num_patches)))
    else:
        out["pos_embed"] = pe_ops.get_sincos_pos_embed(
            p.pos_embedding_coords, p.num_patches[0], p.hidden_dim, p.dim, p.temperature)
    if p.causal_attn and p.dim == 3:
        out["attn_mask"] = pe_ops.layer_causal_mask(p.num_patches[0])
    return out


def _check_buffer(key, ref, want):
    ref = ref.detach().cpu()
    if want is None:
        raise ValueError(f"reference buffer {key} has no counterpart in the port's net of this "
                         "config")
    if ref.numel() != want.size:
        raise ValueError(f"reference buffer {key} has {ref.numel()} entries, the port's "
                         f"{want.size}")
    if want.dtype == bool:
        same = np.array_equal(ref.reshape(-1).numpy() != 0, want.reshape(-1))
    else:
        same = np.allclose(ref.reshape(-1).double().numpy(), want.reshape(-1), rtol=0,
                           atol=1e-6)
    if not same:
        raise ValueError(f"reference buffer {key} differs from the one the port computes from "
                         "the config")


def _renamed(sd, old, new):
    return {new + k[len(old):] if k.startswith(old) else k: v for k, v in sd.items()}


def convert_vit_state_dict(sd, param: dict) -> dict:
    """A prefix-stripped reference ViT state dict -> the port's net state
    dict for ``net.param`` (buffers checked and dropped, fine-tuned
    embedders renamed)."""
    sd = dict(sd)
    want = expected_buffers(param)
    for k in [k for k in sd if k.split(".")[-1] in BUFFER_KEYS]:
        _check_buffer(k, sd.pop(k), want.get(k.split(".")[-1]))
    # a fine-tuned net: Sequential(mapper, SiLU, the backbone's embedder)
    if "x_embedder.0.weight" in sd:
        sd = _renamed(_renamed(sd, "x_embedder.0.", "x_mapper."), "x_embedder.2.", "x_embedder.")
    if "c_embedder.2.0.weight" in sd:
        sd = _renamed(_renamed(sd, "c_embedder.0.", "c_mapper."), "c_embedder.2.", "c_embedder.")
    return sd


def convert_energy_state_dict(sd) -> tuple[dict, dict]:
    """A prefix-stripped reference ``ParallelTransformer`` state dict ->
    (the port's net state dict, ``{"fourier_w": [...]}`` to merge into the
    net's ``param`` before it is built)."""
    sd = dict(sd)
    patch = {"fourier_w": sd.pop("time_embed.0.W").detach().cpu().float().reshape(-1).tolist()}
    for k in [k for k in sd if k.startswith("layer.")]:
        alias = "layers.0." + k[len("layer."):]
        if alias not in sd or not torch.equal(sd[k], sd[alias]):
            raise ValueError(f"reference entry {k} is not the alias of {alias}")
        del sd[k]
    return sd, patch


# non-trainable leaves of a FrEIA GraphINN checkpoint: the permutations'
# indices and the binned spline's buffers
CINN_BUFFER_LEAVES = ("perm", "perm_inv", "bins", "min_bin_sizes", "default_domain",
                      "identity_tails", "default_width")
# where each reference coupling block keeps its subnets: (the port's name,
# the reference's key prefix)
CINN_SUBNET_PREFIXES = {
    "CaloRQSplineFrEIA": (("subnet1", "subnet1.vit."), ("subnet2", "subnet2.vit.")),
    "CaloRQSplineNFlows": (("subnet1", "_spline1.subnet.vit."),
                           ("subnet2", "_spline2.subnet.vit.")),
    "OneSidedCaloRQSplineNFlows": (("subnet1", "_spline.subnet.vit."),),
    "RQSplineNFlows": (("subnet1", "_spline1.subnet.mlp."), ("subnet2", "_spline2.subnet.mlp.")),
}


def _convert_vit1d(sd) -> dict:
    """A reference ViT1D subnet's state dict -> the port's: the time
    embedder it inherits and never calls is dropped (the port's ViT1D has
    none); its ``grid`` buffer must be arange(T) / T, which the port
    computes; its other buffers are the config's and are dropped."""
    out = {}
    for k, v in sd.items():
        leaf = k.split(".")[-1]
        if k.startswith("t_embedder."):
            continue
        if leaf == "grid":
            n = v.numel()
            _check_buffer(k, v, np.arange(n, dtype=np.float32) / np.float32(n))
            continue
        if leaf in BUFFER_KEYS:
            continue
        out[k] = v
    return out


def _convert_mlp(sd) -> dict:
    """A reference ``SubnetMLP``'s ``nn.Sequential`` (Linears at sequence
    indices between activations) -> the port's ``layers.{j}``, the j-th
    Linear."""
    idx = sorted({int(k.split(".")[0]) for k in sd})
    return {f"layers.{j}.{k.split('.', 1)[1]}": v
            for j, i in enumerate(idx) for k, v in sd.items() if k.split(".")[0] == str(i)}


def _convert_cinn_coupling(group, coupling_block) -> dict:
    if coupling_block not in CINN_SUBNET_PREFIXES:
        raise ValueError(f"no cINN checkpoint converter for coupling block '{coupling_block}'")
    out, seen = {}, set()
    for ours, theirs in CINN_SUBNET_PREFIXES[coupling_block]:
        sub = {k[len(theirs):]: v for k, v in group.items() if k.startswith(theirs)}
        seen.update(theirs + k for k in sub)
        sub = _convert_mlp(sub) if coupling_block == "RQSplineNFlows" else _convert_vit1d(sub)
        out.update({f"{ours}.{k}": v for k, v in sub.items()})
    stray = [k for k in group if k not in seen and k.split(".")[-1] not in CINN_BUFFER_LEAVES]
    if stray:
        raise ValueError(f"reference {coupling_block} entries with no port counterpart: "
                         f"{stray[:5]}")
    return out


def convert_cinn_state_dict(model_sd, coupling_block) -> tuple[dict, list]:
    """A prefix-stripped FrEIA ``GraphINN`` state dict -> (the port's flow
    state dict, the permutations as index lists, one a block). The graph's
    ``module_list.{i}`` indices follow FrEIA's topological sort, so each
    module is told by its content (a ``perm`` leaf marks a permutation) and
    the couplings are taken in index order: the graph is [coupling,
    permute] x nblocks, the couplings the flow's ``blocks.{2k}``."""
    import re

    groups: dict = {}
    for k, v in model_sd.items():
        m = re.match(r"module_list\.(\d+)\.(.+)", k)
        if not m:
            raise ValueError(f"unexpected non-GraphINN key '{k}' in a cINN checkpoint")
        groups.setdefault(int(m.group(1)), {})[m.group(2)] = v
    permutations, couplings = [], []
    for idx in sorted(groups):
        g = groups[idx]
        if "perm" in g:
            permutations.append([int(x) for x in g["perm"].reshape(-1).tolist()])
        else:
            couplings.append(g)
    if len(couplings) != len(permutations):
        raise ValueError(f"cINN checkpoint has {len(couplings)} coupling blocks but "
                         f"{len(permutations)} permutations: not a [coupling, permute] graph")
    sd = {}
    for k, g in enumerate(couplings):
        sd.update({f"blocks.{2 * k}.{key}": v
                   for key, v in _convert_cinn_coupling(g, coupling_block).items()})
    return sd, permutations


def trainable_param_names(model_sd, kind) -> list[str]:
    """The names of the reference model's trainable parameters in
    ``model.parameters()`` order (the order of torch_ema's shadows), from
    its state dict: registration order, without buffers, the cINN's
    permutation and spline leaves, the energy net's frozen Fourier weights
    and the ``layers.0`` alias of its ``layer``."""
    names = []
    for k in model_sd:
        leaf = k.split(".")[-1]
        if leaf in BUFFER_KEYS:
            continue
        if kind == "cinn" and leaf in CINN_BUFFER_LEAVES:
            continue
        if kind == "energy" and (k == "time_embed.0.W" or k.startswith("layers.0.")):
            continue
        names.append(k)
    return names


def convert_ema_state_dict(ema_sd, model_sd, kind, coupling_block=None, param=None) -> dict:
    """torch_ema's state (``shadow_params`` over the trainable parameters)
    -> the port's net (flow) state dict of the shadows: each shadow paired
    with its parameter's name (:func:`trainable_param_names` of the
    prefix-stripped model state dict of the same checkpoint), then the
    model's own converter. ``kind``: ``vit``, ``energy`` or ``cinn`` (with
    ``coupling_block``); ``param`` is a ViT's ``net.param``."""
    shadows = ema_sd["shadow_params"]
    names = trainable_param_names(model_sd, kind)
    if len(names) != len(shadows):
        raise ValueError(f"EMA shadow count {len(shadows)} != trainable-parameter count "
                         f"{len(names)}: unknown architecture variant?")
    shadow_sd = {}
    for name, tensor in zip(names, shadows):
        if tuple(tensor.shape) != tuple(model_sd[name].shape):
            raise ValueError(f"EMA shadow shape mismatch at {name}")
        shadow_sd[name] = tensor
    if kind == "cinn":
        # the permutations are structural, never averaged
        shadow_sd.update({k: v for k, v in model_sd.items()
                          if k.split(".")[-1] in ("perm", "perm_inv")})
        return convert_cinn_state_dict(shadow_sd, coupling_block)[0]
    if kind == "energy":
        # the head's first Linear is registered as `layer`: the converter
        # reads it under its `layers.0` name
        for suffix in ("weight", "bias"):
            shadow_sd[f"layers.0.{suffix}"] = shadow_sd.pop(f"layer.{suffix}")
        shadow_sd["time_embed.0.W"] = model_sd["time_embed.0.W"]
        return convert_energy_state_dict(shadow_sd)[0]
    return convert_vit_state_dict(shadow_sd, param)


def _net_param(model_cfg) -> dict:
    param = model_cfg.net.param
    return param.to_container(resolve=True) if hasattr(param, "to_container") else dict(param)


def convert_reference_checkpoint(model_cfg, payload) -> tuple[dict, dict | None]:
    """(the net state dict, the EMA's net state dict or None) of a reference
    checkpoint's payload for the model of ``model_cfg``. What the port
    builds from the config and the reference stores as weights is written
    into ``model_cfg``: an energy net's ``fourier_w`` (``net.param``), a
    cINN's ``permutations``. Call it before building the model."""
    sd = strip_state_dict_prefixes(payload["model"])
    kind = model_kind(model_cfg)
    coupling = str(model_cfg.coupling_block) if kind == "cinn" else None
    if kind == "cinn":
        net_sd, model_cfg.permutations = convert_cinn_state_dict(sd, coupling)
    elif kind == "energy":
        net_sd, patch = convert_energy_state_dict(sd)
        for k, v in patch.items():
            model_cfg.net.param[k] = v
    else:
        net_sd = convert_vit_state_dict(sd, _net_param(model_cfg))
    ema = payload.get("ema")
    ema_sd = None if ema is None else convert_ema_state_dict(
        ema, sd, kind, coupling, None if kind != "vit" else _net_param(model_cfg))
    return net_sd, ema_sd


def convert_net_checkpoint(model_cfg, payload):
    """The net state dict of a reference checkpoint's payload for the model
    of ``model_cfg`` (:func:`convert_reference_checkpoint`'s model part: an
    energy net's ``fourier_w`` and a cINN's ``permutations`` go into
    ``model_cfg``; call it before building the model), or None for a port
    checkpoint."""
    if not is_reference_checkpoint(payload):
        return None
    return convert_reference_checkpoint(model_cfg, dict(payload, ema=None))[0]


def load_net_state_dict(model_cfg, path) -> tuple[dict, bool]:
    """(the state dict of the model's net, whether it was migrated) from a
    ``model_run<i>.pt``: the reference's, converted, or the port's own."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    converted = convert_net_checkpoint(model_cfg, payload)
    if converted is not None:
        return converted, True
    model = payload["model"]
    stray = [k for k in model if not k.startswith("net.")]
    if stray:
        raise ValueError(f"{path}: entries outside the net: {stray[:5]}")
    return {k[len("net."):]: v for k, v in model.items()}, False
