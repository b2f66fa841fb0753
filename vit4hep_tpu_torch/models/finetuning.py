"""Cross-dataset fine-tuning: the fine-tune net's config, the backbone
transfer with its embedder surgery, and the three parameter groups (port of
``vit4hep_tpu/models/finetuning.py``).

- :func:`build_ft_vit_params` merges the backbone's architecture with the
  target dataset's geometry: ``num_patches`` and the FinalLayer's width from
  the target, and per embedder a mapper in front of the backbone's
  (``map_*_embedding``), or the target's input width (``reinitialize_*`` or
  ``interpolate``), or the backbone's as it is.
- :func:`transfer_backbone_params` copies the backbone's weights into the
  fine-tune net's ``state_dict`` with JAX's precedence: a reinitialised
  embedder wins over ``interpolate``; with a mapper the backbone's embedder
  is kept; ``t_embedder`` and the blocks always transfer;
  ``pos_embed_freqs`` and ``final_layer`` unless reinitialised.
  Interpolation is the reference's ``F.interpolate(mode="linear",
  align_corners=False)`` along the kernel's input axis. JAX's
  ``jax.image.resize`` antialiases when it shrinks that axis (ROADMAP.md,
  queue 3, fault 5 of the JAX package); the port does not.
- :func:`param_group_labels` and :func:`ft_param_groups` put each
  parameter in the backbone, head or embedder group by its top-level
  module, for the three-group optimizer of ``experiments/train_state``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit4hep_tpu_torch.models.vit import ViTParams
from vit4hep_tpu_torch.utils.logger import LOGGER

EMBEDDER_MODULES = ("x_embedder", "x_mapper", "c_embedder", "c_mapper", "pos_embed_freqs")
HEAD_MODULES = ("final_layer",)
GROUPS = ("backbone", "head", "embedder")


def build_ft_vit_params(backbone_param: dict, target_param: dict, ft_cfg) -> ViTParams:
    """ViTParams of the fine-tune net: the backbone's architecture, the
    target's geometry."""
    merged = dict(backbone_param)
    merged["num_patches"] = target_param["num_patches"]
    merged["out_patch_dim"] = int(target_param["patch_dim"])
    interpolate = ft_cfg.get("interpolate", False)
    if ft_cfg.get("map_x_embedding", False):
        # target patch_dim -> x_mapper -> the backbone's patch_dim -> x_embedder
        merged["in_patch_dim"] = int(target_param["patch_dim"])
    elif ft_cfg.get("reinitialize_x_embedding", False) or interpolate:
        merged["patch_dim"] = int(target_param["patch_dim"])
    if ft_cfg.get("map_c_embedding", False):
        merged["in_condition_dim"] = int(target_param["condition_dim"])
    elif ft_cfg.get("reinitialize_c_embedding", False) or interpolate:
        merged["condition_dim"] = int(target_param["condition_dim"])
    return ViTParams.create(merged)


def interpolate_in(weight: torch.Tensor, new_in: int) -> torch.Tensor:
    """A Linear weight (out, in) linearly resampled to (out, new_in) along
    its input axis, as the reference's ``F.interpolate`` on the weight."""
    return F.interpolate(weight[None], size=int(new_in), mode="linear",
                         align_corners=False)[0]


def _transfer_embedder(name, ft_sd, bb, mapped, reinit, interpolate, out):
    """One embedder's backbone entries ``bb`` (key -> tensor) into ``out``."""
    if mapped:
        out.update(bb)  # the mapper feeds the backbone's embedder
    elif reinit:
        # reinitialising wins over interpolate: the reference interpolates
        # the fresh layer, whose input is already the target's width
        LOGGER.info(f"FT: {name} reinitialized")
    elif interpolate:
        # the first product (x_embedder, c_embedder.0) is resampled
        first = f"{name}.weight" if f"{name}.weight" in bb else f"{name}.0.weight"
        for key, value in bb.items():
            out[key] = interpolate_in(value, ft_sd[key].shape[1]) if key == first else value
        LOGGER.info(f"FT: {first} interpolated to input dim {ft_sd[first].shape[1]}")
    else:
        out.update(bb)


def transfer_backbone_params(ft_sd: dict, backbone_sd: dict, ft_cfg) -> dict:
    """The fine-tune net's state dict with the backbone's weights copied in
    (see the module docstring). Both are the nets' own state dicts (keys
    ``x_embedder.weight``, ``blocks.0.attn.qkv.weight``, ...); entries are
    cloned, so a copied tensor equals the backbone's bit for bit."""
    out = dict(ft_sd)
    by_top: dict[str, dict] = {}
    for key, value in backbone_sd.items():
        by_top.setdefault(key.split(".")[0], {})[key] = value.detach().clone()
    for top, bb in by_top.items():
        if top in ("x_embedder", "c_embedder"):
            axis = top[0]
            _transfer_embedder(top, ft_sd, bb, ft_cfg.get(f"map_{axis}_embedding", False),
                               ft_cfg.get(f"reinitialize_{axis}_embedding", False),
                               ft_cfg.get("interpolate", False), out)
        elif top == "pos_embed_freqs":
            if not ft_cfg.get("reinitialize_pos_embedding", False):
                out.update(bb)
        elif top == "final_layer":
            if not ft_cfg.get("reinitialize_final_layer", False):
                out.update(bb)
        else:  # t_embedder, the blocks: always transferred
            out.update({k: v for k, v in bb.items() if k in ft_sd})
    for key, value in out.items():
        if value.shape != ft_sd[key].shape:
            raise ValueError(f"backbone {key} {tuple(value.shape)} does not fit the fine-tune "
                             f"net's {tuple(ft_sd[key].shape)}")
    return out


def label_of(name: str) -> str:
    """The group of a parameter of the net, by its top-level module."""
    top = name.split(".")[0]
    if top in EMBEDDER_MODULES:
        return "embedder"
    if top in HEAD_MODULES:
        return "head"
    return "backbone"


def param_group_labels(net) -> dict:
    """Parameter name -> backbone / head / embedder."""
    return {name: label_of(name) for name, _ in net.named_parameters()}


def ft_param_groups(net, training_cfg, ft_cfg) -> list[tuple[list, float]]:
    """``[(params, lr)]`` of the backbone, head and embedder groups, each at
    ``ft_cfg``'s ``<group>_lr`` (``training.lr`` where it names none), for
    ``train_state.create_train_state``; each group keeps its own schedule
    from its own lr, as JAX's ``make_ft_optimizer`` does through
    ``optax.multi_transform``."""
    members = {g: [] for g in GROUPS}
    for name, p in net.named_parameters():
        if p.requires_grad:
            members[label_of(name)].append(p)
    return [(members[g], float(ft_cfg.get(f"{g}_lr", training_cfg.lr))) for g in GROUPS]
